"""Published peaks of one NVIDIA H100 SXM (the data sheet, at its full
700 W; a card set below that runs slower, so every run reports the card's
power limit on its ``info`` line)."""

H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
}
