"""The render's random streams, as the port defines them: a threefry2x32
key chain on the host (``jax.random.PRNGKey`` and ``fold_in``) and, per ray,
two rounds of the lowbias32 mix keyed by the key's two words and the ray's
global id, one more mix per stream. Per-ray key words let one batch hold
rays of many frames."""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2_SIGNED = 0x846CA68B - (1 << 32)  # congruent mod 2**32, fits int64 products
_INV24 = 1.0 / (1 << 24)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0: int, x1: int):
    ks = [np.uint32(k0 & MASK), np.uint32(k1 & MASK),
          np.uint32((k0 ^ k1 ^ 0x1BD11BDA) & MASK)]
    with np.errstate(over="ignore"):
        x = [np.uint32(x0) + ks[0], np.uint32(x1) + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = np.uint32(x[0] + x[1])
                x[1] = np.uint32(((x[1] << np.uint32(r))
                                  | (x[1] >> np.uint32(32 - r))) ^ x[0])
            x[0] = np.uint32(x[0] + ks[(i + 1) % 3])
            x[1] = np.uint32(x[1] + ks[(i + 2) % 3] + np.uint32(i + 1))
    return int(x[0]), int(x[1])


def prng_key(seed: int) -> tuple:
    """``PRNGKey(seed)``: the words (0, seed mod 2**32)."""
    return (0, int(seed) & MASK)


def fold_in(key: tuple, data: int) -> tuple:
    """``fold_in(key, data)``: threefry of the counter (0, data) under key."""
    return _threefry2x32(key[0], key[1], 0, int(data) & MASK)


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * _M1) & MASK
    x = x ^ (x >> 15)
    x = (x * _M2_SIGNED) & MASK
    return x ^ (x >> 16)


def uniforms(s0: torch.Tensor, s1: torch.Tensor, ray_ids: torch.Tensor,
             num: int) -> torch.Tensor:
    """Per-ray key words ``s0``, ``s1`` (int64) and global ray ids ->
    (N, num) float32 uniforms in [0, 1)."""
    base = _mix((ray_ids & MASK) ^ s0)
    base = _mix(base ^ s1)
    cols = []
    for j in range(num):
        stream = (0x9E3779B9 * (j + 1)) & MASK
        h = _mix((base + stream) & MASK)
        cols.append((h >> 8).to(torch.float32) * _INV24)
    return torch.stack(cols, dim=-1)
