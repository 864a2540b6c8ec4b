"""Counter-based per-ray random streams, bit-exact with the JAX package.

Two parts:

- ``ray_uniform_cols``/``ray_uniforms``: two rounds of the lowbias32 mix
  keyed by the key's two words and the global ray id, one more mix per
  stream. torch has no usable uint32 arithmetic, so the words live in int64
  and every step masks back to 32 bits. The second multiplier is used in its
  signed 32-bit form (``M2 - 2**32``): congruent modulo 2**32, and the
  product of a 32-bit word with it stays inside int64.
- A numpy threefry2x32 (``prng_key``, ``fold_in``, ``key_words``) that
  reproduces ``jax.random.PRNGKey(seed)`` and ``jax.random.fold_in`` under
  JAX's default threefry implementation, so both packages derive the same
  key chain (frame -> jitter/path -> bounce); ``uniform`` reproduces
  ``jax.random.uniform``'s float32 draws under JAX's default partitionable
  threefry (counter i -> threefry of (0, i), the two words xor-ed).
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2_SIGNED = 0x846CA68B - (1 << 32)
_INV24 = 1.0 / (1 << 24)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 avalanche finalizer on 32-bit words held in int64."""
    x = x ^ (x >> 16)
    x = (x * _M1) & _MASK
    x = x ^ (x >> 15)
    x = (x * _M2_SIGNED) & _MASK
    x = x ^ (x >> 16)
    return x


def ray_uniform_cols(key, ray_ids: torch.Tensor, num: int):
    """(N,) int global ray ids -> list of ``num`` (N,) float32 uniforms in
    [0, 1). ``key`` is a (2,) uint32 key (see ``prng_key``)."""
    s0, s1 = key_words(key)
    ids = ray_ids.to(torch.int64) & _MASK
    base = _mix(ids ^ s0)
    base = _mix(base ^ s1)
    cols = []
    for j in range(num):
        stream = (0x9E3779B9 * (j + 1)) & _MASK
        h = _mix((base + stream) & _MASK)
        cols.append((h >> 8).to(torch.float32) * _INV24)
    return cols


def ray_uniforms(key, ray_ids: torch.Tensor, num: int) -> torch.Tensor:
    """(N,) ray ids -> (N, num) uniforms in [0, 1)."""
    return torch.stack(ray_uniform_cols(key, ray_ids, num), dim=-1)


# ---------------------------------------------------------------------------
# threefry2x32 key chain (numpy, host side)
# ---------------------------------------------------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """The 20-round threefry2x32 block function on arrays of uint32
    counter pairs (uint32 arithmetic wraps as the block function needs)."""
    ks = [np.uint32(k0 & _MASK), np.uint32(k1 & _MASK),
          np.uint32((k0 ^ k1 ^ 0x1BD11BDA) & _MASK)]
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = ((x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` key data for a non-negative 32-bit seed."""
    return np.asarray([0, seed & _MASK], dtype=np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: threefry of the counter pair
    (0, data) under ``key``."""
    k = np.asarray(key, dtype=np.uint32).reshape(-1)
    y0, y1 = threefry2x32(int(k[-2]), int(k[-1]), np.zeros(1, np.uint32),
                          np.full(1, int(data) & _MASK, np.uint32))
    return np.concatenate([y0, y1])


def key_words(key) -> tuple[int, int]:
    """The two 32-bit words the counter hash consumes (the key's last two)."""
    k = np.asarray(key, dtype=np.uint32).reshape(-1)
    return int(k[-2]), int(k[-1])


def uniform(key, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1) (numpy)."""
    n = int(np.prod(shape))
    k0, k1 = key_words(key)
    b0, b1 = threefry2x32(k0, k1, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return (bits.view(np.float32) - np.float32(1.0)).reshape(shape)
