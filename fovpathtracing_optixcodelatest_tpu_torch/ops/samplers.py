"""AA-jitter generators: random, stratified and blue noise (counterpart of
the JAX package's ``ops/samplers.py``).

Every mode is a pure function of (key, ray id, sample slot):

- ``random``: two counter-hash uniforms per ray (``ops/rng.py``);
- ``stratified``: the slot picks a cell of a ceil(sqrt(spp)) x rows grid,
  jittered inside the cell by the same two uniforms;
- ``blue_noise``: one best-candidate point set per spp (built on the host
  with a fixed seed, so both packages hold the same points), shifted
  toroidally per pixel by two uniforms keyed by the pixel's first ray id.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import ray_uniforms

SAMPLERS = ("random", "stratified", "blue_noise")


def _strata_dims(spp: int):
    nx = int(math.ceil(math.sqrt(spp)))
    ny = int(math.ceil(spp / nx))
    return nx, ny


def best_candidate_points(
    n: int, seed: int = 0, candidates_per_point: int = 32
) -> np.ndarray:
    """Best-candidate (Mitchell) blue-noise points in [0, 1)^2 under the
    toroidal metric. Returns (n, 2) float32."""
    rng = np.random.default_rng(seed)
    pts = np.empty((n, 2), np.float64)
    pts[0] = rng.random(2)
    for i in range(1, n):
        cand = rng.random((candidates_per_point * i, 2))
        d = np.abs(cand[:, None, :] - pts[None, :i, :])
        d = np.minimum(d, 1.0 - d)
        dist2 = (d * d).sum(-1).min(axis=1)
        pts[i] = cand[np.argmax(dist2)]
    return pts.astype(np.float32)


def projective_blue_noise_points(
    n: int, seed: int = 0, candidates_per_point: int = 32
) -> np.ndarray:
    """Projective blue noise: a candidate's score is the least of its 2-D
    distance and of each axis projection's, scaled to be commensurable, so
    the x and y projections are well spread too. Returns (n, 2) float32."""
    rng = np.random.default_rng(seed)
    pts = np.empty((n, 2), np.float64)
    pts[0] = rng.random(2)
    for i in range(1, n):
        cand = rng.random((candidates_per_point * i, 2))
        d = np.abs(cand[:, None, :] - pts[None, :i, :])
        d = np.minimum(d, 1.0 - d)
        d2 = (d * d).sum(-1)
        px = (d[:, :, 0] * i) ** 2
        py = (d[:, :, 1] * i) ** 2
        score = np.minimum(d2 * i, np.minimum(px, py)).min(axis=1)
        pts[i] = cand[np.argmax(score)]
    return pts.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _bn_table(spp: int) -> np.ndarray:
    return best_candidate_points(spp, seed=7)


def aa_jitter(key, ray_ids: torch.Tensor, slots: torch.Tensor, spp: int,
              sampler: str = "random") -> torch.Tensor:
    """(N, 2) per-ray jitter in [0, 1)^2. ``ray_ids`` are the global ray
    ids (``render/raygen.py``), ``slots`` each ray's sample slot in
    [0, spp)."""
    if sampler == "random" or spp <= 1:
        return ray_uniforms(key, ray_ids, 2)
    if sampler == "stratified":
        nx, ny = _strata_dims(spp)
        r = ray_uniforms(key, ray_ids, 2)
        sx = (slots % nx).to(torch.float32)
        sy = (slots // nx).to(torch.float32)
        u = (sx + r[:, 0]) * (1.0 / nx)
        v = (sy + r[:, 1]) * (1.0 / ny)
        return torch.stack([u, v], dim=-1)
    if sampler == "blue_noise":
        table = torch.tensor(_bn_table(spp), device=ray_ids.device)
        base = table[slots.to(torch.int64)]
        # one Cranley-Patterson shift per pixel, keyed by its slot-0 ray id
        shift = ray_uniforms(key, ray_ids - slots, 2)
        return torch.remainder(base + shift, 1.0)
    raise ValueError(f"unknown sampler {sampler!r}; one of {SAMPLERS}")
