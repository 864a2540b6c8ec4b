"""AA-jitter generator (counterpart of the JAX package's ``ops/samplers.py``;
the shipped ``"random"`` sampler only)."""

from __future__ import annotations

import torch

from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import ray_uniforms

SAMPLERS = ("random",)


def aa_jitter(key, ray_ids: torch.Tensor, spp: int,
              sampler: str = "random") -> torch.Tensor:
    """(N, 2) per-ray jitter in [0, 1)^2, a pure function of (key, ray id)."""
    if sampler == "random" or spp <= 1:
        return ray_uniforms(key, ray_ids, 2)
    raise NotImplementedError(
        f"sampler {sampler!r} is not ported (only 'random')"
    )
