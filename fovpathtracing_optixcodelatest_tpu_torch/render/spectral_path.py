"""Hero-wavelength spectral path tracing (counterpart of the JAX package's
``render/spectral_path.py``): the integrator's ``config.spectral`` mode
behind the older call that takes the dispersion as an argument.

Every path tracks ``NUM_HERO`` wavelengths (one hero, three rotations);
RGB BSDF and light values are lifted through the RGB basis, transmissive
materials refract with a Cauchy eta(lambda) whose first dispersive
transmission collapses the non-hero wavelengths, and each bounce's
spectral contribution is CIE-integrated to linear sRGB.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from fovpathtracing_optixcodelatest_tpu_torch.config import RenderConfig
from fovpathtracing_optixcodelatest_tpu_torch.render.integrator import trace_paths


def trace_paths_spectral(scene, origin: torch.Tensor, direction: torch.Tensor,
                         active: torch.Tensor, key, config: RenderConfig,
                         ray_ids: torch.Tensor | None = None,
                         dispersion: float = 4200.0) -> Dict[str, torch.Tensor]:
    """Trace N spectral paths -> dict(radiance (N, 3) linear sRGB, traces).
    ``dispersion`` is the Cauchy B coefficient in nm^2 of transmissive
    materials (0 = achromatic refraction)."""
    cfg = dataclasses.replace(config, spectral=True, dispersion=dispersion)
    out = trace_paths(scene, origin, direction, active, key, cfg,
                      ray_ids=ray_ids)
    return {"radiance": out["radiance"], "traces": out["traces"]}
