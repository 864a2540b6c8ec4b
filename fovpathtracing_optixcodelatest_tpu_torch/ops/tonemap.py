"""Post-processing chain: exposure -> Reinhard -> sRGB -> uint8 (counterpart
of the JAX package's ``ops/tonemap.py``)."""

from __future__ import annotations

import torch

from fovpathtracing_optixcodelatest_tpu_torch.ops.sampling import luminance_rec709


def exposure_correct(color, stops: float = 4.0):
    return color * (2.0 ** stops)


def reinhard(color, white: float = 1.0):
    """c / (1 + lum(c) / white) with Rec.709 luminance."""
    lum = luminance_rec709(color)
    return color / (1.0 + lum / white)[..., None]


def to_srgb(c):
    """Linear -> sRGB with the 0.0031308 toe."""
    c = torch.clamp(c, 0.0, 1.0)
    powed = torch.pow(torch.clamp(c, min=1e-10), 1.0 / 2.4)
    return torch.where(c < 0.0031308, 12.92 * c, 1.055 * powed - 0.055)


def quantize_u8(x):
    """min(uint(x * 256), 255)."""
    x = torch.clamp(x, 0.0, 1.0)
    return torch.clamp((x * 256.0).to(torch.int64), max=255).to(torch.uint8)


def make_color(c):
    return quantize_u8(to_srgb(torch.clamp(c, 0.0, 1.0)))


def postprocess(accum_color, exposure_stops: float = 4.0, white: float = 1.0,
                exposure_on: bool = True, tonemap_on: bool = True):
    """exposure (optional) -> Reinhard (optional) -> sRGB uint8."""
    c = exposure_correct(accum_color, exposure_stops) if exposure_on else accum_color
    c = reinhard(c, white) if tonemap_on else c
    return make_color(c)
