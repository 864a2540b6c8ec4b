"""Film: the padded accumulation canvas, foveated block reconstruction and
compositing (counterpart of the JAX package's ``render/film.py``).

The canvas is padded by the largest pass extent so every gaze-centered pass
region lands inside it. Unlike the functional JAX version, ``composite_pass``
writes its region into the canvas in place.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fovpathtracing_optixcodelatest_tpu_torch.config import (
    FoveationPass,
    FoveationSchedule,
    RenderConfig,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import tonemap
from fovpathtracing_optixcodelatest_tpu_torch.render.raygen import pass_launch_dims


def schedule_padding(schedule: FoveationSchedule, width: int, height: int) -> int:
    """The largest pass extent in frame pixels."""
    pad = 0
    for p in schedule.passes:
        lw, lh = pass_launch_dims(p, width, height)
        pad = max(pad, lw * p.factor, lh * p.factor, p.center_offset)
    return pad


def new_canvas(width: int, height: int, pad: int, device="cuda") -> torch.Tensor:
    return torch.zeros((height + 2 * pad, width + 2 * pad, 3),
                       dtype=torch.float32, device=device)


def shade_to_accum_color(rad_sum, alpha_sum, backplate, spp: int,
                         launch: Tuple[int, int]):
    """color = backplate * spp * (1 - mean alpha) + sum radiance, over spp,
    as an (LH, LW, 3) image."""
    lw, lh = launch
    alpha_mean = alpha_sum / spp
    color = backplate * spp * (1.0 - alpha_mean) + rad_sum
    return (color / spp).reshape(lh, lw, 3)


def composite_pass(canvas, accum_color, ring, p: FoveationPass,
                   offset: Tuple[int, int], subframe: int, pad: int,
                   accumulate: bool) -> torch.Tensor:
    """Write one pass region into ``canvas`` (in place): factor x factor
    block replication, ring-masked merge and, for passes that accumulate,
    the progressive lerp against each pixel's history."""
    f = p.factor
    lh, lw = accum_color.shape[:2]
    sy, sx = pad + offset[1], pad + offset[0]
    if (sy < 0 or sx < 0 or sy + lh * f > canvas.shape[0]
            or sx + lw * f > canvas.shape[1]):
        raise ValueError("pass region leaves the padded canvas")
    new_rep = accum_color.repeat_interleave(f, 0).repeat_interleave(f, 1)
    ring_rep = ring.repeat_interleave(f, 0).repeat_interleave(f, 1)[..., None]
    prev = canvas[sy: sy + lh * f, sx: sx + lw * f]
    val = new_rep
    if accumulate and not p.redraw and subframe > 0:
        a = float(np.float32(1.0) / np.float32(subframe + 1.0))
        val = prev + (new_rep - prev) * a
    canvas[sy: sy + lh * f, sx: sx + lw * f] = torch.where(ring_rep, val, prev)
    return canvas


def finalize(canvas, pad: int, config: RenderConfig) -> torch.Tensor:
    """Crop the canvas and tone-map -> (H, W, 3) uint8."""
    h = canvas.shape[0] - 2 * pad
    w = canvas.shape[1] - 2 * pad
    return tonemap.postprocess(
        canvas[pad: pad + h, pad: pad + w],
        exposure_stops=config.exposure_stops,
        white=config.white,
        exposure_on=config.exposure_correction,
        tonemap_on=config.tone_mapping,
    )
