"""Camera ray generation for uniform and foveated passes (counterpart of the
JAX package's ``render/raygen.py``).

Pixel index = launch index * factor + offset; rays outside the pass's ring
around the gaze are generated but inactive. Ray ids are
``frame_pixel * RNG_STRIDE + sample_slot``, so every pass that shades a
pixel draws the same random streams; launch coordinates off the frame get a
reserved id band above the frame's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fovpathtracing_optixcodelatest_tpu_torch.config import FoveationPass
from fovpathtracing_optixcodelatest_tpu_torch.ops.samplers import aa_jitter
from fovpathtracing_optixcodelatest_tpu_torch.ops.sampling import normalize

RNG_STRIDE = 64  # max spp any schedule may use
OFF_BAND = 512  # reserved launch margin around the frame for ray ids


def pass_launch_dims(p: FoveationPass, width: int, height: int) -> Tuple[int, int]:
    """Launch grid (LW, LH) in strided coordinates."""
    lw = p.launch_w if p.launch_w is not None else width // p.factor
    lh = p.launch_h if p.launch_h is not None else height // p.factor
    return lw, lh


def pass_offset(p: FoveationPass, gaze_x: int, gaze_y: int) -> Tuple[int, int]:
    """Frame-space offset of the launch grid (may be negative)."""
    if p.centered:
        return int(gaze_x) - p.center_offset, int(gaze_y) - p.center_offset
    return 0, 0


def pass_ray_count(p: FoveationPass, width: int, height: int) -> int:
    lw, lh = pass_launch_dims(p, width, height)
    return lw * lh * p.spp


def pass_pixels(p: FoveationPass, width: int, height: int, gaze_x: int,
                gaze_y: int, device):
    """Frame pixel coordinates (idx_x, idx_y), each (LH, LW), of a pass's
    launch grid."""
    lw, lh = pass_launch_dims(p, width, height)
    ox, oy = pass_offset(p, gaze_x, gaze_y)
    gy, gx = torch.meshgrid(
        torch.arange(lh, device=device), torch.arange(lw, device=device),
        indexing="ij",
    )
    return gx * p.factor + ox, gy * p.factor + oy


def generate_pass_rays(camera, p: FoveationPass, width: int, height: int,
                       gaze_x: int, gaze_y: int, key, antialias: bool = True,
                       sample_ids=None, ray_id_base: int = 0,
                       sampler: str = "random"):
    """The ray batch of one foveation pass, pixel-major (ray = pixel * k +
    i, the i-th of the k sample slots made). ``sample_ids`` (k,) selects the
    slots (default all ``spp``): a multi-device render gives each rank a
    disjoint slice, and each ray is the one the full pass makes for that
    pixel and slot, since its id, jitter and stratum follow the slot. Slots
    >= spp (the padding of an uneven split) are made but inactive.
    ``ray_id_base`` is the JAX package's argument, which it does not use
    either: a ray's id follows its pixel and slot alone. Returns
    dict(origin, direction (N, 3), active (N,), ray_ids (N,) int64, ring
    (LH, LW), launch, offset, spp, samples_here = k)."""
    dev = camera.eye.device
    lw, lh = pass_launch_dims(p, width, height)
    ox, oy = pass_offset(p, gaze_x, gaze_y)
    spp = p.spp
    if spp > RNG_STRIDE:
        raise ValueError(f"spp {spp} exceeds RNG_STRIDE {RNG_STRIDE}")
    if sample_ids is None:
        sample_ids = torch.arange(spp, device=dev)
    sample_ids = torch.as_tensor(sample_ids, dtype=torch.int64, device=dev)
    k = sample_ids.numel()
    n_pix = lw * lh
    idx_x, idx_y = pass_pixels(p, width, height, gaze_x, gaze_y, dev)

    dx = idx_x.to(torch.float32) - float(gaze_x)
    dy = idx_y.to(torch.float32) - float(gaze_y)
    rng = torch.sqrt(dx * dx + dy * dy)
    ring = (rng >= p.r_inner) & (rng <= p.r_outer)

    virt_w = width + 2 * OFF_BAND
    id_limit = (width * height + (height + 2 * OFF_BAND) * virt_w) * RNG_STRIDE
    if id_limit >= 2 ** 31:
        raise ValueError(
            f"{width}x{height} at RNG_STRIDE {RNG_STRIDE} overflows int32 ray ids"
        )
    in_frame = (idx_x >= 0) & (idx_x < width) & (idx_y >= 0) & (idx_y < height)
    cx = torch.clamp(idx_x, -OFF_BAND, width + OFF_BAND - 1)
    cy = torch.clamp(idx_y, -OFF_BAND, height + OFF_BAND - 1)
    off_pix = width * height + (cy + OFF_BAND) * virt_w + (cx + OFF_BAND)
    frame_pix = torch.where(in_frame, idx_y * width + idx_x, off_pix).reshape(-1)
    slots = sample_ids.repeat(n_pix)
    ray_ids = torch.repeat_interleave(frame_pix, k) * RNG_STRIDE + slots

    if antialias:
        jitter = aa_jitter(key, ray_ids, slots, spp, sampler)
    else:
        jitter = torch.zeros((n_pix * k, 2), dtype=torch.float32, device=dev)
    fx = torch.repeat_interleave(idx_x.reshape(-1).to(torch.float32), k)
    fy = torch.repeat_interleave(idx_y.reshape(-1).to(torch.float32), k)
    ndc_x = 2.0 * (fx + jitter[:, 0]) / width - 1.0
    ndc_y = 2.0 * (fy + jitter[:, 1]) / height - 1.0
    direction = normalize(
        ndc_x[:, None] * camera.u[None, :]
        + ndc_y[:, None] * camera.v[None, :]
        + camera.w[None, :]
    )
    origin = camera.eye[None, :].expand_as(direction)
    return {
        "origin": origin,
        "direction": direction,
        "active": torch.repeat_interleave(ring.reshape(-1), k) & (slots < spp),
        "ray_ids": ray_ids,
        "ring": ring,
        "launch": (lw, lh),
        "offset": (ox, oy),
        "spp": spp,
        "samples_here": k,
    }


def pixel_center_directions(camera, idx_x, idx_y, width: int, height: int):
    """Unjittered pixel-center primary directions (the backplate lookup)."""
    ndc_x = 2.0 * (idx_x.to(torch.float32) + 0.5) / width - 1.0
    ndc_y = 2.0 * (idx_y.to(torch.float32) + 0.5) / height - 1.0
    return normalize(
        ndc_x.reshape(-1)[:, None] * camera.u[None, :]
        + ndc_y.reshape(-1)[:, None] * camera.v[None, :]
        + camera.w[None, :]
    )
