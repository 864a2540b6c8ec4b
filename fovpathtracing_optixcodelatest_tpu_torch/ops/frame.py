"""The frame's ray generation and film on the card: the wrappers of
``csrc/frame.cu``.

``generate_rays`` launches ``raygen_kernel`` once for a frame's wavefront:
every pass's rays at their offsets, merged (origin, direction, active,
ray ids), and each pass's ring mask. ``film`` launches ``film_kernel``
once for a frame: every pass composited into the canvas in place and the
crop tone-mapped to uint8. Each launch counts in ``kernel_build.LAUNCHES``
(``raygen``, ``film``).

Both take the passes as ``PassGrid``s (each pass's launch grid, frame
offset and ring radii at the gaze, ``csrc/pass_grid.cuh``), and the film
each pass's progressive weight (None where it overwrites), the canvas's
padding and the tone map's settings: ``render/renderer.py`` works them
out (``pass_grids``, ``kernel_frame_rays``, ``kernel_film``), decides
which path a frame takes (``frame_on_kernels``) and keeps the kernels'
plain versions (``plain_frame_rays``; ``plain_composite_passes`` with
``film.finalize``), which the kernels repeat operation for operation.

The C interface takes one struct a kernel (``RaygenArgs``, ``FilmArgs``),
pointers first, then 32-bit integers and floats, then the pass table, as
``csrc/frame.cu`` declares them. ``raygen_inputs`` / ``film_inputs`` build
them and check every tensor's dtype, contiguity, device and shape and the
pass table against the kernels' limits (``MAX_PASSES`` passes, at most
``RNG_STRIDE`` slots a pass, ray ids and counts in 32 bits), and raise
``ValueError`` on anything else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import key_words

# csrc/pass_grid.cuh kMaxPasses, kRngStride and kOffBand (the last two are
# render/raygen.py's RNG_STRIDE and OFF_BAND)
MAX_PASSES = 8
RNG_STRIDE = 64
OFF_BAND = 512

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float


class PassGrid(ctypes.Structure):
    _fields_ = [("factor", _I), ("spp", _I), ("lw", _I), ("lh", _I),
                ("ox", _I), ("oy", _I), ("r_inner", _F), ("r_outer", _F)]


class FilmPass(ctypes.Structure):
    _fields_ = [("radiance", _P), ("alpha", _P), ("blend", _I),
                ("lerp", _F), ("grid", PassGrid)]


class RaygenArgs(ctypes.Structure):
    _fields_ = [*((k, _P) for k in ("eye", "u", "v", "w", "origin",
                                    "direction", "active", "ray_ids",
                                    "ring")),
                *((k, _I) for k in ("n", "width", "height", "gaze_x",
                                    "gaze_y", "antialias", "num_passes")),
                ("key0", _U), ("key1", _U),
                ("ray_base", _I * MAX_PASSES), ("ring_base", _I * MAX_PASSES),
                ("passes", PassGrid * MAX_PASSES)]


class FilmArgs(ctypes.Structure):
    _fields_ = [*((k, _P) for k in ("canvas", "frame", "u", "v", "w",
                                    "probe")),
                *((k, _I) for k in ("canvas_w", "canvas_h", "pad", "width",
                                    "height", "gaze_x", "gaze_y", "probe_w",
                                    "probe_h", "box_x0", "box_y0", "box_x1",
                                    "box_y1", "exposure_on", "tonemap_on")),
                ("exposure_scale", _F), ("inv_white", _F), ("num_passes", _I),
                ("passes", FilmPass * MAX_PASSES)]


# the tensors of ``RaygenArgs``, ``FilmArgs`` and ``FilmPass``, and the
# shapes of the camera's vectors
_RAYGEN = dict.fromkeys(("eye", "u", "v", "w"), torch.float32)
_FILM = dict.fromkeys(("canvas", "u", "v", "w", "probe"), torch.float32)
_PASS = dict.fromkeys(("radiance", "alpha"), torch.float32)
_VEC3 = dict.fromkeys(("eye", "u", "v", "w"), (3,))


def _f32(x: float) -> float:
    """``x`` rounded to float32, as PyTorch converts a Python scalar."""
    return float(np.float32(x))


def _check_grids(grids) -> None:
    """Raises ``ValueError`` unless the kernels take the pass table."""
    if not 1 <= len(grids) <= MAX_PASSES:
        raise ValueError(f"{len(grids)} passes: the kernels take 1 to "
                         f"{MAX_PASSES}")
    for g in grids:
        if not 1 <= g.spp <= RNG_STRIDE:
            raise ValueError(f"spp {g.spp}: the kernels take 1 to "
                             f"RNG_STRIDE {RNG_STRIDE}")


def raygen_inputs(camera, grids, width: int, height: int, gaze_x: int,
                  gaze_y: int, key, antialias: bool):
    """The raygen kernel's struct and the tensors it writes: (args, dict of
    the merged ``origin``, ``direction``, ``active``, ``ray_ids`` and the
    passes' ``ring`` masks end to end). ``camera`` holds the (3,) float32
    ``eye``, ``u``, ``v``, ``w``; ``grids`` the passes' ``PassGrid``s."""
    dev = camera.eye.device
    _check_grids(grids)
    virt_w = width + 2 * OFF_BAND
    id_limit = (width * height + (height + 2 * OFF_BAND) * virt_w) \
        * RNG_STRIDE
    if id_limit >= 2 ** 31:
        raise ValueError(f"{width}x{height} at RNG_STRIDE {RNG_STRIDE} "
                         "overflows int32 ray ids")
    bases, n, rings = [], 0, 0
    for g in grids:
        bases.append((n, rings))
        n += g.lw * g.lh * g.spp
        rings += g.lw * g.lh
    if n >= 2 ** 31:
        raise ValueError(f"{n} rays: the kernel indexes rays in 32 bits")
    out = {"origin": torch.empty((n, 3), dtype=torch.float32, device=dev),
           "direction": torch.empty((n, 3), dtype=torch.float32, device=dev),
           "active": torch.empty((n,), dtype=torch.bool, device=dev),
           "ray_ids": torch.empty((n,), dtype=torch.int64, device=dev),
           "ring": torch.empty((rings,), dtype=torch.bool, device=dev)}
    key0, key1 = key_words(key)
    args = kernel_build.fill(RaygenArgs(
        **{k: v.data_ptr() for k, v in out.items()},
        n=n, width=width, height=height, gaze_x=gaze_x, gaze_y=gaze_y,
        antialias=int(antialias), num_passes=len(grids), key0=key0,
        key1=key1), dev, _RAYGEN, {"eye": camera.eye, "u": camera.u,
                                   "v": camera.v, "w": camera.w}, _VEC3)
    for i, (g, (ray0, ring0)) in enumerate(zip(grids, bases)):
        args.ray_base[i], args.ring_base[i], args.passes[i] = ray0, ring0, g
    return args, out


def generate_rays(camera, grids, width: int, height: int, gaze_x: int,
                  gaze_y: int, key, antialias: bool):
    """Launch ``raygen_kernel`` for the whole passes of ``grids`` ->
    (per-pass ray dicts as ``raygen.generate_pass_rays`` gives them, their
    ray arrays views of the merged ones; the merged dict of ``origin``,
    ``direction``, ``active``, ``ray_ids``)."""
    args, out = raygen_inputs(camera, grids, width, height, gaze_x, gaze_y,
                              key, antialias)
    if args.n:
        kernel_build.launch("frame", "fov_raygen", "raygen", args)
    rays_list = []
    for i, g in enumerate(grids):
        ray0, ring0 = args.ray_base[i], args.ring_base[i]
        end = ray0 + g.lw * g.lh * g.spp
        r = {k: out[k][ray0: end]
             for k in ("origin", "direction", "active", "ray_ids")}
        r.update(ring=out["ring"][ring0: ring0 + g.lw * g.lh].view(g.lh, g.lw),
                 launch=(g.lw, g.lh), offset=(g.ox, g.oy), spp=g.spp,
                 samples_here=g.spp)
        rays_list.append(r)
    merged = {k: out[k] for k in ("origin", "direction", "active", "ray_ids")}
    return rays_list, merged


def film_box(grids, pad: int, width: int, height: int):
    """The canvas pixels the film launches over, (x0, y0, x1, y1): the
    bounding box of the passes' regions and the crop of a ``width`` x
    ``height`` frame padded by ``pad``. Raises ``ValueError`` where a
    region leaves the padded canvas."""
    canvas_w, canvas_h = width + 2 * pad, height + 2 * pad
    x0, y0, x1, y1 = pad, pad, pad + width, pad + height
    for g in grids:
        sx, sy = pad + g.ox, pad + g.oy
        ex, ey = sx + g.lw * g.factor, sy + g.lh * g.factor
        if sx < 0 or sy < 0 or ex > canvas_w or ey > canvas_h:
            raise ValueError("pass region leaves the padded canvas")
        x0, y0, x1, y1 = min(x0, sx), min(y0, sy), max(x1, ex), max(y1, ey)
    return x0, y0, x1, y1


def film_inputs(canvas: torch.Tensor, width: int, height: int, pad: int,
                grids, slot_values, weights, camera, probe: torch.Tensor,
                gaze_x: int, gaze_y: int, *, exposure_stops: float,
                white: float, exposure_on: bool, tonemap_on: bool):
    """The film kernel's struct and the frame it writes: (args, the
    (height, width, 3) uint8 frame). ``canvas`` is the frame padded by
    ``pad`` on every side; ``slot_values`` holds each pass's ``radiance``
    and ``alpha`` as (P, spp, 3) float32 tensors; ``weights`` each pass's
    progressive weight against the canvas (``render/film.py``
    ``progressive_weight``; None overwrites); ``camera`` the (3,) ``u``,
    ``v``, ``w``; ``probe`` the (h, w, 3) float32 probe texels; the rest
    ``ops/tonemap.py`` ``postprocess``'s settings."""
    dev = canvas.device
    _check_grids(grids)
    if not len(slot_values) == len(weights) == len(grids):
        raise ValueError(f"{len(slot_values)} passes of slot values and "
                         f"{len(weights)} weights for {len(grids)} passes")
    w, h = width, height
    canvas_h, canvas_w = h + 2 * pad, w + 2 * pad
    frame = torch.empty((h, w, 3), dtype=torch.uint8, device=dev)
    args = kernel_build.fill(FilmArgs(
        frame=frame.data_ptr(), canvas_w=canvas_w, canvas_h=canvas_h,
        pad=pad, width=w, height=h,
        gaze_x=gaze_x, gaze_y=gaze_y, probe_w=probe.shape[1],
        probe_h=probe.shape[0], exposure_on=int(exposure_on),
        tonemap_on=int(tonemap_on),
        exposure_scale=_f32(2.0 ** exposure_stops),
        inv_white=float(np.float32(1.0) / np.float32(white)),
        num_passes=len(grids)), dev, _FILM,
        {"canvas": canvas, "u": camera.u, "v": camera.v, "w": camera.w,
         "probe": probe}, {**_VEC3, "canvas": (canvas_h, canvas_w, 3)})
    (args.box_x0, args.box_y0, args.box_x1,
     args.box_y1) = film_box(grids, pad, w, h)
    for i, (g, v, a) in enumerate(zip(grids, slot_values, weights)):
        shape = (g.lw * g.lh, g.spp, 3)
        args.passes[i] = kernel_build.fill(
            FilmPass(blend=int(a is not None),
                     lerp=0.0 if a is None else _f32(a), grid=g),
            dev, _PASS, v, {"radiance": shape, "alpha": shape})
    return args, frame


def film(*args, **kwargs):
    """Launch ``film_kernel`` on ``film_inputs``' arguments: composite every
    pass into the canvas in place and tone-map the crop -> the (H, W, 3)
    uint8 frame."""
    fargs, frame = film_inputs(*args, **kwargs)
    kernel_build.launch("frame", "fov_film", "film", fargs)
    return frame


def resources() -> dict:
    """Registers per thread, local memory per thread (spills), resident
    blocks per SM and threads a block of ``raygen`` and ``film``, as the
    CUDA runtime reports them for the loaded build, and the argument
    structs' sizes in the build (``struct_bytes``)."""
    keys = ("registers", "local_bytes", "blocks_per_sm", "threads")
    out = {name: dict(zip(keys, kernel_build.query("frame", "fov_frame_info",
                                                   which)))
           for which, name in enumerate(("raygen", "film"))}
    out["struct_bytes"] = dict(zip(("RaygenArgs", "FilmArgs"),
                                   kernel_build.query("frame",
                                                      "fov_frame_sizes",
                                                      outs=2)))
    return out
