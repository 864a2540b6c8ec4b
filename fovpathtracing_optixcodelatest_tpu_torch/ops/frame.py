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


def _f32(x: float) -> float:
    """``x`` rounded to float32, as PyTorch converts a Python scalar."""
    return float(np.float32(x))


def _ptr(name: str, x: torch.Tensor, dtype, device, shape=None) -> int:
    """``x``'s data pointer; raises ``ValueError`` unless it is a contiguous
    ``dtype`` tensor on ``device`` (of ``shape``, where given)."""
    if (x.dtype != dtype or not x.is_contiguous() or x.device != device
            or (shape is not None and tuple(x.shape) != tuple(shape))):
        raise ValueError(
            f"{name}: a contiguous {dtype} tensor"
            f"{'' if shape is None else f' of shape {tuple(shape)}'} on "
            f"{device} is needed, got {x.dtype} {tuple(x.shape)}"
            f"{'' if x.is_contiguous() else ' (strided)'} on {x.device}")
    return x.data_ptr()


def _check_grids(grids) -> None:
    """Raises ``ValueError`` unless the kernels take the pass table."""
    if not 1 <= len(grids) <= MAX_PASSES:
        raise ValueError(f"{len(grids)} passes: the kernels take 1 to "
                         f"{MAX_PASSES}")
    for g in grids:
        if not 1 <= g.spp <= RNG_STRIDE:
            raise ValueError(f"spp {g.spp}: the kernels take 1 to "
                             f"RNG_STRIDE {RNG_STRIDE}")


def _camera_ptrs(camera, names, device) -> dict:
    return {k: _ptr(f"camera.{k}", getattr(camera, k), torch.float32,
                    device, (3,)) for k in names}


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
    args = RaygenArgs(
        **_camera_ptrs(camera, ("eye", "u", "v", "w"), dev),
        **{k: v.data_ptr() for k, v in out.items()},
        n=n, width=width, height=height, gaze_x=gaze_x, gaze_y=gaze_y,
        antialias=int(antialias), num_passes=len(grids), key0=key0, key1=key1)
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
        rc = kernel_build.library("frame").fov_raygen(
            ctypes.addressof(args), kernel_build.stream())
        kernel_build.check(rc, "raygen")
        kernel_build.LAUNCHES["raygen"] += 1
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
    ptr = _ptr("canvas", canvas, torch.float32, dev, (canvas_h, canvas_w, 3))
    frame = torch.empty((h, w, 3), dtype=torch.uint8, device=dev)
    args = FilmArgs(
        canvas=ptr, frame=frame.data_ptr(),
        **_camera_ptrs(camera, ("u", "v", "w"), dev),
        probe=_ptr("probe", probe, torch.float32, dev),
        canvas_w=canvas_w, canvas_h=canvas_h, pad=pad, width=w, height=h,
        gaze_x=gaze_x, gaze_y=gaze_y, probe_w=probe.shape[1],
        probe_h=probe.shape[0], exposure_on=int(exposure_on),
        tonemap_on=int(tonemap_on),
        exposure_scale=_f32(2.0 ** exposure_stops),
        inv_white=float(np.float32(1.0) / np.float32(white)),
        num_passes=len(grids))
    (args.box_x0, args.box_y0, args.box_x1,
     args.box_y1) = film_box(grids, pad, w, h)
    for i, (g, v, a) in enumerate(zip(grids, slot_values, weights)):
        shape = (g.lw * g.lh, g.spp, 3)
        args.passes[i] = FilmPass(
            _ptr(f"pass {i} radiance", v["radiance"], torch.float32, dev,
                 shape),
            _ptr(f"pass {i} alpha", v["alpha"], torch.float32, dev, shape),
            int(a is not None), 0.0 if a is None else _f32(a), g)
    return args, frame


def film(*args, **kwargs):
    """Launch ``film_kernel`` on ``film_inputs``' arguments: composite every
    pass into the canvas in place and tone-map the crop -> the (H, W, 3)
    uint8 frame."""
    fargs, frame = film_inputs(*args, **kwargs)
    rc = kernel_build.library("frame").fov_film(ctypes.addressof(fargs),
                                                kernel_build.stream())
    kernel_build.check(rc, "film")
    kernel_build.LAUNCHES["film"] += 1
    return frame


def resources() -> dict:
    """Registers per thread, local memory per thread (spills), resident
    blocks per SM and threads a block of ``raygen`` and ``film``, as the
    CUDA runtime reports them for the loaded build, and the argument
    structs' sizes in the build (``struct_bytes``)."""
    lib = kernel_build.library("frame")
    keys = ("registers", "local_bytes", "blocks_per_sm", "threads")
    out = {}
    for which, name in enumerate(("raygen", "film")):
        vals = [ctypes.c_int(0) for _ in keys]
        kernel_build.check(lib.fov_frame_info(
            which, *(ctypes.addressof(v) for v in vals)), "fov_frame_info")
        out[name] = dict(zip(keys, (v.value for v in vals)))
    sizes = [ctypes.c_int(0), ctypes.c_int(0)]
    kernel_build.check(lib.fov_frame_sizes(
        *(ctypes.addressof(v) for v in sizes)), "fov_frame_sizes")
    out["struct_bytes"] = {"RaygenArgs": sizes[0].value,
                           "FilmArgs": sizes[1].value}
    return out
