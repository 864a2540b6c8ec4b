"""Sample-parallel frames over several devices in one process (counterpart
of the JAX package's ``parallel/tiles.py``).

The mesh is a list of ``torch.device``s, one a rank; a device may appear
more than once (several ranks on one card, or on the CPU). Rank ``r`` of
``n`` traces the contiguous slice ``r*ceil(spp/n) + [0, ceil(spp/n))`` of
every pass's sample slots on its device, in one merged wavefront; slots
past ``spp`` pad an uneven split and stay inactive. Every ray is keyed by
its pixel and slot (``render/raygen.py``), so each rank traces exactly the
rays the single-device frame traces for those slots.

Assembly: each rank's per-slot values go to the first device, are joined
in slot order and summed over the slots by ``renderer.composite_passes``,
the same code on the same values as the single-device frame, which is
therefore reproduced bit for bit. (Summing per-rank partial sums instead
would not be: torch's ``sum`` over a slot axis of more than three slots
is not a left-to-right fold, so a different grouping rounds differently.)
The scene is replicated once per distinct device.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import torch

from fovpathtracing_optixcodelatest_tpu_torch.config import (
    FoveationSchedule,
    RenderConfig,
)
from fovpathtracing_optixcodelatest_tpu_torch.render import film
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
    composite_passes,
    frame_wavefront,
    pass_slot_values,
)

FIELDS = ("radiance", "alpha")


def _canonical(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices: Optional[Sequence] = None) -> list:
    """The ranks' devices: ``devices`` as given (repeats allowed), or every
    visible CUDA device. Raises when none is given and none is visible."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("no CUDA device is visible: pass the devices")
        devices = [f"cuda:{i}" for i in range(count)]
    mesh = [_canonical(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def _device_sample_ids(spp: int, n_dev: int, dev_index: int) -> torch.Tensor:
    """Rank ``dev_index``'s contiguous slice of the padded sample slots."""
    per_dev = -(-spp // n_dev)  # ceil
    return dev_index * per_dev + torch.arange(per_dev, dtype=torch.int64)


def join_slots(parts, spp: int) -> torch.Tensor:
    """The ranks' (P, k, 3) slot values of one pass, in rank order, on one
    device -> the pass's (P, spp, 3), the padding slots dropped."""
    return torch.cat(parts, dim=1)[:, :spp].contiguous()


def to_device(x, device):
    """``x`` with every tensor moved to ``device``, through frozen
    dataclasses and tuples (a tensor already there is not copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: to_device(getattr(x, f.name), device)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, tuple):
        return tuple(to_device(v, device) for v in x)
    return x


def replicate(scene, mesh) -> list:
    """One scene a rank: the scene copied once to each distinct device of
    ``mesh`` and shared by that device's ranks."""
    if scene.demand is not None:
        raise ValueError("demand-loaded textures do not render multichip")
    copies = {}
    for dev in mesh:
        if dev not in copies:
            copies[dev] = to_device(scene, dev)
    return [copies[dev] for dev in mesh]


def device_scope(device):
    """Make ``device`` current while a rank launches its kernels (they run
    on the current device's stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def render_frame_sharded(scene, camera, gaze_x: int, gaze_y: int,
                         subframe: int, canvas: torch.Tensor, key,
                         config: RenderConfig, schedule: FoveationSchedule,
                         mesh, rank_scenes=None):
    """``render_frame`` over the ranks of ``mesh`` -> (canvas, frame uint8
    (H, W, 3), traces (0-dim int64)), all on the mesh's first device, where
    ``canvas`` must lie (it is updated in place). ``rank_scenes`` (one scene
    a rank, from ``replicate`` or ``scene_shard.shard_scene``) saves the
    copies when the caller renders many frames; by default ``scene`` is
    replicated for this frame."""
    n = len(mesh)
    first = mesh[0]
    if canvas.device != first:
        raise ValueError(f"canvas on {canvas.device}, first rank on {first}")
    if rank_scenes is None:
        rank_scenes = replicate(scene, mesh)
    ranks, traces = [], torch.zeros((), dtype=torch.int64, device=first)
    for r, (dev, sc) in enumerate(zip(mesh, rank_scenes)):
        with device_scope(dev):
            sids = [_device_sample_ids(p.spp, n, r) for p in schedule.passes]
            rays_list, out, offsets = frame_wavefront(
                sc, to_device(camera, dev), gaze_x, gaze_y, key, config,
                schedule, sample_ids_per_pass=sids)
            ranks.append((rays_list,
                          pass_slot_values(rays_list, out, offsets, FIELDS)))
            traces = traces + out["traces"].to(first)
    slot_values = [
        {f: join_slots([rk[1][i][f].to(first) for rk in ranks], p.spp)
         for f in FIELDS}
        for i, p in enumerate(schedule.passes)
    ]
    with device_scope(first):
        composite_passes(rank_scenes[0], to_device(camera, first), gaze_x,
                         gaze_y, subframe, canvas, ranks[0][0], slot_values,
                         config, schedule)
        pad = film.schedule_padding(schedule, config.width, config.height)
        frame = film.finalize(canvas, pad, config)
    return canvas, frame, traces


def make_sharded_renderer(config: RenderConfig, schedule: FoveationSchedule,
                          mesh):
    """A frame function ``fn(scene, camera, gaze_x, gaze_y, subframe,
    canvas, key) -> (canvas, frame, traces)`` over ``mesh`` that replicates
    a scene once and reuses the copies while it is given the same scene."""
    held = {"scene": None, "ranks": None}

    def fn(scene, camera, gaze_x, gaze_y, subframe, canvas, key):
        if held["scene"] is not scene:
            held["scene"], held["ranks"] = scene, replicate(scene, mesh)
        return render_frame_sharded(scene, camera, gaze_x, gaze_y, subframe,
                                    canvas, key, config, schedule, mesh,
                                    rank_scenes=held["ranks"])

    return fn
