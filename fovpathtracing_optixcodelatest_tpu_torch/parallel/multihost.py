"""Frames rendered by several processes joined by ``torch.distributed``
(counterpart of the JAX package's ``parallel/multihost.py``).

``RenderJob`` says what to render (a scene preset or an OBJ, the probe,
the config, the schedule, gaze, seed, frame count) as a picklable spec.
``worker(rank, world_size, init_method)`` is one process's entry: it joins
the group, renders its slice of every pass's sample slots
(``parallel/tiles.py``'s split, rank = slice), gathers every rank's
per-slot values (``all_gather``) and composites them as the single-device
frame does, so every rank returns the whole frame, bit for bit the frame
``reference_frame`` renders in one process. The default backend is NCCL on
CUDA and gloo on the CPU; gloo also takes CUDA tensors, which is how two
ranks share one card (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RenderJob:
    """Picklable description of one distributed render.

    ``scene`` is a preset name of ``models/scenes.py`` (or pass
    ``obj_path``); ``schedule`` a FoveationSchedule, a spec string
    ("uniform:N" / "F_A_P") or None for the demo schedule;
    ``config_overrides`` are RenderConfig fields beyond width/height."""

    width: int = 32
    height: int = 24
    scene: str = "cornell"
    scene_kwargs: tuple = (("sphere_subdiv", 0),)
    obj_path: Optional[str] = None
    probe: str = "gradient"  # "gradient" | "constant"
    probe_kwargs: tuple = (("width", 32), ("height", 16))
    schedule: object = None
    config_overrides: tuple = (("max_depth", 2),)
    frames: int = 1
    gaze: Optional[Tuple[int, int]] = None
    seed: int = 0


def _build_job(job: RenderJob, device):
    """(scene, config, schedule, camera params, canvas) of ``job`` on
    ``device``: what every rank and the one-process twin render."""
    from fovpathtracing_optixcodelatest_tpu_torch.config import (
        FoveationPass,
        FoveationSchedule,
        RenderConfig,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
    from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera
    from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
        constant_probe,
        gradient_sky_probe,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
        build_scene,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render import film

    if job.obj_path:
        from fovpathtracing_optixcodelatest_tpu_torch.models.obj_loader import (
            load_obj,
        )

        meshes, textures = load_obj(job.obj_path)
        cam = Camera(eye=(3.0, 1.5, 3.0), lookat=(0.0, 0.0, 0.0), fov_y=45.0)
    else:
        meshes, cam = getattr(scenes, job.scene)(**dict(job.scene_kwargs))
        textures = None
    probe = (gradient_sky_probe(**dict(job.probe_kwargs))
             if job.probe == "gradient" else constant_probe((2.0, 2.0, 2.0)))
    scene = build_scene(meshes, probe, texture_images=textures, device=device)
    config = RenderConfig(width=job.width, height=job.height,
                          **dict(job.config_overrides))
    sched = job.schedule
    if sched is None:
        r = 5
        sched = FoveationSchedule(passes=(
            FoveationPass(factor=4, spp=2, r_inner=float(r), r_outer=1e9,
                          redraw=False),
            FoveationPass(factor=1, spp=4, r_inner=0.0, r_outer=float(r + 1),
                          redraw=True, launch_w=2 * (r + 1),
                          launch_h=2 * (r + 1), centered=True,
                          center_offset=r + 1),
        ))
    elif isinstance(sched, str):
        from fovpathtracing_optixcodelatest_tpu_torch.apps.main import (
            build_schedule,
        )

        sched = build_schedule(sched)
    camp = dataclasses.replace(
        cam, aspect=job.width / job.height).device_params(device)
    pad = film.schedule_padding(sched, job.width, job.height)
    canvas = film.new_canvas(job.width, job.height, pad, device)
    return scene, config, sched, camp, canvas


def worker(rank: int, world_size: int, init_method: str, device="cuda",
           backend: Optional[str] = None, job: Optional[RenderJob] = None,
           timeout_s: float = 300.0) -> Tuple:
    """Render ``job`` as rank ``rank`` of ``world_size`` processes joined at
    ``init_method`` (e.g. ``tcp://localhost:PORT``) -> (frame (H, W, 3)
    uint8 ndarray, total traces of every rank and frame). ``device="cuda"``
    takes card ``rank % device_count``; the group is left on return."""
    import datetime

    import torch
    import torch.distributed as dist

    from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import (
        fold_in,
        prng_key,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.parallel import tiles
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        composite_and_finalize,
        frame_wavefront,
        pass_slot_values,
    )

    job = job or RenderJob()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        with tiles.device_scope(dev):
            scene, config, schedule, camp, canvas = _build_job(job, dev)
            gx, gy = job.gaze or (job.width // 2, job.height // 2)
            sids = [tiles._device_sample_ids(p.spp, world_size, rank)
                    for p in schedule.passes]
            key = prng_key(job.seed)
            total = torch.zeros((), dtype=torch.int64, device=dev)
            frame = None
            for i in range(job.frames):
                rays_list, out, offsets = frame_wavefront(
                    scene, camp, gx, gy, fold_in(key, i), config, schedule,
                    sample_ids_per_pass=sids)
                slot_values = []
                for p, v in zip(schedule.passes,
                                pass_slot_values(rays_list, out, offsets,
                                                 tiles.FIELDS)):
                    joined = {}
                    for f, x in v.items():
                        x = x.contiguous()
                        parts = [torch.empty_like(x)
                                 for _ in range(world_size)]
                        dist.all_gather(parts, x)
                        joined[f] = tiles.join_slots(parts, p.spp)
                    slot_values.append(joined)
                _, frame = composite_and_finalize(
                    scene, camp, gx, gy, i, canvas, rays_list, slot_values,
                    config, schedule)
                traces = out["traces"].clone()
                dist.all_reduce(traces)
                total += traces
            return frame.cpu().numpy(), int(total)
    finally:
        dist.destroy_process_group()


def reference_frame(width: int = 32, height: int = 24,
                    job: Optional[RenderJob] = None, device="cuda"):
    """The one-process twin of ``worker``'s render: the same job through
    ``render_frame`` on ``device`` -> the last frame (H, W, 3) uint8."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import (
        fold_in,
        prng_key,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        render_frame,
    )

    job = job or RenderJob(width=width, height=height)
    scene, config, schedule, camp, canvas = _build_job(job, device)
    gx, gy = job.gaze or (job.width // 2, job.height // 2)
    key = prng_key(job.seed)
    frame = None
    for i in range(job.frames):
        canvas, frame, _ = render_frame(scene, camp, gx, gy, i, canvas,
                                        fold_in(key, i), config, schedule)
    return frame.cpu().numpy()
