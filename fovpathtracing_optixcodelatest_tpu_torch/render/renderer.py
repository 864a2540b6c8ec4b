"""The Renderer front end (counterpart of the JAX package's
``render/renderer.py``): ``render_frame`` traces every foveation pass as one
merged wavefront and composites the passes into the accumulation canvas;
``render_frame_aov`` adds the normal and albedo AOV images; ``Renderer``
carries the canvas, the subframe index and the camera between frames,
given a ``DemandLoader`` pages the textures its frames request in between
frames (``process_demand_requests``), and with ``multichip`` renders over
several devices (``parallel/``). ``frame_wavefront`` can trace a slice of
each pass's sample slots and ``composite_and_finalize`` composites slot
values however they were gathered: both are the multi-device paths' parts.

On CUDA tensors, for whole passes of the ``random`` sampler (or none,
without antialiasing) and no AOV canvases (``frame_on_kernels``), a
frame's ray generation is one launch of ``csrc/frame.cu``'s
``raygen_kernel`` (``kernel_frame_rays``) and its film and tone map one
launch of its ``film_kernel`` (``kernel_film``), through ``ops/frame.py``,
on the same arithmetic as their plain versions (``plain_frame_rays``, and
``plain_composite_passes`` with ``film.finalize``: some 800 PyTorch ops a
frame), which run everywhere else.

Keys follow the JAX package's chain: frame key = fold_in(PRNGKey(seed),
subframe), jitter key = fold_in(frame key, 0), path key = fold_in(frame
key, 1) (``ops.rng``).

Spans (``utils/tracing.py``): a ``Renderer`` frame is ``fov.frame`` and
counts one displayed frame, its download the sync ``download``, after
which the device's counts of the frame are folded in; ray
generation with the passes' merge is ``fov.raygen``, the film
``fov.film`` (the plain path's tone map ``fov.tonemap``). Each wavefront's
ray generation counts under ``raygen`` and each frame's film under
``film``, keyed ``"kernel"`` or ``"plain"`` by the path it took.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from fovpathtracing_optixcodelatest_tpu_torch.config import (
    FoveationSchedule,
    RenderConfig,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import ProbeParams
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
    Scene,
    build_scene,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import frame as frame_ops
from fovpathtracing_optixcodelatest_tpu_torch.ops import probe_sampling as probe_ops
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import fold_in, prng_key
from fovpathtracing_optixcodelatest_tpu_torch.render import film, raygen
from fovpathtracing_optixcodelatest_tpu_torch.render.integrator import trace_paths
from fovpathtracing_optixcodelatest_tpu_torch.utils import tracing


def pass_backplate(scene, camera, rays, width: int, height: int, p,
                   gaze_x: int, gaze_y: int) -> torch.Tensor:
    """Pixel-center probe radiance over the pass's launch grid (P, 3).
    ``rays`` is the pass's ray batch (``generate_pass_rays``), in the JAX
    package's argument order; the grid is the pass's own, which is the
    batch's."""
    idx_x, idx_y = raygen.pass_pixels(p, width, height, gaze_x, gaze_y,
                                      scene.device)
    dirs = raygen.pixel_center_directions(camera, idx_x, idx_y, width, height)
    return probe_ops.probe_eval(scene.probe, probe_ops.dir_to_uv(dirs))


def render_pass_partial(scene, camera, p, width: int, height: int,
                        gaze_x: int, gaze_y: int, pass_key,
                        config: RenderConfig, sample_ids=None):
    """One foveation pass over the sample slots ``sample_ids`` (default
    all), traced alone under ``pass_key`` (jitter key fold_in(pass_key, 0),
    path key fold_in(pass_key, 1)). Returns (rad_sum (P, 3), alpha_sum
    (P, 3), rays dict, traces, dict of the ``normal``/``albedo`` sums), the
    sums over this call's slots: disjoint slices add up to the whole pass
    (to rounding: the sum regroups)."""
    rays = raygen.generate_pass_rays(
        camera, p, width, height, gaze_x, gaze_y, fold_in(pass_key, 0),
        antialias=config.antialias, sampler=config.sampler,
        sample_ids=sample_ids)
    out = trace_paths(scene, rays["origin"], rays["direction"],
                      rays["active"], fold_in(pass_key, 1), config,
                      ray_ids=rays["ray_ids"])
    n_pix = rays["launch"][0] * rays["launch"][1]
    k = rays["samples_here"]
    sums = {f: out[f].reshape(n_pix, k, 3).sum(1)
            for f in ("radiance", "alpha", "normal", "albedo")}
    return (sums["radiance"], sums["alpha"], rays, out["traces"],
            {f: sums[f] for f in ("normal", "albedo")})


def frame_on_kernels(device, config: RenderConfig,
                     sample_ids_per_pass=None, aov_canvas=None) -> bool:
    """Whether a frame generates its rays and composites and tone-maps its
    passes with ``csrc/frame.cu``'s kernels (``kernel_frame_rays``,
    ``kernel_film``): on CUDA tensors, with the ``random`` sampler or no
    antialiasing, for whole passes (no ``sample_ids_per_pass``) and
    without AOV canvases. The scene, spectral or RGB paths and demand
    textures do not matter: the film takes RGB slot values. As
    ``integrator.shades_on_kernels`` decides the bounce."""
    return (torch.device(device).type == "cuda"
            and (config.sampler == "random" or not config.antialias)
            and sample_ids_per_pass is None and not aov_canvas)


def pass_grids(schedule: FoveationSchedule, width: int, height: int,
               gaze_x: int, gaze_y: int) -> list:
    """Each pass's launch grid, frame offset and ring radii at the gaze
    (``raygen.pass_launch_dims``, ``pass_offset``), as the frame's kernels
    take them (``ops/frame.py`` ``PassGrid``: the radii in float32)."""
    return [frame_ops.PassGrid(p.factor, p.spp,
                               *raygen.pass_launch_dims(p, width, height),
                               *raygen.pass_offset(p, gaze_x, gaze_y),
                               p.r_inner, p.r_outer)
            for p in schedule.passes]


def plain_frame_rays(camera, gaze_x: int, gaze_y: int, jitter_key,
                     config: RenderConfig, schedule: FoveationSchedule,
                     sample_ids_per_pass=None):
    """Every pass's rays (``raygen.generate_pass_rays``) and their merge in
    PyTorch -> (per-pass ray dicts, merged dict of ``origin``,
    ``direction``, ``active``, ``ray_ids``). The plain version of
    ``kernel_frame_rays``."""
    rays_list = [
        raygen.generate_pass_rays(
            camera, p, config.width, config.height, gaze_x, gaze_y,
            jitter_key, antialias=config.antialias, sampler=config.sampler,
            sample_ids=None if sample_ids_per_pass is None
            else sample_ids_per_pass[i])
        for i, p in enumerate(schedule.passes)
    ]
    merged = {
        k: torch.cat([r[k] for r in rays_list], dim=0)
        for k in ("origin", "direction", "active", "ray_ids")
    }
    return rays_list, merged


def kernel_frame_rays(camera, gaze_x: int, gaze_y: int, jitter_key,
                      config: RenderConfig, schedule: FoveationSchedule):
    """``plain_frame_rays`` for whole passes of the ``random`` sampler (or
    none) in one launch of ``raygen_kernel`` (``ops/frame.py``
    ``generate_rays``), bit for bit."""
    w, h = config.width, config.height
    return frame_ops.generate_rays(
        camera, pass_grids(schedule, w, h, gaze_x, gaze_y), w, h, gaze_x,
        gaze_y, jitter_key, config.antialias)


def frame_wavefront(scene, camera, gaze_x: int, gaze_y: int, key,
                    config: RenderConfig, schedule: FoveationSchedule,
                    sample_ids_per_pass=None):
    """Generate every pass's rays and trace them as one batch;
    ``sample_ids_per_pass`` narrows each pass to those of its sample slots
    (``parallel/tiles.py``). Returns (per-pass ray dicts, trace_paths
    output, per-pass offsets)."""
    jitter_key = fold_in(key, 0)
    path_key = fold_in(key, 1)
    kernels = frame_on_kernels(camera.eye.device, config,
                               sample_ids_per_pass)
    tracing.count("raygen", "kernel" if kernels else "plain", 1)
    with tracing.span(tracing.RAYGEN):
        if kernels:
            rays_list, merged = kernel_frame_rays(
                camera, gaze_x, gaze_y, jitter_key, config, schedule)
        else:
            rays_list, merged = plain_frame_rays(
                camera, gaze_x, gaze_y, jitter_key, config, schedule,
                sample_ids_per_pass)
    out = trace_paths(scene, merged["origin"], merged["direction"],
                      merged["active"], path_key, config,
                      ray_ids=merged["ray_ids"])
    offsets, ofs = [], 0
    for r in rays_list:
        offsets.append(ofs)
        ofs += r["launch"][0] * r["launch"][1] * r["samples_here"]
    return rays_list, out, offsets


def pass_slot_values(rays_list, out, offsets,
                     fields=("radiance", "alpha")) -> list:
    """Each pass's traced values per field as (P, k, 3): pixel-major, one
    column per sample slot the wavefront made."""
    vals = []
    for r, ofs in zip(rays_list, offsets):
        n_pix = r["launch"][0] * r["launch"][1]
        k = r["samples_here"]
        vals.append({f: out[f][ofs: ofs + n_pix * k].reshape(n_pix, k, 3)
                     for f in fields})
    return vals


@tracing.spanned(tracing.FILM)
def plain_composite_passes(scene, camera, gaze_x: int, gaze_y: int,
                           subframe: int, canvas: torch.Tensor, rays_list,
                           slot_values, config: RenderConfig,
                           schedule: FoveationSchedule,
                           aov_canvas=None) -> None:
    """Composite every pass into ``canvas`` (in place) from its (P, spp, 3)
    slot values, summed over the slots here and nowhere else, so that every
    path that assembles the same values gets the same frame. Where
    ``aov_canvas`` maps AOV names to canvases, each pass's mean AOV goes
    into them too, always overwriting. Inner passes composite after outer
    ones and overwrite the ring overlap. With ``film.finalize``, the plain
    version of ``kernel_film``."""
    w, h = config.width, config.height
    pad = film.schedule_padding(schedule, w, h)
    for p, rays, v in zip(schedule.passes, rays_list, slot_values):
        lw, lh = rays["launch"]
        rad_sum = v["radiance"].sum(1)
        alpha_sum = v["alpha"].sum(1)
        backplate = pass_backplate(scene, camera, rays, w, h, p, gaze_x,
                                   gaze_y)
        accum_color = film.shade_to_accum_color(
            rad_sum, alpha_sum, backplate, p.spp, rays["launch"]
        )
        film.composite_pass(canvas, accum_color, rays["ring"], p,
                            rays["offset"], subframe, pad, config.accumulate)
        overwrite = dataclasses.replace(p, redraw=True)
        for name, target in (aov_canvas or {}).items():
            img = (v[name].sum(1) / p.spp).reshape(lh, lw, 3)
            film.composite_pass(target, img, rays["ring"], overwrite,
                                rays["offset"], subframe, pad, False)


def film_arguments(scene, camera, gaze_x: int, gaze_y: int, subframe: int,
                   canvas: torch.Tensor, slot_values, config: RenderConfig,
                   schedule: FoveationSchedule) -> dict:
    """``ops/frame.py`` ``film``'s arguments for the frame: the canvas's
    padding, the passes' grids, each pass's progressive weight
    (``film.progressive_weight``) and the tone map's settings."""
    w, h = config.width, config.height
    return dict(
        canvas=canvas, width=w, height=h,
        pad=film.schedule_padding(schedule, w, h),
        grids=pass_grids(schedule, w, h, gaze_x, gaze_y),
        slot_values=slot_values,
        weights=[film.progressive_weight(p, subframe, config.accumulate)
                 for p in schedule.passes],
        camera=camera, probe=scene.probe.data, gaze_x=gaze_x, gaze_y=gaze_y,
        exposure_stops=config.exposure_stops, white=config.white,
        exposure_on=config.exposure_correction,
        tonemap_on=config.tone_mapping)


def kernel_film(scene, camera, gaze_x: int, gaze_y: int, subframe: int,
                canvas: torch.Tensor, slot_values, config: RenderConfig,
                schedule: FoveationSchedule) -> torch.Tensor:
    """``plain_composite_passes`` (without AOV canvases) and
    ``film.finalize`` in one launch of ``film_kernel`` (``ops/frame.py``
    ``film``), bit for bit -> the (H, W, 3) uint8 frame."""
    return frame_ops.film(**film_arguments(
        scene, camera, gaze_x, gaze_y, subframe, canvas, slot_values, config,
        schedule))


def composite_and_finalize(scene, camera, gaze_x: int, gaze_y: int,
                           subframe: int, canvas: torch.Tensor, rays_list,
                           slot_values, config: RenderConfig,
                           schedule: FoveationSchedule, aov_canvas=None):
    """Composite every pass into ``canvas`` (in place; the AOV canvases
    too, where given) from its (P, spp, 3) slot values, however they were
    gathered, and tone-map the crop -> (rays of the frame, frame (H, W, 3)
    uint8)."""
    total_rays = sum(r["launch"][0] * r["launch"][1] * p.spp
                     for p, r in zip(schedule.passes, rays_list))
    kernels = frame_on_kernels(canvas.device, config, aov_canvas=aov_canvas)
    tracing.count("film", "kernel" if kernels else "plain", 1)
    if kernels:
        with tracing.span(tracing.FILM):
            return total_rays, kernel_film(
                scene, camera, gaze_x, gaze_y, subframe, canvas, slot_values,
                config, schedule)
    plain_composite_passes(scene, camera, gaze_x, gaze_y, subframe, canvas,
                           rays_list, slot_values, config, schedule,
                           aov_canvas)
    pad = film.schedule_padding(schedule, config.width, config.height)
    return total_rays, film.finalize(canvas, pad, config)


def _trace_and_composite(scene, camera, gaze_x: int, gaze_y: int,
                         subframe: int, canvas: torch.Tensor, key,
                         config: RenderConfig, schedule: FoveationSchedule,
                         aov_canvas=None):
    """Trace the frame's wavefront, composite it into ``canvas`` (and the
    AOV canvases) and tone-map it. Returns (trace_paths output, rays per
    frame, frame (H, W, 3) uint8)."""
    rays_list, out, offsets = frame_wavefront(
        scene, camera, gaze_x, gaze_y, key, config, schedule
    )
    fields = ("radiance", "alpha") + tuple(aov_canvas or ())
    total_rays, frame = composite_and_finalize(
        scene, camera, gaze_x, gaze_y, subframe, canvas, rays_list,
        pass_slot_values(rays_list, out, offsets, fields), config, schedule,
        aov_canvas)
    return out, total_rays, frame


def render_frame(scene, camera, gaze_x: int, gaze_y: int, subframe: int,
                 canvas: torch.Tensor, key, config: RenderConfig,
                 schedule: FoveationSchedule):
    """One full frame -> (canvas, frame uint8 (H, W, 3), stats). The canvas
    is updated in place and returned."""
    out, total_rays, frame = _trace_and_composite(
        scene, camera, gaze_x, gaze_y, subframe, canvas, key, config,
        schedule)
    stats = {"traces": out["traces"], "rays": total_rays}
    if "demand_requests" in out:
        stats["demand_requests"] = out["demand_requests"]
    return canvas, frame, stats


def render_frame_aov(scene, camera, gaze_x: int, gaze_y: int, subframe: int,
                     canvas: torch.Tensor, key, config: RenderConfig,
                     schedule: FoveationSchedule):
    """``render_frame`` plus full-frame normal and albedo AOV images,
    composited per pass with the color's block replication, always
    overwriting (no accumulation). Returns (canvas, frame, aovs dict of
    (H, W, 3) ``accum``/``normal``/``albedo``, stats)."""
    w, h = config.width, config.height
    pad = film.schedule_padding(schedule, w, h)
    aov_canvas = {name: film.new_canvas(w, h, pad, canvas.device)
                  for name in ("normal", "albedo")}
    out, _, frame = _trace_and_composite(
        scene, camera, gaze_x, gaze_y, subframe, canvas, key, config,
        schedule, aov_canvas)
    crop = lambda c: c[pad: pad + h, pad: pad + w]  # noqa: E731
    # a copy: later frames write the canvas in place
    aovs = {"accum": crop(canvas).clone(),
            **{name: crop(c) for name, c in aov_canvas.items()}}
    return canvas, frame, aovs, {"traces": out["traces"]}


class Renderer:
    """Stateful shell over ``render_frame``: camera, canvas, subframe, and
    an optional ``demand_loader`` (``models/demand.DemandLoader``) whose
    context the scene samples its textures through.

    The scene comes as the JAX package's ``Renderer`` takes it: ``meshes``
    (a sequence of ``HostMesh``; ``probe`` and ``texture_images`` as
    ``build_scene`` takes them) builds it on ``device``; a prebuilt
    ``scene`` (also the first positional argument) is used as it is, its
    probe swapped for ``probe`` where one is given.

    ``multichip="samples"`` renders every frame over the devices of
    ``mesh`` (default ``parallel/tiles.make_mesh()``, every visible CUDA
    device; on a CPU renderer the one CPU), each tracing its slice of every
    pass's sample slots; ``"scene"`` also cuts ``tri_pack`` into one row
    block a device (``parallel/scene_shard.py``). Both give the
    single-device frame; ``render_aov`` stays on the renderer's device. A
    demand loader is refused with either."""

    def __init__(self, scene: Optional[Scene] = None,
                 config: RenderConfig = RenderConfig(),
                 schedule: Optional[FoveationSchedule] = None, seed: int = 0,
                 device="cuda", demand_loader=None,
                 multichip: Optional[str] = None, mesh=None, *,
                 meshes: Optional[Sequence] = None,
                 probe: Optional[ProbeParams] = None, texture_images=None):
        config.check_supported()
        self.device = torch.device(device)
        if scene is not None and not isinstance(scene, Scene):
            if meshes is not None:
                raise ValueError("meshes given twice")
            meshes, scene = scene, None  # JAX's first positional argument
        if scene is None:
            if meshes is None:
                raise ValueError("provide meshes or a prebuilt scene")
            scene = build_scene(meshes, probe=probe,
                                texture_images=texture_images,
                                device=self.device)
        elif probe is not None:
            scene = scene.with_probe(probe)
        if scene.device.type != self.device.type:
            raise ValueError(
                f"scene lies on {scene.device}, renderer on {self.device}"
            )
        if multichip not in (None, "samples", "scene"):
            raise ValueError(f"multichip {multichip!r}: 'samples' or 'scene'")
        if multichip and demand_loader is not None:
            raise ValueError("demand-loaded textures do not render multichip")
        self.demand_loader = demand_loader
        if demand_loader is not None:
            scene = scene.with_demand(demand_loader.launch_prepare())
        self.multichip = multichip
        if multichip:
            # imported here: parallel/ imports this module
            from fovpathtracing_optixcodelatest_tpu_torch.parallel import tiles

            if mesh is None:
                mesh = (tiles.make_mesh() if self.device.type == "cuda"
                        else [self.device])
            self.mesh = tiles.make_mesh(mesh)
            if multichip == "scene":
                from fovpathtracing_optixcodelatest_tpu_torch.parallel import (
                    scene_shard,
                )

                scene = scene_shard.pad_scene_rows(scene, len(self.mesh))
        self.scene = scene
        self._rank_scenes = None
        self.config = config
        self.schedule = schedule or FoveationSchedule.reference_32_16_8()
        self.camera_params = None
        self._key = prng_key(seed)
        self._new_canvas()
        self.last_frame: Optional[torch.Tensor] = None
        self._stats: dict = {}

    def set_camera(self, camera) -> None:
        """Set the camera and restart accumulation."""
        self.camera_params = camera.device_params(self.device)
        self.subframe = 0

    def set_probe(self, probe) -> None:
        """Swap the environment probe and restart accumulation."""
        self.scene = self.scene.with_probe(probe)
        self._rank_scenes = None
        self.subframe = 0

    def set_schedule(self, schedule: FoveationSchedule) -> None:
        """Swap the foveation schedule: re-pad the canvas, restart
        accumulation."""
        self.schedule = schedule
        self._new_canvas()

    def resize(self, size: Tuple[int, int]) -> None:
        """Change the frame to ``size`` = (width, height): a new canvas,
        accumulation restarts."""
        self.config = dataclasses.replace(self.config, width=size[0],
                                          height=size[1])
        self._new_canvas()

    def _new_canvas(self) -> None:
        w, h = self.config.width, self.config.height
        self._pad = film.schedule_padding(self.schedule, w, h)
        self.canvas = film.new_canvas(w, h, self._pad, self.device)
        self.subframe = 0

    def _frame_args(self, gaze):
        if self.camera_params is None:
            raise RuntimeError("set_camera() first")
        w, h = self.config.width, self.config.height
        if gaze is None:
            gaze = (w // 2, h // 2)
        gx = int(np.clip(gaze[0], 0, w - 1))
        gy = int(np.clip(gaze[1], 0, h - 1))
        return (self.scene, self.camera_params, gx, gy, self.subframe,
                self.canvas, fold_in(self._key, self.subframe), self.config,
                self.schedule)

    def render(self, gaze: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Render one frame (gaze defaults to the frame center) ->
        (H, W, 3) uint8."""
        with tracing.frame():
            args = self._frame_args(gaze)
            if self.multichip:
                self.canvas, frame, traces = self._sharded_frame(*args)
                self._stats = {"traces": traces}
            else:
                self.canvas, frame, self._stats = render_frame(*args)
            self.subframe += 1
            self.last_frame = frame
            with tracing.sync("download"):
                pixels = frame.cpu().numpy()
            tracing.fold()
            return pixels

    def _sharded_frame(self, *args):
        from fovpathtracing_optixcodelatest_tpu_torch.parallel import (
            scene_shard,
            tiles,
        )

        if self._rank_scenes is None:  # built once, reused by every frame
            split = (scene_shard.shard_scene if self.multichip == "scene"
                     else tiles.replicate)
            self._rank_scenes = split(self.scene, self.mesh)
        return tiles.render_frame_sharded(*args, self.mesh,
                                          rank_scenes=self._rank_scenes)

    def render_aov(self, gaze: Optional[Tuple[int, int]] = None):
        """One frame through ``render_frame_aov``, with ``render``'s
        accumulation -> (frame (H, W, 3) uint8, dict of the linear
        ``accum``/``normal``/``albedo`` (H, W, 3) float32 tensors)."""
        with tracing.frame():
            self.canvas, frame, aovs, self._stats = render_frame_aov(
                *self._frame_args(gaze))
            self.subframe += 1
            self.last_frame = frame
            with tracing.sync("download"):
                pixels = frame.cpu().numpy()
            tracing.fold()
            return pixels, aovs

    def download_pixels(self) -> np.ndarray:
        if self.last_frame is None:
            raise RuntimeError("render() first")
        return self.last_frame.cpu().numpy()

    def linear_frame(self) -> np.ndarray:
        """Cropped linear accumulation (H, W, 3) float32."""
        p = self._pad
        return self.canvas[p: p + self.config.height,
                           p: p + self.config.width].cpu().numpy()

    def process_demand_requests(self) -> int:
        """Between frames: fill the tiles the last frame requested (on the
        loader's worker pool), upload them and swap the new context into the
        scene. Returns the number of pages requested; 0 without a demand
        loader."""
        if self.demand_loader is None:
            return 0
        req = self._stats.get("demand_requests")
        if req is None:
            return 0
        req = req.cpu().numpy()
        n = int(req.sum())
        if n:
            self.demand_loader.process_requests(req).wait()
        self.scene = self.scene.with_demand(
            self.demand_loader.launch_prepare())
        return n

    @property
    def stats(self) -> dict:
        """The last frame's scalar stats (``traces``, ``rays``); the
        request bitmap ``demand_requests`` stays out."""
        return {k: int(v) for k, v in self._stats.items()
                if not isinstance(v, torch.Tensor) or v.ndim == 0}
