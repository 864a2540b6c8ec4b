"""The Renderer front end (counterpart of the JAX package's
``render/renderer.py``): ``render_frame`` traces every foveation pass as one
merged wavefront and composites the passes into the accumulation canvas;
``render_frame_aov`` adds the normal and albedo AOV images; ``Renderer``
carries the canvas, the subframe index and the camera between frames,
given a ``DemandLoader`` pages the textures its frames request in between
frames (``process_demand_requests``), and with ``multichip`` renders over
several devices (``parallel/``). ``frame_wavefront`` can trace a slice of
each pass's sample slots and ``composite_passes`` composites slot values
however they were gathered: both are the multi-device paths' parts.

Keys follow the JAX package's chain: frame key = fold_in(PRNGKey(seed),
subframe), jitter key = fold_in(frame key, 0), path key = fold_in(frame
key, 1) (``ops.rng``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from fovpathtracing_optixcodelatest_tpu_torch.config import (
    FoveationSchedule,
    RenderConfig,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import probe_sampling as probe_ops
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import fold_in, prng_key
from fovpathtracing_optixcodelatest_tpu_torch.render import film, raygen
from fovpathtracing_optixcodelatest_tpu_torch.render.integrator import trace_paths


def pass_backplate(scene, camera, width: int, height: int, p, gaze_x: int,
                   gaze_y: int) -> torch.Tensor:
    """Pixel-center probe radiance over the pass's launch grid (P, 3)."""
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


def frame_wavefront(scene, camera, gaze_x: int, gaze_y: int, key,
                    config: RenderConfig, schedule: FoveationSchedule,
                    sample_ids_per_pass=None):
    """Generate every pass's rays and trace them as one batch;
    ``sample_ids_per_pass`` narrows each pass to those of its sample slots
    (``parallel/tiles.py``). Returns (per-pass ray dicts, trace_paths
    output, per-pass offsets)."""
    w, h = config.width, config.height
    jitter_key = fold_in(key, 0)
    path_key = fold_in(key, 1)
    rays_list = [
        raygen.generate_pass_rays(
            camera, p, w, h, gaze_x, gaze_y, jitter_key,
            antialias=config.antialias, sampler=config.sampler,
            sample_ids=None if sample_ids_per_pass is None
            else sample_ids_per_pass[i])
        for i, p in enumerate(schedule.passes)
    ]
    merged = {
        k: torch.cat([r[k] for r in rays_list], dim=0)
        for k in ("origin", "direction", "active", "ray_ids")
    }
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


def composite_passes(scene, camera, gaze_x: int, gaze_y: int, subframe: int,
                     canvas: torch.Tensor, rays_list, slot_values,
                     config: RenderConfig, schedule: FoveationSchedule,
                     aov_canvas=None) -> int:
    """Composite every pass into ``canvas`` (in place) from its (P, spp, 3)
    slot values, summed over the slots here and nowhere else, so that every
    path that assembles the same values gets the same frame. Where
    ``aov_canvas`` maps AOV names to canvases, each pass's mean AOV goes
    into them too, always overwriting. Inner passes composite after outer
    ones and overwrite the ring overlap. Returns the rays of the frame."""
    w, h = config.width, config.height
    pad = film.schedule_padding(schedule, w, h)
    total_rays = 0
    for p, rays, v in zip(schedule.passes, rays_list, slot_values):
        lw, lh = rays["launch"]
        rad_sum = v["radiance"].sum(1)
        alpha_sum = v["alpha"].sum(1)
        backplate = pass_backplate(scene, camera, w, h, p, gaze_x, gaze_y)
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
        total_rays += lw * lh * p.spp
    return total_rays


def _trace_and_composite(scene, camera, gaze_x: int, gaze_y: int,
                         subframe: int, canvas: torch.Tensor, key,
                         config: RenderConfig, schedule: FoveationSchedule,
                         aov_canvas=None):
    """Trace the frame's wavefront and composite it into ``canvas`` (and
    the AOV canvases). Returns (trace_paths output, rays per frame)."""
    rays_list, out, offsets = frame_wavefront(
        scene, camera, gaze_x, gaze_y, key, config, schedule
    )
    fields = ("radiance", "alpha") + tuple(aov_canvas or ())
    total_rays = composite_passes(
        scene, camera, gaze_x, gaze_y, subframe, canvas, rays_list,
        pass_slot_values(rays_list, out, offsets, fields), config, schedule,
        aov_canvas)
    return out, total_rays


def render_frame(scene, camera, gaze_x: int, gaze_y: int, subframe: int,
                 canvas: torch.Tensor, key, config: RenderConfig,
                 schedule: FoveationSchedule):
    """One full frame -> (canvas, frame uint8 (H, W, 3), stats). The canvas
    is updated in place and returned."""
    out, total_rays = _trace_and_composite(
        scene, camera, gaze_x, gaze_y, subframe, canvas, key, config,
        schedule)
    pad = film.schedule_padding(schedule, config.width, config.height)
    frame = film.finalize(canvas, pad, config)
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
    out, _ = _trace_and_composite(
        scene, camera, gaze_x, gaze_y, subframe, canvas, key, config,
        schedule, aov_canvas)
    frame = film.finalize(canvas, pad, config)
    crop = lambda c: c[pad: pad + h, pad: pad + w]  # noqa: E731
    # a copy: later frames write the canvas in place
    aovs = {"accum": crop(canvas).clone(),
            **{name: crop(c) for name, c in aov_canvas.items()}}
    return canvas, frame, aovs, {"traces": out["traces"]}


class Renderer:
    """Stateful shell over ``render_frame``: camera, canvas, subframe, and
    an optional ``demand_loader`` (``models/demand.DemandLoader``) whose
    context the scene samples its textures through.

    ``multichip="samples"`` renders every frame over the devices of
    ``mesh`` (default ``parallel/tiles.make_mesh()``, every visible CUDA
    device; on a CPU renderer the one CPU), each tracing its slice of every
    pass's sample slots; ``"scene"`` also cuts ``tri_pack`` into one row
    block a device (``parallel/scene_shard.py``). Both give the
    single-device frame; ``render_aov`` stays on the renderer's device. A
    demand loader is refused with either."""

    def __init__(self, scene, config: RenderConfig = RenderConfig(),
                 schedule: Optional[FoveationSchedule] = None, seed: int = 0,
                 device="cuda", demand_loader=None,
                 multichip: Optional[str] = None, mesh=None):
        config.check_supported()
        self.device = torch.device(device)
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
        args = self._frame_args(gaze)
        if self.multichip:
            self.canvas, frame, traces = self._sharded_frame(*args)
            self._stats = {"traces": traces}
        else:
            self.canvas, frame, self._stats = render_frame(*args)
        self.subframe += 1
        self.last_frame = frame
        return frame.cpu().numpy()

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
        self.canvas, frame, aovs, self._stats = render_frame_aov(
            *self._frame_args(gaze))
        self.subframe += 1
        self.last_frame = frame
        return frame.cpu().numpy(), aovs

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
