"""The Renderer front end (counterpart of the JAX package's
``render/renderer.py``): ``render_frame`` traces every foveation pass as one
merged wavefront and composites the passes into the accumulation canvas;
``render_frame_aov`` adds the normal and albedo AOV images; ``Renderer``
carries the canvas, the subframe index and the camera between frames, and,
given a ``DemandLoader``, pages the textures its frames request in between
frames (``process_demand_requests``).

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


def frame_wavefront(scene, camera, gaze_x: int, gaze_y: int, key,
                    config: RenderConfig, schedule: FoveationSchedule):
    """Generate every pass's rays and trace them as one batch. Returns
    (per-pass ray dicts, trace_paths output, per-pass offsets)."""
    w, h = config.width, config.height
    jitter_key = fold_in(key, 0)
    path_key = fold_in(key, 1)
    rays_list = [
        raygen.generate_pass_rays(camera, p, w, h, gaze_x, gaze_y, jitter_key,
                                  antialias=config.antialias,
                                  sampler=config.sampler)
        for p in schedule.passes
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


def _trace_and_composite(scene, camera, gaze_x: int, gaze_y: int,
                         subframe: int, canvas: torch.Tensor, key,
                         config: RenderConfig, schedule: FoveationSchedule,
                         aov_canvas=None):
    """Trace the frame's wavefront and composite every pass into
    ``canvas`` (in place), and, where ``aov_canvas`` maps AOV names to
    canvases, each pass's mean AOV into them, always overwriting. Inner
    passes composite after outer ones and overwrite the ring overlap.
    Returns (trace_paths output, rays per frame)."""
    w, h = config.width, config.height
    pad = film.schedule_padding(schedule, w, h)
    rays_list, out, offsets = frame_wavefront(
        scene, camera, gaze_x, gaze_y, key, config, schedule
    )
    total_rays = 0
    for p, rays, ofs in zip(schedule.passes, rays_list, offsets):
        lw, lh = rays["launch"]
        k = rays["samples_here"]
        n_pix = lw * lh
        sl = slice(ofs, ofs + n_pix * k)
        rad_sum = out["radiance"][sl].reshape(n_pix, k, 3).sum(1)
        alpha_sum = out["alpha"][sl].reshape(n_pix, k, 3).sum(1)
        backplate = pass_backplate(scene, camera, w, h, p, gaze_x, gaze_y)
        accum_color = film.shade_to_accum_color(
            rad_sum, alpha_sum, backplate, p.spp, rays["launch"]
        )
        film.composite_pass(canvas, accum_color, rays["ring"], p,
                            rays["offset"], subframe, pad, config.accumulate)
        overwrite = dataclasses.replace(p, redraw=True)
        for name, target in (aov_canvas or {}).items():
            img = (out[name][sl].reshape(n_pix, k, 3).sum(1) / p.spp
                   ).reshape(lh, lw, 3)
            film.composite_pass(target, img, rays["ring"], overwrite,
                                rays["offset"], subframe, pad, False)
        total_rays += n_pix * p.spp
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
    context the scene samples its textures through."""

    def __init__(self, scene, config: RenderConfig = RenderConfig(),
                 schedule: Optional[FoveationSchedule] = None, seed: int = 0,
                 device="cuda", demand_loader=None):
        config.check_supported()
        self.device = torch.device(device)
        if scene.device.type != self.device.type:
            raise ValueError(
                f"scene lies on {scene.device}, renderer on {self.device}"
            )
        self.demand_loader = demand_loader
        if demand_loader is not None:
            scene = scene.with_demand(demand_loader.launch_prepare())
        self.scene = scene
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
        self.canvas, frame, self._stats = render_frame(
            *self._frame_args(gaze))
        self.subframe += 1
        self.last_frame = frame
        return frame.cpu().numpy()

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
