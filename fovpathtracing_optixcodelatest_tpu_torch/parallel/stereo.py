"""Stereo (XR) rendering: two eyes over one scene (counterpart of the JAX
package's ``parallel/stereo.py``, after the reference's OpenXR sample and
its per-view loop).

``eye_cameras_from_pose`` builds the eyes from a head pose and the IPD,
standing in for the per-eye poses an XR runtime reports;
``camera_from_fov_angles`` builds an asymmetric frustum from XrFovf-style
half angles. ``StereoRenderer`` renders the two eyes one after the other
through ``render_frame``, each with its own canvas and accumulation, eye
``e`` of subframe ``s`` keyed fold_in(fold_in(PRNGKey(0), s), e) as in the
JAX package. (The JAX package runs both eyes as one vmapped program; here
the two eyes are two wavefronts.) Each eye's ``render_frame`` is the span
``fov.eye.<e>`` inside the pair's ``fov.frame`` (``utils/tracing.py``).
Each eye's pixels are copied into its half of the pair's host array as
soon as the eye is queued; on the card that array is page-locked, so the
copies run on the copy engine without the host and the pair's
``download`` waits once, for the right eye's tail. (On an H100 a pageable
copy of a 1800x1920 pair, 20.7 MB, took 1.75 to 13.5 ms of the copy engine
from one profiled run to the next; the page-locked copies take 0.41 ms.)
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from fovpathtracing_optixcodelatest_tpu_torch.config import (
    FoveationSchedule,
    RenderConfig,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.camera import (
    Camera,
    CameraParams,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import fold_in, prng_key
from fovpathtracing_optixcodelatest_tpu_torch.render import film
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
    render_frame,
)
from fovpathtracing_optixcodelatest_tpu_torch.utils import tracing


def eye_cameras_from_pose(
    position, forward, up=(0.0, 1.0, 0.0), ipd: float = 0.064,
    fov_y: float = 90.0, aspect: float = 1.0, focus_distance: float = 10.0,
) -> Tuple[Camera, Camera]:
    """Left and right eye cameras: the eyes ±ipd/2 along the view's right
    axis, both aimed at the point ``focus_distance`` ahead."""
    p = np.asarray(position, dtype=np.float64)
    f = np.asarray(forward, dtype=np.float64)
    f = f / np.linalg.norm(f)
    u = np.asarray(up, dtype=np.float64)
    right = np.cross(f, u)
    right /= np.linalg.norm(right)
    target = p + f * focus_distance
    eyes = []
    for sign in (-1.0, +1.0):
        eye = p + sign * 0.5 * ipd * right
        eyes.append(Camera(eye=tuple(eye), lookat=tuple(target), up=tuple(u),
                           fov_y=fov_y, aspect=aspect))
    return eyes[0], eyes[1]


def camera_from_fov_angles(
    eye, forward, up, angle_left: float, angle_right: float,
    angle_up: float, angle_down: float, device="cuda",
) -> CameraParams:
    """An asymmetric-frustum camera from half angles in radians: the UVW
    frame is sheared so that NDC ±1 reach the four tangents."""
    f = np.asarray(forward, dtype=np.float64)
    f /= np.linalg.norm(f)
    u_axis = np.cross(f, np.asarray(up, dtype=np.float64))
    u_axis /= np.linalg.norm(u_axis)
    v_axis = np.cross(u_axis, f)
    tl, tr = math.tan(angle_left), math.tan(angle_right)
    tu, td = math.tan(angle_up), math.tan(angle_down)
    half_x = 0.5 * (tr - tl)
    half_y = 0.5 * (tu - td)
    center_x = 0.5 * (tr + tl)
    center_y = 0.5 * (tu + td)
    w = f + center_x * u_axis + center_y * v_axis
    t = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, dtype=np.float32), device=device)
    return CameraParams(eye=t(eye), u=t(half_x * u_axis),
                        v=t(half_y * v_axis), w=t(w))


class StereoRenderer:
    """Two-eye foveated renderer with independent accumulation per eye."""

    def __init__(self, scene, config: RenderConfig,
                 schedule: FoveationSchedule, device="cuda"):
        self.scene = scene
        self.config = config
        self.schedule = schedule
        self.device = torch.device(device)
        self._pad = film.schedule_padding(schedule, config.width,
                                          config.height)
        self.canvases = [film.new_canvas(config.width, config.height,
                                         self._pad, self.device)
                         for _ in range(2)]
        self.subframe = 0
        self._key = prng_key(0)
        self.stats: dict = {}

    def eye_key(self, eye: int):
        """The key of ``eye`` (0 left, 1 right) at the current subframe."""
        return fold_in(fold_in(self._key, self.subframe), eye)

    def render(self, left: Camera, right: Camera,
               gaze: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Render both eyes -> (2, H, W, 3) uint8. ``stats`` gets the
        pair's ``traces`` and ``rays``."""
        w, h = self.config.width, self.config.height
        if gaze is None:
            gaze = (w // 2, h // 2)
        cuda = self.device.type == "cuda"
        pixels = torch.empty((2, h, w, 3), dtype=torch.uint8, pin_memory=cuda)
        traces, rays = 0, 0
        with tracing.frame():  # the pair is one displayed frame
            for e, cam in enumerate((left, right)):
                with tracing.eye(e):
                    self.canvases[e], frame, st = render_frame(
                        self.scene, cam.device_params(self.device), gaze[0],
                        gaze[1], self.subframe, self.canvases[e],
                        self.eye_key(e), self.config, self.schedule)
                pixels[e].copy_(frame, non_blocking=cuda)
                traces = traces + st["traces"]
                rays += st["rays"]
            with tracing.sync("download"):
                if cuda:
                    torch.cuda.current_stream(self.device).synchronize()
            with tracing.sync("traces"):
                self.stats = {"traces": int(traces), "rays": rays}
            self.subframe += 1
            return pixels.numpy()
