"""Pinhole camera with the UVW frame convention of the JAX package's
``models/camera.py``: W = lookat - eye (|W| is the focal length),
U = normalize(W x up) * |V| * aspect, V = normalize(U x W) * |W| * tan(fov/2);
and the viewer's ``Trackball`` orbit."""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    eye: Tuple[float, float, float]
    lookat: Tuple[float, float, float]
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov_y: float = 45.0  # degrees
    aspect: float = 1.0

    def uvw_frame(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        eye = np.asarray(self.eye, dtype=np.float64)
        lookat = np.asarray(self.lookat, dtype=np.float64)
        up = np.asarray(self.up, dtype=np.float64)
        w = lookat - eye
        wlen = np.linalg.norm(w)
        u = np.cross(w, up)
        u /= np.linalg.norm(u)
        v = np.cross(u, w)
        v /= np.linalg.norm(v)
        vlen = wlen * math.tan(0.5 * math.radians(self.fov_y))
        v = v * vlen
        u = u * (vlen * self.aspect)
        return u.astype(np.float32), v.astype(np.float32), w.astype(np.float32)

    def device_params(self, device="cuda") -> "CameraParams":
        u, v, w = self.uvw_frame()
        t = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, dtype=np.float32), device=device
        )
        return CameraParams(eye=t(self.eye), u=t(u), v=t(v), w=t(w))


@dataclasses.dataclass(frozen=True)
class CameraParams:
    eye: torch.Tensor  # (3,)
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor


@dataclasses.dataclass
class Trackball:
    """Latitude/longitude orbit around a reference frame (the JAX package's
    ``Trackball``, float64 numpy): latitude held inside (-90, 90) degrees,
    longitude wraps, a wheel tick scales the eye-lookat distance by 0.9.
    ``view_mode`` "lookat_fixed" orbits the eye around the lookat point;
    "eye_fixed" pivots the lookat around a fixed eye (first person)."""

    camera: Camera
    latitude: float = 0.0  # radians
    longitude: float = 0.0  # radians
    move_speed: float = 10.0
    view_mode: str = "lookat_fixed"  # or "eye_fixed"
    # the reference frame: x = (1, 0, 0), y = (0, 0, 1), z = (0, 1, 0)
    frame_u: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    frame_v: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    frame_w: Tuple[float, float, float] = (0.0, 1.0, 0.0)

    def reinitialize_from_camera(self) -> None:
        """Set the angles from the camera's eye-lookat direction."""
        eye = np.asarray(self.camera.eye, dtype=np.float64)
        lookat = np.asarray(self.camera.lookat, dtype=np.float64)
        d = eye - lookat
        r = np.linalg.norm(d)
        if r < 1e-12:
            return
        u = np.asarray(self.frame_u)
        v = np.asarray(self.frame_v)
        w = np.asarray(self.frame_w)
        dn = d / r
        self.latitude = math.asin(float(np.clip(np.dot(dn, w), -1.0, 1.0)))
        self.longitude = math.atan2(float(np.dot(dn, v)),
                                    float(np.dot(dn, u)))

    def _dir_from_angles(self) -> np.ndarray:
        u = np.asarray(self.frame_u)
        v = np.asarray(self.frame_v)
        w = np.asarray(self.frame_w)
        cl, sl = math.cos(self.latitude), math.sin(self.latitude)
        co, so = math.cos(self.longitude), math.sin(self.longitude)
        return cl * co * u + cl * so * v + sl * w

    def orbit(self, dx: float, dy: float) -> Camera:
        """Rotate by screen-space deltas in pixels -> the updated camera."""
        self.longitude = (self.longitude - 0.005 * dx) % (2 * math.pi)
        self.latitude = float(np.clip(self.latitude + 0.005 * dy,
                                      -0.5 * math.pi + 1e-3,
                                      0.5 * math.pi - 1e-3))
        eye = np.asarray(self.camera.eye, dtype=np.float64)
        lookat = np.asarray(self.camera.lookat, dtype=np.float64)
        radius = float(np.linalg.norm(eye - lookat))
        dirn = self._dir_from_angles()
        if self.view_mode == "eye_fixed":
            self.camera = dataclasses.replace(
                self.camera, lookat=tuple(map(float, eye - radius * dirn)))
        else:
            self.camera = dataclasses.replace(
                self.camera, eye=tuple(map(float, lookat + radius * dirn)))
        return self.camera

    def zoom(self, direction: int) -> Camera:
        """One wheel tick: the eye-lookat distance times 0.9 (``direction``
        > 0) or 1/0.9. lookat_fixed moves the eye, eye_fixed the lookat."""
        eye = np.asarray(self.camera.eye, dtype=np.float64)
        lookat = np.asarray(self.camera.lookat, dtype=np.float64)
        scale = 0.9 if direction > 0 else 1.0 / 0.9
        if self.view_mode == "eye_fixed":
            self.camera = dataclasses.replace(
                self.camera,
                lookat=tuple(map(float, eye + (lookat - eye) * scale)))
        else:
            self.camera = dataclasses.replace(
                self.camera,
                eye=tuple(map(float, lookat + (eye - lookat) * scale)))
        return self.camera
