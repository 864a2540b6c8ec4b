"""Pinhole camera with the UVW frame convention of the JAX package's
``models/camera.py``: W = lookat - eye (|W| is the focal length),
U = normalize(W x up) * |V| * aspect, V = normalize(U x W) * |W| * tan(fov/2)."""

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
