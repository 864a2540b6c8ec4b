"""Checkpoint and resume of a progressive render (counterpart of the JAX
package's ``utils/checkpoint.py``; the same NPZ keys, so either package
reads the other's files).

A render's whole persistent state is the padded accumulation canvas and
the subframe index; with the camera and gaze beside them an accumulation
resumes exactly where it stopped.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera


def save_checkpoint(path: str, canvas, subframe: int,
                    camera: Optional[Camera] = None,
                    gaze: Optional[Tuple[int, int]] = None) -> None:
    if isinstance(canvas, torch.Tensor):
        canvas = canvas.cpu().numpy()
    data = {
        "canvas": np.asarray(canvas),
        "subframe": np.asarray(subframe, dtype=np.int64),
    }
    if camera is not None:
        data["camera"] = np.asarray(
            [*camera.eye, *camera.lookat, *camera.up, camera.fov_y,
             camera.aspect],
            dtype=np.float64,
        )
    if gaze is not None:
        data["gaze"] = np.asarray(gaze, dtype=np.int64)
    np.savez_compressed(path, **data)


def load_checkpoint(path: str) -> dict:
    """-> dict(canvas, subframe[, camera, gaze])."""
    with np.load(path) as z:
        out = {"canvas": z["canvas"], "subframe": int(z["subframe"])}
        if "camera" in z:
            c = z["camera"]
            out["camera"] = Camera(
                eye=tuple(float(x) for x in c[0:3]),
                lookat=tuple(float(x) for x in c[3:6]),
                up=tuple(float(x) for x in c[6:9]),
                fov_y=float(c[9]), aspect=float(c[10]),
            )
        if "gaze" in z:
            out["gaze"] = tuple(int(x) for x in z["gaze"])
    return out


def resume_renderer(renderer, path: str) -> None:
    """Restore a Renderer's canvas, subframe and (if saved) camera in
    place. The canvas must have the renderer's shape."""
    ckpt = load_checkpoint(path)
    canvas = torch.as_tensor(ckpt["canvas"], dtype=torch.float32,
                             device=renderer.device)
    if canvas.shape != renderer.canvas.shape:
        raise ValueError(
            f"checkpoint canvas {tuple(canvas.shape)} != renderer "
            f"{tuple(renderer.canvas.shape)}"
        )
    renderer.canvas = canvas
    renderer.subframe = ckpt["subframe"]
    if "camera" in ckpt:
        renderer.camera_params = ckpt["camera"].device_params(renderer.device)


def checkpoint_renderer(renderer, path: str,
                        camera: Optional[Camera] = None,
                        gaze: Optional[Tuple[int, int]] = None) -> None:
    save_checkpoint(path, renderer.canvas, renderer.subframe, camera, gaze)


@dataclasses.dataclass
class AutoCheckpointer:
    """Checkpoint a long progressive render every ``every`` subframes."""

    path: str
    every: int = 32

    def maybe(self, renderer) -> bool:
        """Write ``path`` when the renderer's subframe is a positive
        multiple of ``every``; True when it wrote."""
        if renderer.subframe > 0 and renderer.subframe % self.every == 0:
            checkpoint_renderer(renderer, self.path)
            return True
        return False
