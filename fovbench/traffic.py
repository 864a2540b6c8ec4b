"""The one traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and gives, for every displayed frame, where the eye
looks, for a display of one or two eyes.

Keys of a mix:

- ``display``: ``"mono"`` (one image a frame, ``Renderer.render``) or
  ``"stereo"`` (a pair of eyes a frame, ``StereoRenderer.render``), with
  ``ipd`` and ``fov_y`` for the eyes;
- ``gaze``: ``{"kind": "fixed", "at": [fx, fy]}`` (a fraction of the
  frame), or ``{"kind": "saccade", "start": [fx, fy], "refresh_hz": r,
  "fixation_ms": {"mean": m, "shape": k}, "amplitude_deg": {"mean": m,
  "shape": k}}``: fixations whose durations are drawn in milliseconds from
  a gamma distribution of that mean and shape and held for as many frames
  of a display refreshing at ``r`` Hz, each followed by a saccade whose
  amplitude is drawn in degrees the same way, in a uniform direction,
  converted to pixels through the eye's focal length (``fov_y`` over the
  frame's height), and mirrored back into the frame along an axis it would
  leave by (then clipped to the frame);
- ``warmup_frames``: frames rendered in set-up, before the window.

The head is the configuration's camera, held still. Frame ``f`` of a run
(warm-up frames first) is the renderer's subframe ``f``; the gaze of every
frame follows from the seed alone. A run's frames follow each other as fast
as the program renders them, so a fixation lasts its frames, not its
milliseconds, of the run's clock.
"""

from __future__ import annotations

import json
import os

import numpy as np

SEQUENCE = 100_000  # frames a saccade sequence is drawn for, far past any run


def load(root: str, name: str) -> dict:
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        return json.load(f)


class Traffic:
    def __init__(self, spec: dict, seed: int, width: int, height: int,
                 fov_y: float | None = None):
        self.spec = spec
        self.display = spec["display"]
        self.eyes = 2 if self.display == "stereo" else 1
        self.warmup = int(spec["warmup_frames"])
        self.width, self.height = width, height
        self.fov_y = spec.get("fov_y", fov_y)
        g = spec["gaze"]
        if g["kind"] == "fixed":
            self._fixed = self._px(g["at"])
            self._path = None
        elif g["kind"] == "saccade":
            self._path = self._saccades(g, seed)
        else:
            raise ValueError(f"gaze kind {g['kind']!r}")

    def _px(self, frac):
        return (int(frac[0] * self.width), int(frac[1] * self.height))

    @property
    def px_per_radian(self) -> float:
        """The eye's focal length in pixels."""
        return 0.5 * self.height / np.tan(np.radians(self.fov_y) / 2.0)

    def _saccades(self, g: dict, seed: int) -> np.ndarray:
        rs = np.random.default_rng([int(seed), 0x5ACC])
        fix, amp = g["fixation_ms"], g["amplitude_deg"]
        frame_ms = 1000.0 / g["refresh_hz"]
        pos = np.asarray(self._px(g["start"]), dtype=np.float64)
        hi = np.asarray([self.width - 1, self.height - 1], dtype=np.float64)
        path, total = [], 0
        while total < SEQUENCE:
            ms = rs.gamma(fix["shape"], fix["mean"] / fix["shape"])
            frames = max(1, int(np.rint(ms / frame_ms)))
            path.append(np.repeat(np.rint(pos)[None], frames, axis=0))
            total += frames
            deg = rs.gamma(amp["shape"], amp["mean"] / amp["shape"])
            ang = rs.uniform(0.0, 2.0 * np.pi)
            step = (self.px_per_radian * np.tan(np.radians(deg))
                    * np.asarray([np.cos(ang), np.sin(ang)]))
            land = pos + step
            out = (land < 0.0) | (land > hi)
            pos = np.clip(np.where(out, pos - step, land), 0.0, hi)
        return np.concatenate(path)[:SEQUENCE].astype(np.int64)

    def gaze(self, frame: int):
        """The gaze of displayed frame ``frame`` as integer pixels."""
        if self._path is None:
            return self._fixed
        x, y = self._path[frame]
        return int(x), int(y)
