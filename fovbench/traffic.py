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
  "shape": k}, "tour": {"saccades": s, "seed": t}}``: a closed tour of
  fixations, the same for every run's seed. From ``start`` it makes ``s``
  saccades out and the same ``s`` back (``2 s`` fixations a round). Each
  fixation is held for one of ``2 s`` durations, and each saccade out has
  one of ``s`` amplitudes: the midpoints of as many equal slices of a gamma
  distribution of that mean and shape (milliseconds, held for as many
  frames of a display refreshing at ``r`` Hz; degrees, converted to pixels
  through the eye's focal length, ``fov_y`` over the frame's height). Their
  order and the saccades' directions (uniform) are drawn from the tour's
  own seed ``t``; a saccade that would leave the frame is mirrored back
  along that axis (then clipped to the frame);
- ``warmup_frames``: frames rendered in set-up, before the window.

The head is the configuration's camera, held still. Frame ``f`` of a run
(warm-up frames first) is the renderer's subframe ``f``. A run's seed only
picks the frame of the tour at which it starts: every seed renders the same
fixations, each as often, so that the seed does not change how much work a
window holds (where the fovea lies sets how many of its lanes hit the scene).
A run's frames follow each other as fast as the program renders them, so a
fixation lasts its frames, not its milliseconds, of the run's clock.
"""

from __future__ import annotations

import json
import os

import numpy as np

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
        """The tour's frames, one gaze (integer pixels) a frame, rotated so
        that the run starts at a frame of it drawn from ``seed``."""
        tour = g["tour"]
        out = int(tour["saccades"])
        rs = np.random.default_rng([int(tour["seed"]), 0x5ACC])
        held = rs.permutation(_slices(rs, g["fixation_ms"], 2 * out))
        deg = rs.permutation(_slices(rs, g["amplitude_deg"], out))
        ang = rs.uniform(0.0, 2.0 * np.pi, out)
        pos = np.asarray(self._px(g["start"]), dtype=np.float64)
        hi = np.asarray([self.width - 1, self.height - 1], dtype=np.float64)
        stops = [np.rint(pos)]
        for d, a in zip(deg, ang):
            step = (self.px_per_radian * np.tan(np.radians(d))
                    * np.asarray([np.cos(a), np.sin(a)]))
            land = pos + step
            off = (land < 0.0) | (land > hi)
            pos = np.clip(np.where(off, pos - step, land), 0.0, hi)
            stops.append(np.rint(pos))
        stops += stops[-2:0:-1]  # and back to the one before the start
        frame_ms = 1000.0 / g["refresh_hz"]
        frames = [max(1, int(np.rint(ms / frame_ms))) for ms in held]
        path = np.concatenate([np.repeat(p[None], n, axis=0)
                               for p, n in zip(stops, frames)])
        start = np.random.default_rng([int(seed), 0x5ACC]).integers(len(path))
        return np.roll(path, -int(start), axis=0).astype(np.int64)

    def gaze(self, frame: int):
        """The gaze of displayed frame ``frame`` as integer pixels."""
        if self._path is None:
            return self._fixed
        x, y = self._path[frame % len(self._path)]
        return int(x), int(y)


def _slices(rs, dist: dict, n: int) -> np.ndarray:
    """The midpoints of ``n`` equal slices of the gamma distribution of
    ``dist``'s mean and shape, read off a large sample drawn from ``rs``."""
    sample = rs.gamma(dist["shape"], dist["mean"] / dist["shape"], 200_000)
    return np.quantile(sample, (np.arange(n) + 0.5) / n)
