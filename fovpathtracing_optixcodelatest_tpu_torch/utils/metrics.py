"""Telemetry: per-phase frame timers, FPS stats, TSV logging, and the SSIM
of the golden-image checks (the port's own copy of the JAX package's
``utils/metrics.py``).

Twin of the reference's observability stack (SURVEY.md §5.1/§5.5):
- ``FrameTimers`` — the state-update / render / display chrono accumulation of
  the main loop (main.cpp:399-431) with the rolling averages displayStats
  shows (sutil.cpp:763-801).
- ``TsvLogger`` — the SAVE_DATA_ON TSV appenders (sutil.cpp:806-823 and the
  archived PT_sv4 benchmark tables, BASELINE.md) with the same per-frame
  schema: frame index, phase times (ms), fps, gaze x/y, subframe index.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np


class FrameTimers:
    """Accumulating phase timers with rolling display averages."""

    PHASES = ("state_update", "render", "display")

    def __init__(self, avg_window: int = 20):
        self.avg_window = avg_window
        self.history: Dict[str, List[float]] = {p: [] for p in self.PHASES}
        self._start: Dict[str, float] = {}
        self.frame_count = 0
        self._frame_t0: Optional[float] = None
        self.fps_history: List[float] = []

    def begin(self, phase: str) -> None:
        self._start[phase] = time.perf_counter()

    def end(self, phase: str) -> float:
        dt = time.perf_counter() - self._start.pop(phase)
        self.history[phase].append(dt)
        return dt

    def frame_done(self) -> None:
        now = time.perf_counter()
        if self._frame_t0 is not None:
            self.fps_history.append(1.0 / max(now - self._frame_t0, 1e-9))
        self._frame_t0 = now
        self.frame_count += 1

    def averages_ms(self) -> Dict[str, float]:
        out = {}
        for p in self.PHASES:
            window = self.history[p][-self.avg_window :]
            out[p] = 1000.0 * float(np.mean(window)) if window else 0.0
        return out

    @property
    def fps(self) -> float:
        window = self.fps_history[-self.avg_window :]
        return float(np.mean(window)) if window else 0.0

    def stats_line(self, gaze=(0, 0), subframe: int = 0) -> str:
        """The displayStats overlay content as one line (sutil.cpp:785-801)."""
        avg = self.averages_ms()
        return (
            f"fps: {self.fps:6.2f} | state: {avg['state_update']:.2f} ms | "
            f"render: {avg['render']:.2f} ms | display: {avg['display']:.2f} ms"
            f" | gaze: {gaze[0]},{gaze[1]} | subframe: {subframe}"
        )


class TsvLogger:
    """Per-frame TSV appender (schema of the §6 archived benchmark tables)."""

    COLUMNS = (
        "frame", "state_ms", "render_ms", "display_ms", "fps",
        "gaze_x", "gaze_y", "subframe",
    )

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "w")
        self._fh.write("\t".join(self.COLUMNS) + "\n")

    def log(self, timers: FrameTimers, gaze=(0, 0), subframe: int = 0) -> None:
        avg = {
            p: (1000.0 * timers.history[p][-1] if timers.history[p] else 0.0)
            for p in FrameTimers.PHASES
        }
        row = (
            timers.frame_count,
            round(avg["state_update"], 3),
            round(avg["render"], 3),
            round(avg["display"], 3),
            round(timers.fps_history[-1] if timers.fps_history else 0.0, 3),
            gaze[0], gaze[1], subframe,
        )
        self._fh.write("\t".join(str(x) for x in row) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Separable box filter via cumsum (valid region handled by edge pad)."""
    pad = size // 2
    xp = np.pad(x, ((pad, pad), (pad, pad)) + ((0, 0),) * (x.ndim - 2),
                mode="edge")
    c = np.cumsum(xp, axis=0)
    c = np.concatenate([c[size - 1: size], c[size:] - c[:-size]], axis=0)
    c2 = np.cumsum(c, axis=1)
    c2 = np.concatenate([c2[:, size - 1: size], c2[:, size:] - c2[:, :-size]],
                        axis=1)
    return c2 / (size * size)


def ssim(a: np.ndarray, b: np.ndarray, window: int = 7,
         data_range: float = 1.0) -> float:
    """Mean SSIM between two images (H, W[, C]) in [0, data_range]."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _uniform_filter(a, window)
    mu_b = _uniform_filter(b, window)
    var_a = _uniform_filter(a * a, window) - mu_a**2
    var_b = _uniform_filter(b * b, window) - mu_b**2
    cov = _uniform_filter(a * b, window) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    return float(np.mean(num / den))
