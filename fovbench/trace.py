"""The reduction of a ``torch.profiler`` trace (its Chrome trace JSON) to
what the per-layer metrics read: device intervals (kernels, copies, sets),
their union against the traced window, and the window's idle gaps labelled
by the host operation running at each gap's middle.

Where the trace records host ops, the traced window runs from the start of
the first ``FRAME_SPAN`` to the end of the last: the benchmark's own
``record_function`` span around each displayed frame's render call. A
trace of the device's activity alone has no spans: then every device event
in it belongs to the traced frames, and the window's length is the host
clock's over them (``window_s``).
"""

from __future__ import annotations

from collections import defaultdict

FRAME_SPAN = "fovbench.frame"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CAT = "cpu_op"
SPAN_CAT = "user_annotation"


class Trace:
    """Times in seconds from the trace's own microsecond clock."""

    def __init__(self, chrome: dict, frames: int | None = None,
                 window_s: float | None = None):
        events = [e for e in chrome.get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
        spans = [e for e in events if e.get("cat") == SPAN_CAT
                 and e.get("name") == FRAME_SPAN]
        device = [(e["name"], e["cat"], float(e["ts"]) * 1e-6,
                   float(e["dur"]) * 1e-6)
                  for e in events if e.get("cat") in DEVICE_CATS]
        if spans:
            self.frames = len(spans)
            self.start = min(float(e["ts"]) for e in spans) * 1e-6
            self.end = max(float(e["ts"]) + float(e["dur"])
                           for e in spans) * 1e-6
            device = [d for d in device if self.start <= d[2] < self.end]
        elif frames is None or window_s is None:
            raise ValueError(f"no {FRAME_SPAN} span in the trace, and no "
                             "frame count and window given")
        else:
            self.frames = frames
            self.start = min((d[2] for d in device), default=0.0)
            self.end = max((d[2] + d[3] for d in device), default=0.0)
        self.device = device
        self._window_s = window_s
        self.host = sorted(
            (float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e["dur"])) * 1e-6,
             e["name"]) for e in events if e.get("cat") == HOST_CAT)

    @property
    def window_s(self) -> float:
        """The host clock's seconds over the traced frames where given, else
        the frame spans'."""
        return self._window_s if self._window_s is not None \
            else self.end - self.start

    def kernels(self):
        """(name, seconds) of every kernel in the window."""
        return [(n, d) for n, c, _, d in self.device if c == "kernel"]

    def busy_intervals(self):
        """The union of the device intervals, clipped to the window."""
        spans = sorted((max(s, self.start), min(s + d, self.end))
                       for _, _, s, d in self.device)
        out = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def device_ops(self, top: int = 10):
        """The device operations by total time, the most first."""
        tot = defaultdict(float)
        for name, _, _, d in self.device:
            tot[name] += d
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:top]

    def _labels(self, times):
        """The innermost host operation running at each of the sorted
        ``times``: one sweep over the ops in start order with a stack of
        the ones open (a thread's ops nest)."""
        out, stack, j = [], [], 0
        for t in times:
            while j < len(self.host) and self.host[j][0] <= t:
                while stack and stack[-1][1] < self.host[j][0]:
                    stack.pop()
                stack.append(self.host[j])
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out.append(stack[-1][2] if stack else "host outside any op")
        return out

    def idle_gaps(self, top: int = 10):
        """Idle seconds in the window by the host operation at each gap's
        middle, the most first."""
        gaps, prev = [], self.start
        for a, b in self.busy_intervals() + [[self.end, self.end]]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        tot = defaultdict(float)
        labels = self._labels([0.5 * (a + b) for a, b in gaps])
        for (a, b), name in zip(gaps, labels):
            tot[name] += b - a
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:top]
