"""Readings of the port's own spans and counters
(``fovpathtracing_optixcodelatest_tpu_torch/utils/tracing.py``): what a
frame's host syncs, its integrator's host time and its live lanes come to,
and where in the frame the device idles.

``per_frame(counters)`` reduces a counter table (the port's ``snapshot()``,
or the ``diff`` of two) to a displayed frame's syncs, wait at the syncs,
integrator host time, live-lane share and spanned time. ``idle_by_span``
puts each idle gap of a profiled run's device down to the innermost
``fov.*`` span open at its middle. A port without the tracing module (an
older commit) has nothing to read: ``port_counters()`` gives None there.

    python3 -m fovbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell once through ``harness.run_cell`` with ``--trace 1``, as
``run.py`` does, and prints one JSON line: the run's ``correct`` and
per-layer metrics, its window's ``frame_ms`` and ``per_frame`` readings
from the port's counters over the window, and the idle seconds a frame,
by span, of the traced frames with host ops.
"""

from __future__ import annotations

import copy

from fovbench.trace import Trace

SYNC_PREFIX = "fov.sync."
# the integrator-and-shading layer's spans, by name or prefix: ray
# generation, the paths' set-up and output, each bounce's shading and
# compaction outside K1, K2 and the syncs, the film, the tone map
INTEGRATOR = ("fov.raygen", "fov.paths", "fov.bounce.", "fov.film",
              "fov.tonemap")
OUTSIDE = "host outside any op"  # ``Trace.idle_gaps``' label there


def port_counters() -> dict | None:
    """The port's counters since the process started, or None where the
    port keeps none."""
    try:
        from fovpathtracing_optixcodelatest_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def is_integrator(name: str) -> bool:
    return any(name == s or (s.endswith(".") and name.startswith(s))
               for s in INTEGRATOR)


def per_frame(c: dict) -> dict:
    """A displayed frame's readings from counter table ``c``: host syncs,
    host milliseconds waiting in them, integrator host milliseconds (self
    time), the live lanes' share of ``lanes[0]`` times the depths counted
    (in percent), and milliseconds inside ``fov.frame``. Empty without a
    frame."""
    frames = c.get("frames", 0)
    if not frames:
        return {}
    ms = 1e-6 / frames
    out = {
        "host_syncs_per_frame": sum(c["syncs"].values()) / frames,
        "sync_wait_ms": ms * sum(v for k, v in c["ns_total"].items()
                                 if k.startswith(SYNC_PREFIX)),
        "integrator_host_ms": ms * sum(v for k, v in c["ns"].items()
                                       if is_integrator(k)),
        "frame_span_ms": ms * c["ns_total"].get("fov.frame", 0),
    }
    lanes = c["lanes"]
    if lanes.get(0):
        out["lanes_alive_share"] = (100.0 * sum(lanes.values())
                                    / (lanes[0] * len(lanes)))
    return out


def fov_spans(chrome: dict) -> list:
    """The ``fov.*`` spans of a Chrome trace as (start s, end s, name),
    in start order, the outer first of two that start together."""
    spans = [(float(e["ts"]) * 1e-6,
              (float(e["ts"]) + float(e["dur"])) * 1e-6, e["name"])
             for e in chrome.get("traceEvents", [])
             if e.get("ph") == "X" and "dur" in e
             and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("fov.")]
    return sorted(spans, key=lambda s: (s[0], -s[1]))


def idle_by_span(tr: Trace, spans: list) -> dict:
    """Idle seconds of the device in ``tr``'s traced frames by the
    innermost of ``spans`` (``fov_spans``) open at each gap's middle:
    ``Trace.idle_gaps`` with the spans in place of the host ops."""
    t = copy.copy(tr)
    t.host = spans
    return dict(t.idle_gaps(top=None))


def idle_in_integrator_share(idle: dict) -> float | None:
    """The integrator spans' part of ``idle_by_span``'s seconds, in
    percent; None where the trace has no ``fov.*`` span."""
    total = sum(idle.values())
    if not total or set(idle) <= {OUTSIDE}:
        return None
    return 100.0 * sum(v for k, v in idle.items()
                       if is_integrator(k)) / total


def window_readings(root: str, workload: str, seed: int, seconds: float,
                    device: str = "cuda") -> dict:
    """Run cell ``workload`` of the benchmark tree at ``root`` once, traced
    (``harness.run_cell``), and read the port's counters over its window
    and the ``fov.*`` spans of its traced frames with host ops."""
    from fovbench import harness
    from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
    from fovpathtracing_optixcodelatest_tpu_torch.utils import tracing

    marks, traced = [], []

    def mark():
        marks.append((tracing.snapshot(), dict(kernel_build.LAUNCHES)))

    class Program(harness._Program):
        def render(self, frame):
            if frame == self.tr.warmup:  # the window's first frame
                mark()
            return super().render(frame)

    class Kept(Trace):
        def __init__(self, chrome, *args, **kwargs):
            super().__init__(chrome, *args, **kwargs)
            self.fov = fov_spans(chrome)
            traced.append(self)

    real = harness._Program, harness.Trace, harness._traced_frames

    def traced_frames(*args):
        if len(marks) == 1:  # the window's end
            mark()
        return real[2](*args)

    harness._Program, harness.Trace, harness._traced_frames = (
        Program, Kept, traced_frames)
    try:
        res, info = harness.run_cell(root, workload, seed, seconds, True,
                                     device)
    finally:
        harness._Program, harness.Trace, harness._traced_frames = real
    (a, launched), (b, launching) = marks
    window = tracing.diff(a, b)
    host = traced[-1]  # the second traced pass: host ops and spans
    idle = idle_by_span(host, host.fov)
    return {
        "workload": workload, "seed": seed, "card": info["card"],
        "correct": res["correct"], "window_frames": info["window_frames"],
        "frame_ms": info["frame_ms"], **per_frame(window),
        "syncs": window["syncs"], "lanes": window["lanes"],
        "launches": {k: v - launched.get(k, 0) for k, v in launching.items()
                     if v != launched.get(k, 0)},
        "traced_frame_ms": info["traced_frame_ms"],
        "metrics": {k: v["value"] for k, v in res["metrics"].items()},
        "idle_in_integrator_share": idle_in_integrator_share(idle),
        "idle_ms_per_frame": {k: v * 1e3 / host.frames for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])},
    }


def main(argv=None) -> int:
    import argparse
    import json
    import os

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.abspath(__file__))
    print(json.dumps(window_readings(root, args.workload, args.seed,
                                     args.seconds, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
