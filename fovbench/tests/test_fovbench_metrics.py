"""Each per-layer metric's arithmetic on a small recorded profiler trace
(``data/trace_small.json``: two traced frames of 10 ms, three kernels, a
copy and the host ops around them; hand-checked numbers below)."""

import json
import os

import pytest

from conftest import BENCH
from fovbench import harness, peaks
from fovbench.trace import Trace

DATA = os.path.join(os.path.dirname(__file__), "data", "trace_small.json")


@pytest.fixture
def ctx():
    with open(DATA) as f:
        tr = Trace(json.load(f))
    return harness.Context(trace=tr, frame_s=0.008,
                           spans={"build_scene": 1.5},
                           traced_traces=2_000_000, triangles=1_000_000,
                           eyes=1, peaks=peaks.H100_SXM)


def metric(name, ctx):
    return harness.load_metric(BENCH, name).read(ctx)


def test_trace_reduction(ctx):
    tr = ctx.trace
    assert tr.frames == 2
    assert tr.window_s == pytest.approx(0.020)
    # kernels [1, 3], [2, 4] and [12, 13] ms, a copy [15, 16] ms (one
    # outside the window is dropped): union 3 + 1 + 1 = 5 ms
    assert tr.busy_s == pytest.approx(0.005)
    assert len(tr.device) == 4
    ops = dict((n, s) for n, s in tr.device_ops())
    assert ops["void closest_hit_kernel<16, 6>(Args)"] == pytest.approx(0.002)
    gaps = dict((n, s) for n, s in tr.idle_gaps())
    # [0, 1] under aten::nonzero, [4, 12] under aten::mul, [13, 15] and
    # [16, 20] outside any op
    assert gaps == pytest.approx({"aten::nonzero": 0.001, "aten::mul": 0.008,
                                  "host outside any op": 0.006})


def test_layer_metrics(ctx):
    assert metric("launches_per_frame", ctx) == pytest.approx(2.0)
    assert metric("traversal_ms", ctx) == pytest.approx(2.0)  # 2 + 2 ms / 2
    assert metric("torch_ops_ms", ctx) == pytest.approx(0.5)
    # 2.5 ms busy a traced frame against the untraced window's 8 ms
    assert metric("device_idle_share", ctx) == pytest.approx(68.75)
    assert metric("scene_build_s", ctx) == 1.5
    # a frame: 1e6 traces x 52 B + 1e6 triangles x 36 B = 88 MB at
    # 3.35 TB/s = 26.27 us, over 2 ms
    want = 100 * (88e6 / 3.35e12) / 2.0e-3
    assert metric("traversal_roofline", ctx) == pytest.approx(want)


def test_nothing_to_read_gives_no_value():
    empty = harness.Context(trace=None, frame_s=0.01, spans={},
                            traced_traces=None,
                            triangles=1, eyes=1, peaks=peaks.H100_SXM)
    for name in ("launches_per_frame", "traversal_ms", "torch_ops_ms",
                 "device_idle_share", "traversal_roofline", "scene_build_s"):
        assert metric(name, empty) is None


def test_a_device_only_trace_takes_the_host_clock_window():
    """Without host ops there are no frame spans: every device event is of
    the traced frames, and the window is the host clock's."""
    with open(DATA) as f:
        chrome = json.load(f)
    chrome["traceEvents"] = [e for e in chrome["traceEvents"]
                             if e.get("cat") in ("kernel", "gpu_memcpy")]
    with pytest.raises(ValueError):
        Trace(chrome)
    tr = Trace(chrome, frames=2, window_s=0.025)
    assert tr.frames == 2 and tr.window_s == 0.025
    # kernels [1, 3], [2, 4], [12, 13], [21, 22] ms and a copy [15, 16]:
    # union 3 + 1 + 1 + 1 = 6 ms
    assert len(tr.device) == 5
    assert tr.busy_s == pytest.approx(0.006)
    c = harness.Context(trace=tr, frame_s=0.010, spans={},
                        traced_traces=None, triangles=1, eyes=1,
                        peaks=peaks.H100_SXM)
    # 3 ms busy a frame against 10 ms; the trace's own window reads 76%
    assert metric("device_idle_share", c) == pytest.approx(70.0)
    assert 1 - tr.busy_s / tr.window_s == pytest.approx(0.76)
    assert metric("launches_per_frame", c) == pytest.approx(2.5)
