"""The readings of the port's own spans and counters (``fovbench/spans.py``
and the readers ``host_syncs_per_frame``, ``lanes_alive_share``) on a
hand-made counter table and a hand-made trace
(``data/trace_spans_small.json``: one traced frame of 10 ms with the
port's ``fov.*`` spans, six device events in it and one after it; the
numbers below are worked by hand)."""

import json
import os
import sys

import pytest

from conftest import BENCH
from fovbench import harness, peaks, spans
from fovbench.trace import Trace

DATA = os.path.join(os.path.dirname(__file__), "data",
                    "trace_spans_small.json")
MS = 1e-6  # ns to ms

# two frames: 6 syncs each, 9 ms of waits, raygen 2 + paths 1 + bounces
# 3 + 2 + film 1 + tone map 0.5 ms of self time a frame (K1, K2 and the
# syncs apart); 100 lanes enter bounce 0, 60, 30 and 10 the next three
COUNTERS = {
    "frames": 2,
    "syncs": {"live_lanes": 2, "narrow": 8, "download": 2},
    "ns_total": {"fov.frame": 40e6, "fov.sync.live_lanes": 4e6,
                 "fov.sync.narrow": 10e6, "fov.sync.download": 4e6,
                 "fov.k1": 6e6, "fov.bounce.0": 12e6},
    "ns": {"fov.frame": 1e6, "fov.raygen": 4e6, "fov.paths": 2e6,
           "fov.bounce.0": 6e6, "fov.bounce.1": 4e6, "fov.film": 2e6,
           "fov.tonemap": 1e6, "fov.k1": 6e6, "fov.k2": 2e6,
           "fov.sync.narrow": 10e6, "fov.sync.live_lanes": 4e6,
           "fov.sync.download": 4e6, "fov.bouncer": 9e6},
    "lanes": {0: 200, 1: 120, 2: 60, 3: 20},
}


def test_per_frame_readings():
    got = spans.per_frame(COUNTERS)
    assert got["host_syncs_per_frame"] == 6.0
    assert got["sync_wait_ms"] == pytest.approx(18e6 * MS / 2)
    # "fov.bouncer" is no bounce: only names under "fov.bounce." count
    assert got["integrator_host_ms"] == pytest.approx(19e6 * MS / 2)
    assert got["frame_span_ms"] == pytest.approx(20.0)
    # (200 + 120 + 60 + 20) / (200 x 4)
    assert got["lanes_alive_share"] == pytest.approx(50.0)
    assert spans.per_frame({"frames": 0}) == {}


def test_idle_by_span_on_a_hand_made_trace():
    with open(DATA) as f:
        chrome = json.load(f)
    idle = spans.idle_by_span(Trace(chrome), spans.fov_spans(chrome))
    # busy [0.6, 1], [1.6, 2.2], [3, 6], [6.2, 7.2], [7.8, 8.6], [9.6,
    # 9.8] ms; the gaps' middles: 0.3 and 1.3 in fov.raygen (which starts
    # with fov.frame: the inner of the two), 2.6 and 6.1 in fov.bounce.0
    # (fov.k1 opens at 2.7), 7.5 in fov.sync.narrow, 9.1 in fov.tonemap,
    # 9.9 after fov.frame
    assert idle == pytest.approx({
        "fov.raygen": 1.2e-3, "fov.bounce.0": 1.0e-3,
        "fov.sync.narrow": 0.6e-3, "fov.tonemap": 1.0e-3,
        spans.OUTSIDE: 0.2e-3}, abs=1e-9)
    # 3.2 of the 4.0 ms in integrator spans
    assert spans.idle_in_integrator_share(idle) == pytest.approx(80.0)


def test_no_fov_span_gives_no_share():
    with open(DATA) as f:
        chrome = json.load(f)
    chrome["traceEvents"] = [e for e in chrome["traceEvents"]
                             if not e["name"].startswith("fov.")]
    idle = spans.idle_by_span(Trace(chrome), spans.fov_spans(chrome))
    assert set(idle) == {spans.OUTSIDE}
    assert idle[spans.OUTSIDE] == pytest.approx(4.0e-3, abs=1e-9)
    assert spans.idle_in_integrator_share(idle) is None


def _ctx():
    return harness.Context(trace=None, frame_s=0.01, spans={},
                           traced_traces=None, triangles=1, eyes=1,
                           peaks=peaks.H100_SXM)


def test_the_readers_read_the_ports_counters(monkeypatch):
    from fovpathtracing_optixcodelatest_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "snapshot", lambda: COUNTERS)
    def read(name):
        return harness.load_metric(BENCH, name).read(_ctx())

    assert read("host_syncs_per_frame") == 6.0
    assert read("lanes_alive_share") == pytest.approx(50.0)


def test_a_port_without_counters_gives_nothing(monkeypatch):
    """As on a commit of the port that has no ``utils/tracing.py``."""
    from fovpathtracing_optixcodelatest_tpu_torch import utils

    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(
        sys.modules, "fovpathtracing_optixcodelatest_tpu_torch.utils.tracing",
        None)
    assert spans.port_counters() is None
    for name in ("host_syncs_per_frame", "lanes_alive_share"):
        assert harness.load_metric(BENCH, name).read(_ctx()) is None


def test_a_tiny_run_reports_the_counters(tiny, monkeypatch):
    """A traced run on the CPU reports both; a frame of this cell runs
    every bounce: the live-lane sync, four narrowings, the download. (The
    counters start afresh, as in a process of its own.)"""
    from fovpathtracing_optixcodelatest_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "COUNTERS", {
        "frames": 0, **{g: {} for g in tracing.GROUPS}})
    res, _ = harness.run_cell(tiny, "tiny.fixate", 2 ** 31 + 5, 0.3, True,
                              "cpu")
    assert res["metrics"]["host_syncs_per_frame"] == {
        "value": 6.0, "unit": "syncs/frame"}
    share = res["metrics"]["lanes_alive_share"]["value"]
    assert 0.0 < share < 100.0


def test_window_readings_on_a_tiny_cell(tiny):
    """``python3 -m fovbench.spans``' readings, from one traced run of
    ``run_cell`` on the CPU: the window's frames each make the six syncs,
    and the idle time of the traced frames with host ops is put down to
    the port's spans; the harness is left as it was."""
    got = spans.window_readings(tiny, "tiny.fixate", 2 ** 31 + 9, 0.3,
                                "cpu")
    assert got["correct"] is True and got["window_frames"] >= 1
    assert got["syncs"] == {"live_lanes": got["window_frames"],
                            "narrow": 4 * got["window_frames"],
                            "download": got["window_frames"]}
    assert got["host_syncs_per_frame"] == 6.0
    assert 0.0 < got["frame_span_ms"] <= got["frame_ms"]
    assert set(got["traced_frame_ms"]) == {"device_only", "with_host_ops"}
    # the CPU run has no device events: its traced frames are one idle
    # gap, put down to the span open at its middle
    (name,) = got["idle_ms_per_frame"]
    assert name.startswith("fov.") and got["idle_ms_per_frame"][name] > 0
    assert got["idle_in_integrator_share"] in (0.0, 100.0)
    # the harness is left as it was
    assert harness._Program.__module__ == "fovbench.harness"
    assert harness.Trace is Trace
