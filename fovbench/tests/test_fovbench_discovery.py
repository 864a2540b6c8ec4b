"""Configurations, traffic mixes, metrics and limits are found by name, and
a new cell with a new mix and a new metric runs from new files and new
entries alone; ``BENCHMARK.json`` keeps to its format: its keys, names,
units and bounds, and files that exist for every entry."""

import json
import os
import re

from conftest import BENCH, REPO
from fovbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_names_files_that_exist():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["fovbench"] and 1 <= bench["run_seconds"] <= 51
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("fovbench/")
        cfg = harness.load_json(os.path.join(REPO, c["file"]))
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    used = set()
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert w["config"] in configs and len(w["why"]) <= 200
        used.add(w["config"])
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(BENCH, "limits",
                                           f"{w['name']}.json"))
    assert used == configs
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert e2e == {"frame_ms", "frame_ms_p95", "setup_s"}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_a_new_cell_runs_from_new_files_alone(tiny):
    """A mix looking at a corner, its limits, a metric counting the traced
    frames: three new files and three new entries, no edit."""
    with open(os.path.join(tiny, "traffic", "corner.json"), "w") as f:
        json.dump({"display": "mono", "head": "scene_camera",
                   "gaze": {"kind": "fixed", "at": [0.2, 0.3]},
                   "warmup_frames": 1}, f)
    with open(os.path.join(tiny, "limits", "tiny.corner.json"), "w") as f:
        json.dump({"sample": {"frames": 2, "redraw": [4, 4], "history": 2},
                   "limits": {"px_over_1lsb": 0.05, "mean_abs_lsb": 0.5}}, f)
    with open(os.path.join(tiny, "metrics", "traced_frames.py"), "w") as f:
        f.write("def read(ctx):\n"
                "    return None if ctx.trace is None else ctx.trace.frames\n")
    path = os.path.join(os.path.dirname(tiny), "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny.corner", "config": "tiny",
                               "traffic": "corner", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "traced_frames", "unit": "frames",
                               "better": "higher", "source": "device_trace",
                               "layer": "front end", "moves": "frame_ms",
                               "workloads": ["tiny.corner"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    res, info = harness.run_cell(tiny, "tiny.corner", 4, 0.3, True, "cpu")
    assert res["correct"]
    assert res["metrics"]["traced_frames"] == {
        "value": float(harness.TRACED_FRAMES["mono"]), "unit": "frames"}
    # a metric with nothing to read on the CPU (no device) is left out
    assert "traversal_ms" not in res["metrics"]
    assert res["metrics"]["scene_build_s"]["value"] > 0
    assert res["device"]["window_s"] > 0
    assert info["window_frames"] >= 1
    assert list(res)[-1] == "checks"
