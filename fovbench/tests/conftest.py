"""Shared set-up of ``fovbench``'s CPU tests: a tiny benchmark tree (its
own ``BENCHMARK.json`` beside a ``fovbench/`` of data files) whose cells
run the port on the CPU at 64x36 on ``box_city_fast`` n=4.

Run from the root of the repository:
``python -m pytest fovbench/tests -q`` (about a minute on the CPU; the
``cuda`` test runs on the card only)."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
BENCH = os.path.join(REPO, "fovbench")

TINY_LIMITS = {"sample": {"frames": 3, "redraw": [8, 8], "history": 4},
               "limits": {"px_over_1lsb": 0.05, "mean_abs_lsb": 0.5}}


def tiny_tree(dst: str, n: int = 4, width: int = 64, height: int = 36,
              scale: int = 8, texture_size: int = 64) -> str:
    """A benchmark tree at ``dst`` with the real metrics and traffic mixes,
    the boxcity262k configuration cut to a tiny size and two cells, tiny.fixate
    and tiny.stereo_saccade. Returns its ``fovbench/`` directory."""
    from fovpathtracing_optixcodelatest_tpu_torch.config import (
        FoveationSchedule)

    fb = os.path.join(dst, "fovbench")
    for sub in ("traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(fb, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "limits"):
        os.makedirs(os.path.join(fb, sub))
    passes = [dataclasses.asdict(p) for p in
              FoveationSchedule.reference_32_16_8().scaled(scale).passes]
    with open(os.path.join(BENCH, "configs", "boxcity262k.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny", width=width, height=height,
               schedule={"name": f"reference_32_16_8 scaled {scale}",
                         "passes": passes})
    cfg["geometry"]["n"] = n
    cfg["textures"] = {"size": texture_size}
    with open(os.path.join(fb, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "fovbench/configs/tiny.json", "reduced": [],
                         "why": "test"}]
    bench["workloads"] = []
    for mix in ("fixate", "stereo_saccade"):
        name = f"tiny.{mix}"
        with open(os.path.join(fb, "limits", f"{name}.json"), "w") as f:
            json.dump(TINY_LIMITS, f)
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": mix, "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return fb


@pytest.fixture
def tiny(tmp_path):
    return tiny_tree(str(tmp_path))
