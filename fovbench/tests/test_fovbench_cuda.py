"""On the card: one short run of each cell prints a correct result line
with its metrics and device. Marked ``cuda``; skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from conftest import REPO


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(card, trace):
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    for cell in cells:
        out = subprocess.run(
            [sys.executable, "fovbench/run.py", "--workload", cell, "--seed",
             str(2 ** 31 + 3), "--seconds", "2", "--trace", str(trace)],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"], res["checks"]
        assert res["device"]["platform"] == "gpu"
        assert res["metrics"]
