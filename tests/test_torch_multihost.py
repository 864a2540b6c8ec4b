"""The port's multi-process frames (``parallel/multihost.py``): two OS
processes joined by ``torch.distributed`` (gloo, on the CPU), each
rendering half of every pass's sample slots.

Tolerances: the two ranks' frames equal each other and the one-process
``reference_frame`` bit for bit (every rank sums the gathered per-slot
values as the single-device frame does; measured equal), the traces equal
on both ranks; ``reference_frame`` of a ``RenderJob`` against the JAX
package's: 99% of the pixels within 1 LSB (the port's frame gate).
Each process has its own timeout and the rendezvous a free port.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

from fovpathtracing_optixcodelatest_tpu.parallel import multihost as jmh
from fovpathtracing_optixcodelatest_tpu_torch.parallel import multihost

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240

_WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from fovpathtracing_optixcodelatest_tpu_torch.parallel.multihost import (
    RenderJob, worker)
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
frame, traces = worker(rank, 2, f"tcp://127.0.0.1:{port}", device="cpu",
                       job=RenderJob(frames=2), timeout_s=120)
np.savez(out, frame=frame, traces=traces)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_render_equals_reference(tmp_path):
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=ROOT)
    outs, procs = [], []
    for rank in range(2):
        outs.append(str(tmp_path / f"frame_{rank}.npz"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(rank), port, outs[-1]],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    logs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            logs.append(err.decode()[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), logs
    frames = [np.load(o)["frame"] for o in outs]
    traces = [int(np.load(o)["traces"]) for o in outs]
    assert np.array_equal(frames[0], frames[1])
    assert traces[0] == traces[1] > 0
    ref = multihost.reference_frame(job=multihost.RenderJob(frames=2),
                                    device="cpu")
    assert frames[0].shape == (24, 32, 3)
    assert np.array_equal(frames[0], ref)


def test_render_job_parameterizes_the_render_against_jax():
    kw = dict(width=24, height=16, scene="furnace_sphere", scene_kwargs=(),
              probe="constant", schedule="uniform:2",
              config_overrides=(("max_depth", 2), ("antialias", False)),
              frames=2, gaze=(10, 8), seed=3)
    got = multihost.reference_frame(job=multihost.RenderJob(**kw),
                                    device="cpu")
    want = jmh.reference_frame(job=jmh.RenderJob(**kw))
    assert got.shape == want.shape == (16, 24, 3)
    assert got.std() > 0
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert (d <= 1).mean() >= 0.99
