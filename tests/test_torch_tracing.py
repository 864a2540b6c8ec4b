"""The port's spans and counters (``utils/tracing.py``) on the CPU, and on
the card the claim they rest on: every call in a frame that waits for the
device is a ``fov.sync.*`` span, and every device operation of the frame
was launched inside a ``fov.*`` span.

The CPU tests render a 32x16 frame of ``box_city`` n=4 with the reference
schedule at ``max_depth`` 4. The card test (marker ``cuda``; it imports
nothing of JAX) profiles one 960x540 frame of the same scene:

    python -m pytest -m cuda tests/test_torch_tracing.py
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fovpathtracing_optixcodelatest_tpu_torch.config import (
    FoveationSchedule,
    RenderConfig,
)
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
    gradient_sky_probe,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import build_scene
from fovpathtracing_optixcodelatest_tpu_torch.parallel.stereo import (
    StereoRenderer,
    eye_cameras_from_pose,
)
from fovpathtracing_optixcodelatest_tpu_torch.render import integrator
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import Renderer
from fovpathtracing_optixcodelatest_tpu_torch.utils import tracing

torch.set_num_threads(2)

DEPTH = 4
# each span's parent: the innermost span around it
PARENT = {"fov.raygen": "fov.frame", "fov.paths": "fov.frame",
          "fov.sync.live_lanes": "fov.paths", "fov.film": "fov.frame",
          "fov.tonemap": "fov.frame", "fov.sync.download": "fov.frame",
          **{f"fov.bounce.{d}": "fov.paths" for d in range(DEPTH)}}
IN_BOUNCE = ("fov.k1", "fov.k2", "fov.sync.narrow")


def _renderer(device, width, height, schedule=None):
    meshes, cam = scenes.box_city(n=4, seed=0)
    scene = build_scene(meshes, gradient_sky_probe(width=64, height=32),
                        device=device)
    config = RenderConfig(width=width, height=height, max_depth=DEPTH)
    r = Renderer(scene, config,
                 schedule or FoveationSchedule.reference_32_16_8(), seed=3,
                 device=device)
    r.set_camera(cam)
    return r


def _spans(chrome):
    """The ``fov.*`` annotations of a Chrome trace as (start, end, name),
    in start order (times in microseconds)."""
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                  for e in chrome["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith("fov."))


def _innermost(spans, t):
    """The innermost span open at time ``t``."""
    return min((s for s in spans if s[0] <= t <= s[1]),
               key=lambda s: s[1] - s[0], default=None)


def _profiled_frame(r, activities, path):
    with profile(activities=activities) as prof:
        px = r.render()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return px, json.load(f)


def test_a_frame_counts_its_syncs_and_lanes(monkeypatch):
    """One frame: one displayed frame, the live-lane ``nonzero``, one
    narrowing a bounce run, one download; the lanes entering each bounce
    equal those ``trace_paths`` hands ``bounce`` and the alive masks it
    narrows by."""
    r = _renderer("cpu", 32, 16)
    seen, alive = [], []
    real = integrator.bounce

    def counting(scene, o, *args, **kwargs):
        seen.append(o.shape[0])
        out = real(scene, o, *args, **kwargs)
        alive.append(int(out["alive"].sum()))
        return out

    monkeypatch.setattr(integrator, "bounce", counting)
    before = tracing.snapshot()
    r.render()
    got = tracing.diff(before, tracing.snapshot())
    assert got["frames"] == 1
    assert len(seen) == DEPTH and seen[0] > 0
    assert got["syncs"] == {"live_lanes": 1, "narrow": len(seen),
                            "download": 1}
    assert got["lane_list"] == {"host": 1}
    assert got["lanes"] == dict(enumerate(seen))
    assert seen[1:] == alive[:-1]
    # self times tile the frame: their sum is its whole duration, of which
    # the frame's own code outside every other span is a sliver
    frame_ns = got["ns_total"]["fov.frame"]
    assert sum(got["ns"].values()) == frame_ns
    assert got["ns"]["fov.frame"] < 0.05 * frame_ns
    for name, parent in PARENT.items():
        assert got["ns_total"][name] <= got["ns_total"][parent]


def test_a_profiled_frame_is_the_same_frame_with_every_span(tmp_path):
    """Under the profiler the frame's pixels are bit-identical, and its
    Chrome trace holds every span, each inside its parent."""
    plain = _renderer("cpu", 32, 16).render()
    px, chrome = _profiled_frame(_renderer("cpu", 32, 16),
                                 [ProfilerActivity.CPU], tmp_path / "t.json")
    assert np.array_equal(px, plain)
    spans = _spans(chrome)
    names = [s[2] for s in spans]
    assert set(names) == set(PARENT) | set(IN_BOUNCE) | {"fov.frame"}
    # one K1 and one K2 a bounce (no catcher in the scene)
    assert names.count("fov.k1") == names.count("fov.k2") == DEPTH
    for s in spans:
        around = [p for p in spans
                  if p is not s and p[0] <= s[0] and s[1] <= p[1]]
        parent = min(around, key=lambda p: p[1] - p[0], default=None)
        if s[2] == "fov.frame":
            assert parent is None
        elif s[2] in IN_BOUNCE:
            assert parent[2].startswith("fov.bounce."), s
        else:
            assert parent[2] == PARENT[s[2]], s


def test_no_record_function_while_the_profiler_is_off(monkeypatch):
    opened = []

    def counting(name):
        opened.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(tracing, "record_function", counting)
    r = _renderer("cpu", 32, 16, FoveationSchedule.uniform(1))
    r.render()
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        r.render()
    assert opened[0] == "fov.frame" and "fov.sync.download" in opened


def test_a_stereo_pair_is_one_frame():
    """A pair counts one displayed frame; each eye its own syncs, and the
    pair's download and trace count one each."""
    meshes, cam = scenes.box_city(n=4, seed=0)
    scene = build_scene(meshes, gradient_sky_probe(width=64, height=32),
                        device="cpu")
    config = RenderConfig(width=24, height=16, max_depth=DEPTH)
    sr = StereoRenderer(scene, config, FoveationSchedule.uniform(1),
                        device="cpu")
    left, right = eye_cameras_from_pose(cam.eye, np.subtract(cam.lookat,
                                                             cam.eye))
    before = tracing.snapshot()
    sr.render(left, right)
    got = tracing.diff(before, tracing.snapshot())
    assert got["frames"] == 1
    narrow = got["syncs"]["narrow"]
    assert got["syncs"] == {"live_lanes": 2, "narrow": narrow,
                            "download": 1, "traces": 1}
    assert got["lane_list"] == {"host": 2}
    # both eyes walk every depth
    assert got["lanes"].keys() == set(range(DEPTH)) and narrow == 2 * DEPTH


def test_diff_keeps_what_changed():
    a = {"frames": 2, "ns": {"x": 5}, "syncs": {"narrow": 3, "d": 1},
         "lanes": {}}
    b = {"frames": 3, "ns": {"x": 9, "y": 1}, "syncs": {"narrow": 3, "d": 2},
         "lanes": {0: 7}}
    assert tracing.diff(a, b) == {
        "frames": 1, "ns": {"x": 4, "y": 1}, "ns_total": {},
        "syncs": {"d": 1}, "lanes": {0: 7}, "shade": {}, "lane_list": {},
        "raygen": {}, "film": {}}


def test_a_span_keeps_its_self_time_apart_from_its_children():
    before = tracing.snapshot()
    with tracing.span("test.outer"):
        with tracing.span("test.inner"):
            pass
        with tracing.sync("test_site"):
            pass
    got = tracing.diff(before, tracing.snapshot())
    inner = (got["ns_total"]["test.inner"]
             + got["ns_total"]["fov.sync.test_site"])
    assert got["ns"]["test.outer"] == got["ns_total"]["test.outer"] - inner
    assert set(got["ns_total"]) == {"test.outer", "test.inner",
                                    "fov.sync.test_site"}
    assert got["syncs"] == {"test_site": 1} and got["frames"] == 0


def test_threads_keep_their_own_spans_and_lose_no_count():
    """Eight threads (the viewer renders on two) spanning at once, switching
    every microsecond: no count is lost and each thread's sync is the child
    of its own span."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = tracing.snapshot()

        def work():
            for _ in range(2000):
                with tracing.span("test.thread"):
                    with tracing.sync("test_thread"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = tracing.diff(before, tracing.snapshot())
    assert got["syncs"] == {"test_thread": 16000}
    assert set(got["ns_total"]) == {"test.thread", "fov.sync.test_thread"}
    assert got["ns"]["test.thread"] == (got["ns_total"]["test.thread"]
                                        - got["ns_total"]["fov.sync.test_thread"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# runtime calls that wait for the device, and copy kinds the host waits on
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaFree")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_on_the_card_syncs_are_spans_and_device_work_is_spanned(card,
                                                                 tmp_path):
    r = _renderer(card, 960, 540)
    for _ in range(2):  # kernels built and loaded, the allocator warm
        r.render()
    _, chrome = _profiled_frame(
        r, [ProfilerActivity.CPU, ProfilerActivity.CUDA], tmp_path / "t.json")
    events = [e for e in chrome["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    spans = _spans(chrome)
    frame = [s for s in spans if s[2] == "fov.frame"]
    assert len(frame) == 1
    f0, f1 = frame[0][:2]
    inside = [s for s in spans if s[2] != "fov.frame"]
    host = [e for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and f0 <= e["ts"] <= f1]
    by_corr = {e["args"]["correlation"]: e for e in host
               if "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    # copies the host waits on: device to pageable host memory (the lane
    # counts' copy into page-locked memory waits for nothing)
    dtoh = {e["args"]["correlation"] for e in device
            if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]
            and "Pinned" not in e["name"]}

    waits = [e for e in host if e["name"] in WAITS or (
        e["name"] == "cudaMemcpyAsync"
        and e.get("args", {}).get("correlation") in dtoh)]
    syncs = [s for s in inside if s[2].startswith("fov.sync.")]
    # the download alone: the lane lists stay on the card
    assert [s[2] for s in syncs] == ["fov.sync.download"]
    holder = {}
    for w in waits:
        s = _innermost(inside, w["ts"])
        assert s is not None and s[2].startswith("fov.sync."), (
            w["name"], s)
        holder.setdefault(s, []).append(w["name"])
    # each sync span holds its wait: one synchronisation
    assert sorted(holder) == sorted(syncs)
    for s, names in holder.items():
        assert sum(n.endswith("Synchronize") for n in names) == 1, (s, names)

    launched = 0
    for e in device:
        # the profile holds the frame alone: every launch lies in it
        launch = by_corr.get(e["args"].get("correlation"))
        assert launch is not None, e["name"]
        s = _innermost(inside, launch["ts"])
        assert s is not None, (e["name"], launch["name"])
        launched += 1
    # ray generation and the film (one launch each), each bounce's K1,
    # shading kernels and K2, the compactions and the state's set-up
    # (about 40 launches a frame)
    assert launched > 30
    for kernel in ("shade_kernel", "resolve_kernel", "compact_kernel"):
        assert sum(kernel in e["name"] for e in device) == DEPTH, kernel
    for kernel in ("raygen_kernel", "film_kernel"):
        assert sum(kernel in e["name"] for e in device) == 1, kernel
