"""The stereo pair at a headset's shape, on the CPU.

(a) What a pair counts in ``utils/tracing.py``: one displayed frame, one
wavefront an eye, a ``fov.eye.<e>`` span an eye (also in a profiled pair),
and no sync beyond each eye's own and the pair's download and ``traces``;
a mono frame counts one wavefront.

(b) A pair at the Quest Pro panel's portrait shape (1800:1920, cut to 75x80
with the upstream schedule scaled by 24; ``box_city_fast`` n=4, textured),
rendered through ``StereoRenderer`` as the benchmark drives it
(``fovbench/harness.py``), against the plain-PyTorch reference of
``fovbench/reference/``: chosen pixels of chosen frames, as the benchmark's
check draws them, with no pixel apart (the reference repeats the port's
float32 expressions, as the tiny stereo cell shows).

(c) The benchmark's readers of the new count and span
(``fovbench/metrics/wavefronts_per_frame.py``, ``download_ms.py``) on
hand-made counter tables.

(d) A pair's host array holds the two eyes' frames as rendered, and the
next pair does not write over an array still held (on the card the array
is page-locked and filled by copies the host does not wait for; the
``cuda`` case runs there).
"""

import dataclasses
import json
import os
import sys

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
from fovpathtracing_optixcodelatest_tpu_torch.parallel import stereo
from fovpathtracing_optixcodelatest_tpu_torch.parallel.stereo import (
    StereoRenderer,
    eye_cameras_from_pose,
)
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import Renderer
from fovpathtracing_optixcodelatest_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from fovbench import check, harness  # noqa: E402
from fovbench.reference.render import Reference  # noqa: E402

BENCH = os.path.join(REPO, "fovbench")
DEPTH = 2

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def city():
    meshes, cam = scenes.box_city(n=4, seed=0)
    scene = build_scene(meshes, gradient_sky_probe(width=64, height=32),
                        device="cpu")
    return scene, cam


def _counted(render):
    before = tracing.snapshot()
    render()
    return tracing.diff(before, tracing.snapshot())


def test_a_pair_counts_two_wavefronts_and_an_eye_span_each(city,
                                                          monkeypatch):
    scene, cam = city
    config = RenderConfig(width=24, height=32, max_depth=DEPTH)
    sr = StereoRenderer(scene, config, FoveationSchedule.uniform(1),
                        device="cpu")
    left, right = eye_cameras_from_pose(cam.eye, np.subtract(cam.lookat,
                                                             cam.eye))
    got = _counted(lambda: sr.render(left, right))
    assert got["frames"] == 1 and got["wavefronts"] == 2
    assert {"fov.eye.0", "fov.eye.1"} <= set(got["ns_total"])
    # each eye's ``render_frame`` lies inside its span: its wavefront too
    assert got["ns_total"]["fov.eye.0"] >= got["ns"]["fov.eye.0"] > 0
    narrow = got["syncs"]["narrow"]
    assert got["syncs"] == {"live_lanes": 2, "narrow": narrow,
                            "download": 1, "traces": 1}
    # while the profiler records, each eye's span is a profiler range too
    opened = []

    def recorded(name):
        opened.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(tracing, "record_function", recorded)
    with profile(activities=[ProfilerActivity.CPU]):
        sr.render(left, right)
    eyes = [n for n in opened if n.startswith(tracing.EYE_PREFIX)]
    assert opened[0] == "fov.frame" and eyes == ["fov.eye.0", "fov.eye.1"]


def test_a_mono_frame_counts_one_wavefront(city):
    scene, cam = city
    r = Renderer(scene, RenderConfig(width=24, height=32, max_depth=DEPTH),
                 FoveationSchedule.uniform(1), seed=1, device="cpu")
    r.set_camera(cam)
    got = _counted(r.render)
    assert got["frames"] == 1 and got["wavefronts"] == 1
    assert not any(k.startswith(tracing.EYE_PREFIX) for k in got["ns_total"])
    narrow = got["syncs"]["narrow"]
    assert got["syncs"] == {"live_lanes": 1, "narrow": narrow,
                            "download": 1}


def headset_config(scale: int = 24, texture_size: int = 64) -> dict:
    """``questpro262k`` at 1/``scale`` of its panel on ``box_city_fast``
    n=4: the schedule scaled as ``FoveationSchedule.scaled`` scales it."""
    with open(os.path.join(BENCH, "configs", "questpro262k.json")) as f:
        cfg = json.load(f)
    passes = [dataclasses.asdict(p) for p in
              FoveationSchedule.reference_32_16_8().scaled(scale).passes]
    cfg.update(width=cfg["width"] // scale, height=cfg["height"] // scale,
               schedule={"name": f"reference_32_16_8 scaled {scale}",
                         "passes": passes})
    cfg["geometry"]["n"] = 4
    cfg["textures"] = {"size": texture_size}
    return cfg


@pytest.mark.parametrize("seed", [2 ** 31 + 21, 4_000_000_007])
def test_a_headset_pair_agrees_with_the_reference(seed):
    cfg = headset_config()
    assert (cfg["width"], cfg["height"]) == (75, 80)
    meshes, camera, images, probe = harness.generate_scene(cfg)
    tr = harness.traffic_of(BENCH, cfg, "stereo_saccade", seed, camera)
    prog = harness._Program(cfg, tr, meshes, camera, images, probe, seed,
                            torch.device("cpu"))
    sample = {"frames": 3, "redraw": [12, 12], "history": 6}
    keep = check.Reservoir(seed, sample["frames"] - 1)
    for f in range(3):
        keep.add(f, prog.render(f))
    kept = keep.frames()
    assert sorted(kept) == [0, 1, 2] and kept[2].shape == (2, 80, 75, 3)
    checks = check.draw(cfg, tr, seed, kept, sample)
    assert {e for e, *_ in checks} == {0, 1}
    got = np.stack([kept[s][e, y, x] for e, s, x, y in checks])
    cams, fov = harness.cameras_of(cfg, tr, camera)
    ref = Reference(cfg, meshes, images, probe, cams, fov, "cpu")
    want = check.reference_pixels(ref, cfg, tr, seed, checks)
    numbers = check.compare(got, want)
    with open(os.path.join(BENCH, "limits",
                           "questpro262k.stereo_saccade.json")) as f:
        limits = json.load(f)["limits"]
    assert all(numbers[k] <= limits[k] for k in limits)
    assert numbers == {"px_over_1lsb": 0.0, "mean_abs_lsb": 0.0}
    # the checks reach lit geometry, not only the sky's backplate
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 8


def _table(**scalars):
    return {**scalars, "ns": {}, "ns_total": {"fov.sync.download": 9_000_000,
                                              "fov.frame": 50_000_000},
            "syncs": {}, "lanes": {}, "shade": {}}


@pytest.mark.parametrize("name,table,want", [
    ("wavefronts_per_frame", _table(frames=3, wavefronts=6), 2.0),
    ("wavefronts_per_frame", _table(frames=4, wavefronts=4), 1.0),
    ("wavefronts_per_frame", _table(frames=3), None),
    ("wavefronts_per_frame", _table(frames=0, wavefronts=0), None),
    ("download_ms", _table(frames=3, wavefronts=6), 3.0),
    ("download_ms", {**_table(frames=3), "ns_total": {}}, None),
    ("download_ms", None, None),
    ("wavefronts_per_frame", None, None),
])
def test_the_readers_on_hand_made_counters(monkeypatch, name, table, want):
    mod = harness.load_metric(BENCH, name)
    monkeypatch.setattr(mod, "port_counters", lambda: table)
    got = mod.read(None)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_a_pair_downloads_the_eyes_frames(device, monkeypatch):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    meshes, cam = scenes.box_city(n=4, seed=0)
    scene = build_scene(meshes, gradient_sky_probe(width=64, height=32),
                        device=device)
    sr = StereoRenderer(scene, RenderConfig(width=24, height=32,
                                            max_depth=DEPTH),
                        FoveationSchedule.uniform(1), device=device)
    left, right = eye_cameras_from_pose(cam.eye, np.subtract(cam.lookat,
                                                             cam.eye))
    frames = []
    rendered = stereo.render_frame

    def keep(*args):
        canvas, frame, st = rendered(*args)
        frames.append(frame.clone())
        return canvas, frame, st

    monkeypatch.setattr(stereo, "render_frame", keep)
    first = sr.render(left, right)
    held = first.copy()
    second = sr.render(left, right)
    assert np.array_equal(first, held) and not np.array_equal(first, second)
    for pair, eyes in ((first, frames[:2]), (second, frames[2:])):
        assert pair.shape == (2, 32, 24, 3) and pair.dtype == np.uint8
        assert np.array_equal(pair, torch.stack(eyes).cpu().numpy())
