"""The port's ``Trackball``, schedule coverage members, benchmark sweep,
BSDF visualisation, ``save_gif`` and ``ops/rng.uniform`` against the JAX
package on the CPU.

Tolerances: the Trackball's cameras and angles within 1e-12 over an orbit
and zoom sequence (both float64 numpy); ``validate_coverage``'s hole maps,
``reference_32_16_8_sealed`` and ``fill_size`` exact; ``rng.uniform``
bit for bit ``jax.random.uniform``; ``bsdf_test_image`` within 1e-5
relative to the image's largest value, and its sampled directions within
1e-5; a GIF read back equal to its uint8 frames.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from fovpathtracing_optixcodelatest_tpu import config as jconfig
from fovpathtracing_optixcodelatest_tpu.models import camera as jcamera
from fovpathtracing_optixcodelatest_tpu.models.material import (
    Material as JMaterial,
)
from fovpathtracing_optixcodelatest_tpu.utils import bsdf_viz as jbsdf_viz
from fovpathtracing_optixcodelatest_tpu_torch import config as pconfig
from fovpathtracing_optixcodelatest_tpu_torch.apps import benchmark_sweep
from fovpathtracing_optixcodelatest_tpu_torch.models import camera as pcamera
from fovpathtracing_optixcodelatest_tpu_torch.models.material import Material
from fovpathtracing_optixcodelatest_tpu_torch.ops import rng
from fovpathtracing_optixcodelatest_tpu_torch.utils import bsdf_viz
from fovpathtracing_optixcodelatest_tpu_torch.utils.image import save_gif

torch.set_num_threads(2)

MOVES = [("orbit", 40.0, 10.0), ("zoom", 1), ("orbit", -300.0, 900.0),
         ("zoom", -1), ("zoom", -1), ("orbit", 5.0, -2000.0), ("zoom", 1)]


@pytest.mark.parametrize("view_mode", ["lookat_fixed", "eye_fixed"])
def test_trackball_sequence_matches_jax(view_mode):
    kw = dict(eye=(1.0, 2.0, 5.0), lookat=(0.0, 0.5, 0.0), fov_y=40.0,
              aspect=1.5)
    got = pcamera.Trackball(camera=pcamera.Camera(**kw), view_mode=view_mode)
    want = jcamera.Trackball(camera=jcamera.Camera(**kw), view_mode=view_mode)
    for tb in (got, want):
        tb.reinitialize_from_camera()
    for move in MOVES:
        g = getattr(got, move[0])(*move[1:])
        w = getattr(want, move[0])(*move[1:])
        for f in ("eye", "lookat"):
            assert np.abs(np.subtract(getattr(g, f),
                                      getattr(w, f))).max() <= 1e-12
        assert abs(got.latitude - want.latitude) <= 1e-12
        assert abs(got.longitude - want.longitude) <= 1e-12
    assert abs(got.latitude) < np.pi / 2  # held inside the poles


def test_coverage_and_sealed_schedule_match_jax():
    sealed = pconfig.FoveationSchedule.reference_32_16_8_sealed()
    jsealed = jconfig.FoveationSchedule.reference_32_16_8_sealed()
    assert ([dataclasses.asdict(p) for p in sealed.passes]
            == [dataclasses.asdict(p) for p in jsealed.passes])
    assert [p.fill_size for p in sealed.passes] == [4, 2, 1]
    ref = pconfig.FoveationSchedule.reference_32_16_8()
    jref = jconfig.FoveationSchedule.reference_32_16_8()
    for gaze in (None, (0, 0), (959, 539), (13, 400)):
        for mine, theirs in ((ref, jref), (sealed, jsealed)):
            got = mine.validate_coverage(960, 540, gaze=gaze)
            want = theirs.validate_coverage(960, 540, gaze=gaze)
            assert got.dtype == bool and np.array_equal(got, want)
        assert sealed.validate_coverage(960, 540, gaze=gaze).sum() == 0
    assert 0 < ref.validate_coverage(960, 540).sum() < 400
    cfg = pconfig.RenderConfig(width=64, height=48)
    assert cfg.resolution == jconfig.RenderConfig(width=64,
                                                  height=48).resolution


def test_benchmark_sweep_writes_its_files(tmp_path):
    rc = benchmark_sweep.main([
        "--device", "cpu", "--scene", "cornell", "--width", "48",
        "--height", "36", "--frames", "1", "--skip-uniform", "--scale-rings",
        "--out-dir", str(tmp_path)])
    assert rc == 0
    for name in benchmark_sweep.SWEEPS:
        rows = (tmp_path / f"cornell_fov_{name}.tsv").read_text().splitlines()
        assert "e+" in rows[0]  # the triangle count tag
        assert rows[1] == "config\tfps\tms_per_frame\ttraces"
        cfg, fps, ms, traces = rows[2].split("\t")
        assert cfg == name and float(fps) > 0 and float(ms) > 0
        assert int(traces) > 0
    rate = (tmp_path / "frame_rate.dat").read_text().splitlines()
    assert rate[0].split("\t") == [f"fov_{n}" for n in benchmark_sweep.SWEEPS]
    assert (tmp_path / "rendering_time.dat").exists()


def test_uniform_is_jax_uniform():
    for seed, shape in ((0, (1000, 6)), (7, (3, 5)), (123, (1,))):
        key = rng.prng_key(seed)
        got = rng.uniform(key, shape)
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("kw", [
    dict(color=(0.8, 0.3, 0.2), roughness=0.3, metallic=0.0,
         transmission=0.0),
    dict(color=(0.9, 0.9, 0.9), roughness=0.6, metallic=0.2,
         transmission=0.7, eta=1.5, clearcoat=0.5),
])
def test_bsdf_test_image_matches_jax(kw):
    got, guv = bsdf_viz.bsdf_test_image(Material(**kw), width=96, height=48,
                                        num_samples=200, device="cpu")
    want, wuv = jbsdf_viz.bsdf_test_image(JMaterial(**kw), width=96,
                                          height=48, num_samples=200)
    assert got.shape == want.shape == (48, 96, 3)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(guv - wuv).max() <= 1e-5
    assert (got == [1.0, 0.0, 0.0]).all(-1).sum() > 10  # the marks


def test_save_gif_round_trip(tmp_path):
    rng_np = np.random.default_rng(0)
    frames = [rng_np.integers(0, 4, (12, 16, 3)).astype(np.uint8) * 60
              for _ in range(3)]
    path = str(tmp_path / "a.gif")
    save_gif(path, frames, fps=5.0)
    with Image.open(path) as im:
        assert im.n_frames == 3
        assert im.info["duration"] == 200 and im.info["loop"] == 0
        for i, f in enumerate(frames):
            im.seek(i)
            assert np.array_equal(np.asarray(im.convert("RGB")), f)
    save_gif(str(tmp_path / "b.gif"), [f.astype(np.float32) / 255.0
                                       for f in frames])
    with Image.open(str(tmp_path / "b.gif")) as im:
        assert np.array_equal(np.asarray(im.convert("RGB")), frames[0])
