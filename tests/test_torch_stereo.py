"""The port's stereo renderer (``parallel/stereo.py``) against the JAX
package's, on the CPU.

Tolerances: the eye cameras' eye/lookat and every camera parameter
within 1e-6 of JAX's (float32 parameters from float64 math); the stereo
frames against JAX's: 99% of the pixels within 1 LSB in each eye and
subframe (the port's frame gate); each eye equal, bit for bit, to the
port's mono ``render_frame`` with the same camera and key.
"""

import jax
import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu import config as jconfig
from fovpathtracing_optixcodelatest_tpu.models import scenes as jscenes
from fovpathtracing_optixcodelatest_tpu.models.probe import (
    gradient_sky_probe as j_sky,
)
from fovpathtracing_optixcodelatest_tpu.models.scene import build_scene as j_build
from fovpathtracing_optixcodelatest_tpu.parallel import stereo as jstereo
from fovpathtracing_optixcodelatest_tpu_torch import config as pconfig
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
    gradient_sky_probe,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import build_scene
from fovpathtracing_optixcodelatest_tpu_torch.parallel import stereo
from fovpathtracing_optixcodelatest_tpu_torch.render import film
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
    render_frame,
)

torch.set_num_threads(2)

W, H = 32, 24
POSE = dict(position=(0.0, 1.0, 3.5), forward=(0.0, -0.2, -1.0),
            ipd=0.064, fov_y=60.0, aspect=W / H, focus_distance=4.0)


def _sched(cfg, r=5):
    return cfg.FoveationSchedule(passes=(
        cfg.FoveationPass(factor=4, spp=2, r_inner=float(r), r_outer=1e9,
                          redraw=False),
        cfg.FoveationPass(factor=1, spp=4, r_inner=0.0, r_outer=float(r + 1),
                          redraw=True, launch_w=2 * (r + 1),
                          launch_h=2 * (r + 1), centered=True,
                          center_offset=r + 1),
    ))


def _params(p):
    return np.concatenate([np.asarray(p.eye), np.asarray(p.u),
                           np.asarray(p.v), np.asarray(p.w)])


def test_eye_cameras_and_fov_angles_match_jax():
    got = stereo.eye_cameras_from_pose(**POSE)
    want = jstereo.eye_cameras_from_pose(**POSE)
    for g, w in zip(got, want):
        assert np.abs(np.subtract(g.eye, w.eye)).max() <= 1e-6
        assert np.abs(np.subtract(g.lookat, w.lookat)).max() <= 1e-6
        assert (g.fov_y, g.aspect) == (w.fov_y, w.aspect)
        assert np.abs(_params(g.device_params("cpu"))
                      - _params(w.device_params())).max() <= 1e-6
    # the eyes sit ipd apart
    assert np.isclose(np.linalg.norm(np.subtract(got[1].eye, got[0].eye)),
                      0.064)
    angles = (-0.7, 0.6, 0.5, -0.55)
    g = stereo.camera_from_fov_angles((0, 1, 3), (0, 0, -1), (0, 1, 0),
                                      *angles, device="cpu")
    w = jstereo.camera_from_fov_angles((0, 1, 3), (0, 0, -1), (0, 1, 0),
                                       *angles)
    assert np.abs(_params(g) - _params(w)).max() <= 1e-6


@pytest.fixture(scope="module")
def stereo_frames():
    meshes, _ = scenes.cornell(sphere_subdiv=1)
    scene = build_scene(meshes, gradient_sky_probe(width=32, height=16),
                        device="cpu")
    cfg = pconfig.RenderConfig(width=W, height=H, max_depth=3)
    sr = stereo.StereoRenderer(scene, cfg, _sched(pconfig), device="cpu")
    left, right = stereo.eye_cameras_from_pose(**POSE)
    pairs, keys = [], []
    for _ in range(2):
        keys.append([sr.eye_key(e) for e in (0, 1)])
        pairs.append(sr.render(left, right, gaze=(15, 11)))
    return scene, cfg, sr, (left, right), pairs, keys


def test_stereo_matches_jax(stereo_frames):
    _, _, sr, _, pairs, _ = stereo_frames
    jmeshes, _ = jscenes.cornell(sphere_subdiv=1)
    jscene = j_build(jmeshes, probe=j_sky(width=32, height=16))
    jsr = jstereo.StereoRenderer(
        jscene, jconfig.RenderConfig(width=W, height=H, max_depth=3),
        _sched(jconfig))
    left, right = jstereo.eye_cameras_from_pose(**POSE)
    for got in pairs:
        want = jsr.render(left, right, gaze=(15, 11))
        assert got.shape == want.shape == (2, H, W, 3)
        assert got.dtype == np.uint8
        for e in (0, 1):
            d = np.abs(got[e].astype(int) - want[e].astype(int)).max(-1)
            assert (d <= 1).mean() >= 0.99
    assert sr.subframe == 2 and sr.stats["traces"] > 0
    assert not np.array_equal(pairs[-1][0], pairs[-1][1])  # two viewpoints


def test_each_eye_is_the_mono_frame(stereo_frames):
    scene, cfg, sr, eyes, pairs, keys = stereo_frames
    sched = _sched(pconfig)
    # the eye keys follow JAX's chain fold_in(fold_in(PRNGKey(0), s), e)
    want_key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0),
                                                     1), 1)
    assert np.array_equal(keys[1][1], np.asarray(want_key))
    for e, cam in enumerate(eyes):
        canvas = film.new_canvas(W, H, film.schedule_padding(sched, W, H),
                                 "cpu")
        for s in range(2):
            canvas, frame, _ = render_frame(
                scene, cam.device_params("cpu"), 15, 11, s, canvas,
                keys[s][e], cfg, sched)
            assert np.array_equal(frame.numpy(), pairs[s][e])
        assert torch.equal(canvas, sr.canvases[e])
