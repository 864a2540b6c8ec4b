"""The PyTorch port's brute-force oracle path (``traversal="oracle"``,
``ops/intersect.py``) and SSIM (``utils/metrics.py``) against the JAX
package on the CPU: the checks of ``tests/test_oracle_ssim.py``.

The port's K1/K2 frame is held to the port's oracle frame at the JAX test's
thresholds (SSIM >= 0.98, mean abs < 5e-3); the port's oracle frame is held
to JAX's oracle frame on the same scene and seeds (99% of the pixels within
1 LSB); a stack cut to depth 1 must crater the SSIM (< 0.9); ``ssim`` and
its box filter equal JAX's on random images to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fovpathtracing_optixcodelatest_tpu import config as jconfig
from fovpathtracing_optixcodelatest_tpu.models import scenes as jscenes
from fovpathtracing_optixcodelatest_tpu.models.probe import (
    gradient_sky_probe as j_sky,
)
from fovpathtracing_optixcodelatest_tpu.models.scene import build_scene as j_build
from fovpathtracing_optixcodelatest_tpu.render import film as jfilm
from fovpathtracing_optixcodelatest_tpu.render.renderer import render_frame as j_render
from fovpathtracing_optixcodelatest_tpu.utils import metrics as jmetrics
from fovpathtracing_optixcodelatest_tpu_torch.config import (
    FoveationSchedule,
    RenderConfig,
)
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import gradient_sky_probe
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import build_scene
from fovpathtracing_optixcodelatest_tpu_torch.utils import metrics

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cornell():
    meshes, cam = scenes.cornell(sphere_subdiv=1)
    return build_scene(meshes, gradient_sky_probe(width=64, height=32),
                       device="cpu"), cam


def _frame(scene, cam, config, schedule):
    return chip_smoke.golden_frame(scene, cam, config, schedule,
                                   fold=False).astype(np.float32) / 255.0


def test_bvh_pipeline_matches_brute_force_oracle(cornell):
    scene, cam = cornell
    base = RenderConfig(width=64, height=48)
    sched = FoveationSchedule.uniform(4)
    img_bvh = _frame(scene, cam, base, sched)
    img_orc = _frame(scene, cam, dataclasses.replace(base, traversal="oracle"),
                     sched)
    s = metrics.ssim(img_bvh, img_orc)
    assert s >= 0.98, f"SSIM vs oracle {s}"
    assert np.abs(img_bvh - img_orc).mean() < 5e-3


def test_oracle_frame_matches_jax_oracle_frame(cornell):
    scene, cam = cornell
    w, h = 64, 48
    img = chip_smoke.golden_frame(
        scene, cam, RenderConfig(width=w, height=h, traversal="oracle"),
        FoveationSchedule.uniform(4), fold=False)
    jmeshes, jcam = jscenes.cornell(sphere_subdiv=1)
    jscene = j_build(jmeshes, probe=j_sky(width=64, height=32))
    sched = jconfig.FoveationSchedule.uniform(4)
    pad = jfilm.schedule_padding(sched, w, h)
    _, jimg, _ = j_render(
        jscene, dataclasses.replace(jcam, aspect=w / h).device_params(),
        jnp.int32(w // 2), jnp.int32(h // 2), jnp.int32(0),
        jfilm.new_canvas(w, h, pad), jax.random.PRNGKey(0),
        jconfig.RenderConfig(width=w, height=h, traversal="oracle"), sched)
    close = (np.abs(img.astype(int) - np.asarray(jimg).astype(int)).max(-1)
             <= 1).mean()
    assert close >= 0.99, close


def test_oracle_ssim_detects_broken_traversal(cornell):
    scene, cam = cornell
    base = RenderConfig(width=48, height=36)
    sched = FoveationSchedule.uniform(2)
    img_orc = _frame(scene, cam, dataclasses.replace(base, traversal="oracle"),
                     sched)
    broken = dataclasses.replace(
        scene, bvh=dataclasses.replace(scene.bvh, stack_depth=1))
    assert metrics.ssim(img_orc, _frame(broken, cam, base, sched)) < 0.9


@pytest.mark.parametrize("shape,window", [((48, 36, 3), 7), ((20, 30), 3),
                                          ((33, 17, 3), 5)])
def test_ssim_matches_jax(shape, window):
    rng = np.random.default_rng(sum(shape))
    a = rng.random(shape)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1)
    assert abs(metrics.ssim(a, b, window) - jmetrics.ssim(a, b, window)) \
        <= 1e-6
    assert abs(metrics.ssim(a, a) - 1.0) <= 1e-6
    assert np.array_equal(metrics._uniform_filter(a, window),
                          jmetrics._uniform_filter(a, window))
