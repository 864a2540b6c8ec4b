"""The PyTorch port's ray generation, integrator and renderer against the
JAX package on the CPU.

Tolerances: ring masks, active masks and ray ids exact; ray directions
within 1e-6 (XLA contracts the camera-basis multiply-adds into FMAs);
per-ray radiance / alpha / normal / albedo within rtol 1e-3 / atol 1e-5 on
at least 99% of the rays (a direction an ulp apart can leave an edge or
flip an occlusion); the traces count exact; frames: at least 99% of the
pixels within 1 LSB (measured: 100% identical on this scene).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu import config as jconfig
from fovpathtracing_optixcodelatest_tpu.models import scenes as jscenes
from fovpathtracing_optixcodelatest_tpu.models.probe import (
    gradient_sky_probe as j_sky,
)
from fovpathtracing_optixcodelatest_tpu.models.scene import build_scene as j_build
from fovpathtracing_optixcodelatest_tpu.render import raygen as jraygen
from fovpathtracing_optixcodelatest_tpu.render.integrator import (
    trace_paths as j_trace_paths,
)
from fovpathtracing_optixcodelatest_tpu.render.renderer import Renderer as JRenderer
from fovpathtracing_optixcodelatest_tpu_torch import config as pconfig
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes as pscenes
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import gradient_sky_probe
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import build_scene
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import fold_in, prng_key
from fovpathtracing_optixcodelatest_tpu_torch.render import raygen as praygen
from fovpathtracing_optixcodelatest_tpu_torch.render.integrator import trace_paths
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import Renderer

torch.set_num_threads(2)

W, H = 64, 48


def _two_pass(cfg, r=8):
    """The two-pass schedule of the JAX package's graft entry point."""
    return cfg.FoveationSchedule(passes=(
        cfg.FoveationPass(factor=4, spp=2, r_inner=float(r), r_outer=1e9,
                          redraw=False),
        cfg.FoveationPass(factor=1, spp=4, r_inner=0.0, r_outer=float(r + 1),
                          redraw=True, launch_w=2 * (r + 1),
                          launch_h=2 * (r + 1), centered=True,
                          center_offset=r + 1),
    ))


@pytest.fixture(scope="module")
def scenes4():
    meshes, cam = jscenes.box_city(n=4, seed=0)
    jscene = j_build(meshes, probe=j_sky(width=64, height=32))
    pmeshes, pcam = pscenes.box_city(n=4, seed=0)
    pscene = build_scene(pmeshes, gradient_sky_probe(width=64, height=32),
                         device="cpu")
    return jscene, cam, pscene, pcam


@pytest.mark.parametrize("gaze", [(480, 270), (40, 500)])
def test_reference_schedule_rays_match(gaze):
    cam = dataclasses.replace(jscenes.box_city(n=4)[1], aspect=960 / 540)
    pcam = dataclasses.replace(pscenes.box_city(n=4)[1], aspect=960 / 540)
    jcp, pcp = cam.device_params(), pcam.device_params("cpu")
    key = jax.random.fold_in(jax.random.PRNGKey(0), 2)
    total = 0
    for jp, pp in zip(jconfig.FoveationSchedule.reference_32_16_8().passes,
                      pconfig.FoveationSchedule.reference_32_16_8().passes):
        want = jraygen.generate_pass_rays(
            jcp, jp, 960, 540, jnp.int32(gaze[0]), jnp.int32(gaze[1]), key)
        got = praygen.generate_pass_rays(pcp, pp, 960, 540, gaze[0], gaze[1],
                                         np.asarray(key))
        assert np.array_equal(got["ring"].numpy(), np.asarray(want["ring"]))
        assert np.array_equal(got["active"].numpy(), np.asarray(want["active"]))
        assert np.array_equal(got["ray_ids"].numpy(), np.asarray(want["ray_ids"]))
        assert got["offset"] == tuple(int(x) for x in want["offset"])
        assert np.abs(got["direction"].numpy()
                      - np.asarray(want["direction"])).max() <= 1e-6
        count = praygen.pass_ray_count(pp, 960, 540)
        assert got["ray_ids"].numel() == count
        assert count == jraygen.pass_ray_count(jp, 960, 540)
        total += count
    assert total == 1_923_984


def test_trace_paths_per_ray(scenes4):
    jscene, cam, pscene, pcam = scenes4
    w, h = 48, 32
    sched_j = jconfig.FoveationSchedule.uniform(2)
    sched_p = pconfig.FoveationSchedule.uniform(2)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 1)
    jcp = dataclasses.replace(cam, aspect=w / h).device_params()
    pcp = dataclasses.replace(pcam, aspect=w / h).device_params("cpu")
    jr = jraygen.generate_pass_rays(jcp, sched_j.passes[0], w, h,
                                    jnp.int32(w // 2), jnp.int32(h // 2), key)
    pr = praygen.generate_pass_rays(pcp, sched_p.passes[0], w, h, w // 2,
                                    h // 2, np.asarray(key))
    path_key = jax.random.fold_in(key, 5)
    cfg = jconfig.RenderConfig(width=w, height=h)
    want = jax.jit(lambda o, d, a, i: j_trace_paths(
        jscene, o, d, a, path_key, cfg, ray_ids=i))(
        jr["origin"], jr["direction"], jr["active"], jr["ray_ids"])
    # feed the port the JAX rays so the comparison isolates the integrator
    got = trace_paths(
        pscene, torch.tensor(np.asarray(jr["origin"])),
        torch.tensor(np.asarray(jr["direction"])),
        torch.tensor(np.asarray(jr["active"])), np.asarray(path_key),
        pconfig.RenderConfig(width=w, height=h),
        ray_ids=pr["ray_ids"])
    assert int(got["traces"]) == int(want["traces"])
    for f in ("radiance", "alpha", "normal", "albedo"):
        ok = np.isclose(got[f].numpy(), np.asarray(want[f]), rtol=1e-3,
                        atol=1e-5).all(axis=1)
        assert ok.mean() >= 0.99, (f, ok.mean())
    assert (got["alpha"].numpy()[:, 0] > 0).mean() > 0.3


def test_renderer_two_subframes_match_jax(scenes4):
    jscene, cam, pscene, pcam = scenes4
    jr = JRenderer(scene=jscene, config=jconfig.RenderConfig(width=W, height=H),
                   schedule=_two_pass(jconfig))
    jr.set_camera(dataclasses.replace(cam, aspect=W / H))
    pr = Renderer(pscene, pconfig.RenderConfig(width=W, height=H),
                  _two_pass(pconfig), device="cpu")
    pr.set_camera(dataclasses.replace(pcam, aspect=W / H))
    for _ in range(2):
        want = jr.render()
        got = pr.render()
        assert got.shape == (H, W, 3) and got.dtype == np.uint8
        d = np.abs(got.astype(int) - want.astype(int)).max(axis=-1)
        assert (d <= 1).mean() >= 0.99
        assert pr.stats["traces"] == jr.stats["traces"]
        assert pr.stats["rays"] == jr.stats["rays"]
    assert np.array_equal(pr.download_pixels(), got)
    assert pr.subframe == 2
    pr.set_probe(gradient_sky_probe(width=32, height=16))
    assert pr.subframe == 0 and pr.scene.probe.width == 32
    lin = pr.linear_frame()
    assert lin.shape == (H, W, 3) and np.isfinite(lin).all()


def test_render_frame_key_chain(scenes4):
    # Renderer frame keys are fold_in(PRNGKey(seed), subframe)
    _, _, pscene, pcam = scenes4
    r = Renderer(pscene, pconfig.RenderConfig(width=W, height=H),
                 _two_pass(pconfig), seed=4, device="cpu")
    assert np.array_equal(r._key, np.asarray(jax.random.PRNGKey(4)))
    assert np.array_equal(fold_in(prng_key(4), 1),
                          np.asarray(jax.random.fold_in(jax.random.PRNGKey(4), 1)))
    with pytest.raises(RuntimeError):
        r.render()  # no camera yet
