"""The bounce's shading kernels (``csrc/shade.cu``: ``shade_kernel`` and
``resolve_kernel``, through ``render/integrator.py`` ``kernel_bounce``)
against their plain version (``plain_bounce``: ``bounce`` and its scatter)
on the same state and lanes.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels have no CPU
mode) and skip without one. They import nothing of JAX:

    python -m pytest -m cuda tests/test_torch_shade_cuda.py

Tolerance: the masks (``hit_mask``, ``shadow_query``, ``alpha_set``,
``alive``) and ``traces`` exact; every float output of the state (origin,
direction, throughput, eta, radiance, alpha, normal, albedo) bit for bit
on the lanes whose masks agree (``MAX_ULP``; signed zeros count as equal),
since the kernels are built with --fmad=false and repeat the plain
bounce's operations in its order. On a textured and an untextured box
city, a scene of mixed Disney materials (transmission, subsurface,
metallic, clearcoat, emission) under a probe without sample rows, the
catcher scene with its pass-through, and a two-level instance field; at
depth 0 and 1; at ragged lane counts (1, 31, 32, 33, 65,537) and on
lane sets that all miss and all hit. A whole frame rendered both ways
passes the benchmark's limits against itself (``fovbench/limits``: at
most 5% of pixels a channel more than 1 LSB apart, a mean difference of
at most 0.5 LSB).
"""

import dataclasses

import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu_torch.config import (
    FoveationSchedule,
    RenderConfig,
)
from fovpathtracing_optixcodelatest_tpu_torch.models import probe as probe_mod
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
from fovpathtracing_optixcodelatest_tpu_torch.models.material import Material
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
    gradient_sky_probe,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
    build_scene,
    build_scene_instanced,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import fold_in, prng_key
from fovpathtracing_optixcodelatest_tpu_torch.render import integrator
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import Renderer
from fovpathtracing_optixcodelatest_tpu_torch.tools import kernel_times
from fovpathtracing_optixcodelatest_tpu_torch.tools import shade_check

MAX_ULP = 0
W, H = 320, 240  # 76,800 primary lanes
KEY = fold_in(fold_in(prng_key(5), 1), 0)


def _mixed_materials(meshes):
    """Each mesh of a box city a Disney material of its own, so every
    branch of the BSDF is taken somewhere."""
    rng = np.random.default_rng(3)
    out = []
    for i, m in enumerate(meshes):
        mat = Material(
            color=tuple(rng.uniform(0.1, 0.9, 3)),
            emission=tuple(rng.uniform(0.0, 2.0, 3)) if i % 4 == 1
            else (0.0, 0.0, 0.0),
            eta=float(rng.uniform(1.2, 1.8)),
            metallic=float(rng.choice([0.0, 0.5, 1.0])),
            subsurface=float(rng.choice([0.0, 0.6])),
            specular=float(rng.uniform(0.0, 1.0)),
            roughness=float(rng.choice([0.02, 0.3, 1.0])),
            specular_tint=float(rng.uniform(0.0, 1.0)),
            clearcoat=float(rng.choice([0.0, 1.0])),
            clearcoat_gloss=float(rng.uniform(0.0, 1.0)),
            transmission=float(rng.choice([0.0, 0.4, 1.0])))
        out.append(dataclasses.replace(m, material=mat))
    return out


def _scene(kind: str):
    """(scene, camera, config) of each kind on the card."""
    config = RenderConfig(width=W, height=H)
    if kind == "textured":
        meshes, cam, images = scenes.box_city_textured(n=6, seed=0)
        scene = build_scene(meshes, gradient_sky_probe(), images,
                            device="cuda")
    elif kind == "untextured":
        meshes, cam = scenes.box_city(n=4, seed=0)
        scene = build_scene(meshes, gradient_sky_probe(), device="cuda")
    elif kind == "mixed":
        meshes, cam = scenes.box_city(n=4, seed=1)
        old = probe_mod.SAMPLE_ROWS_MAX_TEXELS
        probe_mod.SAMPLE_ROWS_MAX_TEXELS = 0  # the alias arrays' path
        try:
            scene = build_scene(_mixed_materials(meshes),
                                gradient_sky_probe(width=128, height=64),
                                device="cuda")
        finally:
            probe_mod.SAMPLE_ROWS_MAX_TEXELS = old
        assert scene.probe.sample_rows is None
    elif kind == "catcher":
        import chip_smoke

        meshes, cam, images = chip_smoke.catcher_cornell()
        scene = build_scene(meshes, gradient_sky_probe(), images,
                            device="cuda")
        assert scene.has_catcher and config.catcher_passthrough > 0
    elif kind == "instanced":
        inst, cam = kernel_times.instance_field(256)
        scene = build_scene_instanced(inst, gradient_sky_probe(),
                                      device="cuda")
        assert scene.bvh.instanced
    else:
        raise ValueError(kind)
    return scene, dataclasses.replace(cam, aspect=W / H), config


KINDS = ("textured", "untextured", "mixed", "catcher", "instanced")


@pytest.fixture(scope="module", params=KINDS)
def lanes(request):
    """A scene's primary lanes at W x H, and the state and lanes after its
    plain bounce 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    scene, cam, config = _scene(request.param)
    rays = kernel_times.frame_rays(scene, cam, config,
                                   FoveationSchedule.uniform(1))
    o, d, act, ids = rays["primary"]
    st = integrator.PathState.start(o, d, torch.ones_like(o))
    idx = torch.nonzero(act).squeeze(1)
    ids = ids.to(torch.int64).contiguous()
    st1 = shade_check.clone_state(st)
    alive = integrator.plain_bounce(scene, st1, idx, ids, KEY, True, config)
    return {"kind": request.param, "scene": scene, "config": config,
            "st": st, "idx": idx, "ids": ids, "st1": st1,
            "idx1": idx[alive]}


def _check(rep, kind):
    assert shade_check.exact(rep, MAX_ULP), (kind, rep)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 1])
def test_bounce_matches_plain(lanes, depth):
    st, idx = ((lanes["st"], lanes["idx"]) if depth == 0
               else (lanes["st1"], lanes["idx1"]))
    assert idx.numel() > 1000
    kernel_build.reset_launches()
    rep, _, _ = shade_check.bounce_both(
        lanes["scene"], lanes["config"], st, idx, lanes["ids"],
        fold_in(KEY, depth), depth == 0)
    torch.cuda.synchronize()
    _check(rep, lanes["kind"])
    assert kernel_build.LAUNCHES["shade"] == kernel_build.LAUNCHES[
        "resolve"] == 1
    assert 0 < rep["hits"] and 0 < rep["queries"]
    if lanes["kind"] == "catcher" and depth == 1:
        # the pass-through re-traced some lanes, counted in both
        assert rep["traces"][0] > idx.numel() + rep["queries"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 32, 33, 65_537])
def test_bounce_matches_plain_at_ragged_n(lanes, n):
    for depth, st, idx in ((0, lanes["st"], lanes["idx"]),
                           (1, lanes["st1"], lanes["idx1"])):
        sub = idx[:n]
        rep, _, _ = shade_check.bounce_both(
            lanes["scene"], lanes["config"], st, sub, lanes["ids"],
            fold_in(KEY, depth), depth == 0)
        assert rep["lanes"] == min(n, idx.numel())
        _check(rep, (lanes["kind"], depth, n))


def _sky_and_ground(n: int, up: bool):
    """n rays from above the city straight up (all miss) or straight down
    onto it (all hit)."""
    g = torch.Generator().manual_seed(n)
    xz = (torch.rand((n, 2), generator=g) - 0.5) * 20.0
    o = torch.stack([xz[:, 0], torch.full((n,), 60.0), xz[:, 1]], dim=1)
    d = torch.zeros((n, 3))
    d[:, 1] = 1.0 if up else -1.0
    return o.cuda(), d.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("up", [True, False])
def test_all_miss_and_all_hit_lanes(up):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for kind in ("textured", "mixed"):
        scene, _, config = _scene(kind)
        o, d = _sky_and_ground(4097, up)
        st = integrator.PathState.start(o, d, torch.ones_like(o))
        idx = torch.arange(4097, device="cuda")
        ids = torch.arange(4097, device="cuda", dtype=torch.int64)
        for primary in (True, False):
            rep, _, _ = shade_check.bounce_both(scene, config, st, idx, ids,
                                                KEY, primary)
            _check(rep, (kind, up, primary))
            assert rep["hits"] == (0 if up else 4097), rep


def _frame(scene, cam, config, kernels: bool, monkeypatch):
    monkeypatch.setattr(integrator, "shades_on_kernels",
                        lambda *a: kernels)
    r = Renderer(scene, config, FoveationSchedule.reference_32_16_8(),
                 seed=11, device="cuda")
    r.set_camera(cam)
    frames = [r.render() for _ in range(2)]
    return frames[-1]


@pytest.mark.cuda
def test_frame_both_ways_within_the_benchmark_limits(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    meshes, cam, images = scenes.box_city_textured(n=6, seed=0)
    scene = build_scene(meshes, gradient_sky_probe(), images, device="cuda")
    config = RenderConfig(width=480, height=270)
    cam = dataclasses.replace(cam, aspect=480 / 270)
    kernel_build.reset_launches()
    got = _frame(scene, cam, config, True, monkeypatch)
    assert kernel_build.LAUNCHES["shade"] == 2 * config.max_depth
    want = _frame(scene, cam, config, False, monkeypatch)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    px_over = float((diff > 1).any(axis=-1).mean())
    mean_abs = float(diff.mean())
    assert px_over <= 0.05 and mean_abs <= 0.5, (px_over, mean_abs)


@pytest.mark.cuda
def test_shade_resources():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fovpathtracing_optixcodelatest_tpu_torch.ops import shade

    res = shade.resources()
    # at least two blocks of 256 threads resident per SM; ptxas spills
    # nothing, and the only local memory is shade's 32-byte scratch of
    # libdevice's sinf/cosf reduction of large arguments
    assert all(r["blocks_per_sm"] >= 2 and r["threads"] == 256
               for r in res.values()), res
    assert res["shade"]["local_bytes"] <= 32, res
    assert res["resolve"]["local_bytes"] == 0, res
    log = kernel_build.BUILD_INFO["log"]["shade"]
    assert log.count(" 0 bytes spill stores") == 2, log
