"""The frame's ray generation and film kernels (``csrc/frame.cu``:
``raygen_kernel`` and ``film_kernel``, through ``ops/frame.py`` as
``renderer.kernel_frame_rays`` and ``kernel_film`` call them) against
their plain versions (``renderer.plain_frame_rays``;
``renderer.plain_composite_passes`` with ``film.finalize``).

These tests need an NVIDIA GPU with ``nvcc`` (the kernels have no CPU
mode) and skip without one. They import nothing of JAX:

    python -m pytest -m cuda tests/test_torch_frame_kernels_cuda.py

Tolerance: none. The rays (origin, direction, active, ray ids, each
pass's ring), the canvas and the uint8 frame are compared bit for bit: the
kernels are built with --fmad=false and repeat the plain code's operations
in its order. On the cells' ``reference_32_16_8`` at 960x540 and at
1800x1920 (the headset's eye), with the gaze at the centre, at the
corners and where the centred passes reach into the launch grid's
off-frame band; over subframes 0, 1 and 7, so that the periphery's
progressive lerp and the inner passes' redraw both run against a history.
The slot sums are ``Tensor.sum(1)`` bit for bit at 8, 16 and 32 slots
(and the film at other counts), and whole frames through ``Renderer``
(RGB and spectral) and a stereo pair equal the plain path's.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu_torch.config import (
    FoveationPass,
    FoveationSchedule,
    RenderConfig,
)
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
    gradient_sky_probe,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import build_scene
from fovpathtracing_optixcodelatest_tpu_torch.ops import frame as frame_ops
from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import fold_in, prng_key
from fovpathtracing_optixcodelatest_tpu_torch.parallel.stereo import (
    StereoRenderer,
)
from fovpathtracing_optixcodelatest_tpu_torch.render import (
    film,
    raygen,
    renderer,
)

SIZES = ((960, 540), (1800, 1920))
REF = FoveationSchedule.reference_32_16_8()


def _gazes(w, h):
    return {"centre": (w // 2, h // 2), "top_left": (0, 0),
            "bottom_right": (w - 1, h - 1), "top_right": (w - 1, 0),
            "left_edge": (2, h // 3)}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.fixture(scope="module")
def scene_cam():
    _need_cuda()
    meshes, cam = scenes.box_city(n=3, seed=0)
    scene = build_scene(meshes, gradient_sky_probe(width=256, height=128),
                        device="cuda")
    return scene, cam


def _camp(cam, w, h):
    return dataclasses.replace(cam, aspect=w / h).device_params("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES, ids=("960x540", "1800x1920"))
@pytest.mark.parametrize("gaze", ("centre", "top_left", "bottom_right",
                                  "top_right", "left_edge"))
@pytest.mark.parametrize("antialias", (True, False), ids=("aa", "no_aa"))
def test_rays_match_the_plain_version(scene_cam, size, gaze, antialias):
    _, cam = scene_cam
    w, h = size
    gx, gy = _gazes(w, h)[gaze]
    camp = _camp(cam, w, h)
    key = fold_in(fold_in(prng_key(11), 3), 0)
    config = RenderConfig(width=w, height=h, antialias=antialias)
    kernel_build.reset_launches()
    rays_k, merged_k = renderer.kernel_frame_rays(camp, gx, gy, key, config,
                                                  REF)
    assert kernel_build.LAUNCHES["raygen"] == 1
    rays_p, merged_p = renderer.plain_frame_rays(camp, gx, gy, key, config,
                                                 REF)
    for k in ("origin", "direction", "active", "ray_ids"):
        assert merged_k[k].dtype == merged_p[k].dtype, k
        assert torch.equal(merged_k[k], merged_p[k]), k
    for rk, rp in zip(rays_k, rays_p):
        assert torch.equal(rk["ring"], rp["ring"])
        for k in ("launch", "offset", "spp", "samples_here"):
            assert rk[k] == rp[k], k
        for k in ("origin", "direction", "active", "ray_ids"):
            assert torch.equal(rk[k], rp[k]), k


def _slot_values(schedule, w, h, seed):
    """Each pass's (P, spp, 3) radiance over six decades, some zeros, and
    alpha in [0, 1] with exact 0s and 1s."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    vals = []
    for p in schedule.passes:
        lw, lh = raygen.pass_launch_dims(p, w, h)
        shape = (lw * lh, p.spp, 3)
        rad = torch.exp(torch.empty(shape, device="cuda").uniform_(
            -7.0, 7.0, generator=g))
        rad = torch.where(torch.rand(shape, device="cuda", generator=g)
                          < 0.1, 0.0, rad)
        alpha = torch.rand(shape, device="cuda", generator=g)
        alpha = torch.where(alpha < 0.2, 0.0,
                            torch.where(alpha > 0.7, 1.0, alpha))
        vals.append({"radiance": rad, "alpha": alpha})
    return vals


def _rays_list(camp, schedule, w, h, gx, gy):
    return [raygen.generate_pass_rays(camp, p, w, h, gx, gy, prng_key(0))
            for p in schedule.passes]


def _films_agree(scene, camp, schedule, config, gx, gy, subframes, seed=0):
    """Run the film kernel and the plain film over ``subframes`` from the
    same random history; assert canvas and frame equal after each."""
    w, h = config.width, config.height
    pad = film.schedule_padding(schedule, w, h)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    canvas_p = torch.rand((h + 2 * pad, w + 2 * pad, 3), device="cuda",
                          generator=g) * 4.0
    canvas_k = canvas_p.clone()
    rays_list = _rays_list(camp, schedule, w, h, gx, gy)
    for i, sub in enumerate(subframes):
        vals = _slot_values(schedule, w, h, seed + 10 * i)
        renderer.plain_composite_passes(scene, camp, gx, gy, sub, canvas_p,
                                        rays_list, vals, config, schedule)
        frame_p = film.finalize(canvas_p, pad, config)
        frame_k = renderer.kernel_film(scene, camp, gx, gy, sub, canvas_k,
                                       vals, config, schedule)
        assert torch.equal(canvas_k, canvas_p), f"canvas, subframe {sub}"
        assert torch.equal(frame_k, frame_p), f"frame, subframe {sub}"


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES, ids=("960x540", "1800x1920"))
@pytest.mark.parametrize("gaze", ("centre", "top_left", "bottom_right",
                                  "left_edge"))
def test_film_matches_the_plain_version(scene_cam, size, gaze):
    scene, cam = scene_cam
    w, h = size
    gx, gy = _gazes(w, h)[gaze]
    kernel_build.reset_launches()
    _films_agree(scene, _camp(cam, w, h), REF, RenderConfig(width=w,
                                                            height=h),
                 gx, gy, (0, 1, 7))
    assert kernel_build.LAUNCHES["film"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("change", ("no_exposure", "no_tonemap",
                                    "no_accumulate", "white_stops"))
def test_film_settings_match_the_plain_version(scene_cam, change):
    scene, cam = scene_cam
    w, h = 320, 240
    config = {"no_exposure": RenderConfig(width=w, height=h,
                                          exposure_correction=False),
              "no_tonemap": RenderConfig(width=w, height=h,
                                         tone_mapping=False),
              "no_accumulate": RenderConfig(width=w, height=h,
                                            accumulate=False),
              "white_stops": RenderConfig(width=w, height=h, white=0.37,
                                          exposure_stops=1.3)}[change]
    _films_agree(scene, _camp(cam, w, h), REF.scaled(2), config, 100, 90,
                 (0, 1, 7), seed=5)


@pytest.mark.cuda
@pytest.mark.parametrize("k", (8, 16, 32))
def test_slot_sums_are_tensor_sum(scene_cam, k):
    """One full-frame pass of k slots whose alphas are all 1: its colour is
    the radiance's slot sum over k, a power of two, so the canvas times k
    is the film's slot sum, which must be ``Tensor.sum(1)``'s."""
    scene, cam = scene_cam
    w, h = 640, 360
    sched = FoveationSchedule.uniform(k)
    config = RenderConfig(width=w, height=h)
    pad = film.schedule_padding(sched, w, h)
    canvas = film.new_canvas(w, h, pad, "cuda")
    vals = _slot_values(sched, w, h, seed=k)
    vals[0]["alpha"] = torch.ones_like(vals[0]["alpha"])
    renderer.kernel_film(scene, _camp(cam, w, h), w // 2, h // 2, 0, canvas,
                         vals, config, sched)
    got = canvas[pad: pad + h, pad: pad + w].reshape(-1, 3) * k
    assert torch.equal(got, vals[0]["radiance"].sum(1))


@pytest.mark.cuda
@pytest.mark.parametrize("spp", (1, 3, 5, 12, 64))
def test_film_at_other_slot_counts(scene_cam, spp):
    scene, cam = scene_cam
    w, h = 200, 120
    sched = FoveationSchedule(passes=(
        FoveationPass(factor=2, spp=spp, r_inner=0.0, r_outer=1e9,
                      redraw=False),
        FoveationPass(factor=1, spp=spp, r_inner=0.0, r_outer=30.5,
                      redraw=True, launch_w=62, launch_h=62, centered=True,
                      center_offset=31)))
    _films_agree(scene, _camp(cam, w, h), sched, RenderConfig(width=w,
                                                              height=h),
                 150, 20, (0, 3), seed=spp)


def _frames(scene, cam, config, schedule, kernels, monkeypatch, gazes):
    if not kernels:
        monkeypatch.setattr(renderer, "frame_on_kernels",
                            lambda *a, **k: False)
    r = renderer.Renderer(scene, config, schedule, seed=9, device="cuda")
    r.set_camera(dataclasses.replace(cam, aspect=config.width
                                     / config.height))
    out = [r.render(g) for g in gazes]
    monkeypatch.undo()
    return out, r.linear_frame()


@pytest.mark.cuda
@pytest.mark.parametrize("spectral", (False, True), ids=("rgb", "spectral"))
def test_whole_frames_match_the_plain_path(scene_cam, monkeypatch,
                                           spectral):
    _need_cuda()
    meshes, cam, images = scenes.box_city_textured(n=4, seed=0)
    scene = build_scene(meshes, gradient_sky_probe(width=256, height=128),
                        images, device="cuda")
    config = RenderConfig(width=320, height=240, spectral=spectral)
    sched = REF.scaled(2)
    gazes = [(160, 120)] * 3 + [(10, 200), (300, 5)] + [(160, 120)] * 3
    kernel_build.reset_launches()
    got, lin_k = _frames(scene, cam, config, sched, True, monkeypatch, gazes)
    assert kernel_build.LAUNCHES["raygen"] == kernel_build.LAUNCHES[
        "film"] == len(gazes)
    want, lin_p = _frames(scene, cam, config, sched, False, monkeypatch,
                          gazes)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
    np.testing.assert_array_equal(lin_k, lin_p)


@pytest.mark.cuda
def test_stereo_pairs_match_the_plain_path(scene_cam, monkeypatch):
    scene, cam = scene_cam
    config = RenderConfig(width=180, height=192)
    sched = REF.scaled(10)
    pairs = []
    for kernels in (True, False):
        if not kernels:
            monkeypatch.setattr(renderer, "frame_on_kernels",
                                lambda *a, **k: False)
        sr = StereoRenderer(scene, config, sched, device="cuda")
        left = dataclasses.replace(cam, aspect=180 / 192)
        right = dataclasses.replace(left, eye=tuple(
            np.asarray(left.eye) + np.asarray([0.064, 0.0, 0.0])))
        pairs.append([sr.render(left, right, gaze) for gaze in
                      ((90, 96), (90, 96), (3, 180))])
    for a, b in zip(*pairs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_resources_and_struct_sizes():
    _need_cuda()
    res = frame_ops.resources()
    assert res["struct_bytes"] == {
        "RaygenArgs": ctypes.sizeof(frame_ops.RaygenArgs),
        "FilmArgs": ctypes.sizeof(frame_ops.FilmArgs)}
    for name in ("raygen", "film"):
        assert res[name]["registers"] > 0 and res[name]["blocks_per_sm"] > 0
        assert res[name]["threads"] == 256
