"""The PyTorch port against the JAX package's golden image and foveation
checks (``tests/test_golden.py``), on the CPU.

The port's open-scene render is held to the committed
``tests/golden/open_scene_48x36_u4.npz`` at the JAX test's thresholds (SSIM
> 0.98, mean abs < 4 LSB); this file only reads ``tests/golden/``. The
foveated frame's fovea agrees with the uniform render (blurred SSIM at a
different seed, bit for bit at the same seed and equal spp), the inner
pass's margin covers the periphery's blocks (sentinel canvas), and the
periphery shows its 4x4 block structure.
"""

import dataclasses
import os

import numpy as np
import torch

import chip_smoke
from fovpathtracing_optixcodelatest_tpu_torch.config import (
    FoveationPass,
    FoveationSchedule,
    RenderConfig,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import constant_probe
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import build_scene
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import prng_key
from fovpathtracing_optixcodelatest_tpu_torch.render import film
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import render_frame
from fovpathtracing_optixcodelatest_tpu_torch.utils.metrics import (
    _uniform_filter,
    ssim,
)

torch.set_num_threads(2)

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden",
                           "open_scene_48x36_u4.npz")


def _scene():
    meshes, cam = chip_smoke.open_scene()
    return build_scene(meshes, constant_probe((2.5, 2.5, 2.5)),
                       device="cpu"), cam


def _render(schedule, w=48, h=36, seed=0):
    scene, cam = _scene()
    return chip_smoke.golden_frame(scene, cam, RenderConfig(width=w, height=h),
                                   schedule, seed=seed)


def test_golden_open_scene_uniform():
    assert chip_smoke.GOLDEN == os.path.abspath(GOLDEN_PATH)
    frame = _render(FoveationSchedule.uniform(4))
    golden = np.load(GOLDEN_PATH)["frame"]
    assert frame.shape == golden.shape == (36, 48, 3)
    s = ssim(frame / 255.0, golden / 255.0)
    assert s > 0.98, f"golden SSIM {s}"
    assert np.abs(frame.astype(int) - golden.astype(int)).mean() < 4.0


def test_foveated_matches_uniform_in_fovea():
    w, h, r, spp = 48, 36, 12, 16
    fov_sched = chip_smoke.fovea_schedule(r, spp)
    frames_f = _render(fov_sched, w, h, seed=1)
    frames_u = _render(FoveationSchedule.uniform(spp), w, h, seed=2)
    cx, cy, rr = w // 2, h // 2, r - 4  # inside the ring boundary
    crop = np.s_[cy - rr: cy + rr, cx - rr: cx + rr]
    fov_crop = _uniform_filter(frames_f[crop] / 255.0, 3)
    uni_crop = _uniform_filter(frames_u[crop] / 255.0, 3)
    assert ssim(fov_crop, uni_crop) > 0.6
    assert abs(fov_crop.mean() - uni_crop.mean()) < 0.06
    assert np.abs(fov_crop - uni_crop).mean() < 0.08
    # pixel-keyed random numbers: at the same key the equal-spp fovea is
    # the uniform render, bit for bit
    frames_f2 = _render(fov_sched, w, h, seed=2)
    np.testing.assert_array_equal(frames_f2[crop], frames_u[crop])


def _coverage_sentinel(margin, w=48, h=36, r=10):
    """Pixels of one foveated frame that no pass wrote (sentinel canvas)."""
    sched = FoveationSchedule(passes=(
        FoveationPass(factor=4, spp=1, r_inner=float(r), r_outer=1e9,
                      redraw=False),
        FoveationPass(factor=1, spp=1, r_inner=0.0, r_outer=float(r + margin),
                      redraw=True, launch_w=2 * (r + margin),
                      launch_h=2 * (r + margin), centered=True,
                      center_offset=r + margin),
    ))
    scene, cam = _scene()
    pad = film.schedule_padding(sched, w, h)
    sentinel = -7.0
    canvas = film.new_canvas(w, h, pad, "cpu") + sentinel
    canvas, _, _ = render_frame(
        scene, dataclasses.replace(cam, aspect=w / h).device_params("cpu"),
        w // 2, h // 2, 0, canvas, prng_key(0),
        RenderConfig(width=w, height=h), sched)
    crop = canvas[pad: pad + h, pad: pad + w].numpy()
    return int((crop == sentinel).all(axis=-1).sum())


def test_ring_coverage_margin():
    # the inner pass must overlap the periphery by its block diagonal
    assert _coverage_sentinel(margin=6) == 0
    assert _coverage_sentinel(margin=1) > 0  # too little leaves holes


def test_periphery_block_structure():
    w, h, r = 48, 36, 10
    sched = FoveationSchedule(passes=(
        FoveationPass(factor=4, spp=1, r_inner=float(r), r_outer=1e9,
                      redraw=False),
        FoveationPass(factor=1, spp=2, r_inner=0.0, r_outer=float(r + 6),
                      redraw=True, launch_w=2 * (r + 6), launch_h=2 * (r + 6),
                      centered=True, center_offset=r + 6),
    ))
    frame = _render(sched, w, h)
    for block in (frame[0:4, 0:4], frame[32:36, 44:48]):
        assert (block == block[0, 0]).all()
