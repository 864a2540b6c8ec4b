"""Which path a frame's ray generation and film take, and the C interface
of their kernels (``csrc/frame.cu``, ``ops/frame.py``), on the CPU.

``renderer.frame_on_kernels`` sends CUDA frames of whole passes of the
``random`` sampler (or none, without antialiasing) and no AOV canvases to
the kernels, spectral and demand-textured frames included, and everything
else to the plain versions. Each caller asks it the question that fits:
``Renderer.render`` and ``StereoRenderer.render`` (through
``render_frame``) take both kernels, ``render_frame_aov`` the raygen
kernel and the plain film, the multi-device frames the plain raygen (each
rank traces a slice of the slots) and the film kernel on the joined
values, ``render_pass_partial`` the plain raygen. The callers are driven on CPU
tensors with the predicate answering as on the card and the kernels'
wrappers replaced by their plain versions, so the frames must come out as
the plain path's. The argument structs ``ops/frame.py`` packs have the
fields, order and types ``csrc/frame.cu`` declares, carry the passes'
grids, offsets and radii, the key words, the film's box, blend flags and
tone-map constants, and the packing refuses other tensors and shapes.
"""

import dataclasses
import os
import re
import sys

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
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import (
    fold_in,
    key_words,
    prng_key,
)
from fovpathtracing_optixcodelatest_tpu_torch.parallel import tiles
from fovpathtracing_optixcodelatest_tpu_torch.parallel.stereo import (
    StereoRenderer,
)
from fovpathtracing_optixcodelatest_tpu_torch.render import (
    film,
    raygen,
    renderer,
)
from fovpathtracing_optixcodelatest_tpu_torch.utils import tracing
from torch_stand_in_kernels import stand_in_kernels  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "fovpathtracing_optixcodelatest_tpu_torch", "csrc")
CUDA = torch.device("cuda")  # only compared against, never allocated on
W, H = 48, 32
SCHED = FoveationSchedule.reference_32_16_8().scaled(8)


@pytest.fixture(scope="module")
def textured():
    meshes, cam, images = scenes.box_city_textured(n=3, seed=0)
    scene = build_scene(meshes, gradient_sky_probe(width=64, height=32),
                        images, device="cpu")
    return scene, dataclasses.replace(cam, aspect=W / H)


@pytest.mark.parametrize("case,kernels", [
    ("rgb", True), ("cpu", False), ("stratified", False),
    ("blue_noise", False), ("stratified_no_aa", True),
    ("blue_noise_no_aa", True), ("sample_ids", False), ("aov", False),
    ("spectral", True), ("oracle", True),
])
def test_frame_predicate(case, kernels):
    config, device, kw = RenderConfig(), CUDA, {}
    if case == "cpu":
        device = torch.device("cpu")
    elif case in ("stratified", "blue_noise"):
        config = RenderConfig(sampler=case)
    elif case.endswith("_no_aa"):
        config = RenderConfig(sampler=case[:-6], antialias=False)
    elif case == "sample_ids":
        kw["sample_ids_per_pass"] = [
            torch.arange(p.spp)
            for p in FoveationSchedule.reference_32_16_8().passes]
    elif case == "aov":
        kw["aov_canvas"] = {"normal": None}
    elif case == "spectral":
        config = RenderConfig(spectral=True)
    elif case == "oracle":
        config = RenderConfig(traversal="oracle")
    assert renderer.frame_on_kernels(device, config, **kw) is kernels


def test_a_schedule_the_kernels_do_not_take_fails_loudly(textured,
                                                         monkeypatch):
    """Nine passes on the kernels' path raise before any launch; they do
    not fall back to the plain path."""
    scene, cam = textured
    monkeypatch.setattr(renderer, "frame_on_kernels", lambda *a, **k: True)
    r = renderer.Renderer(scene, RenderConfig(width=W, height=H, max_depth=1),
                          FoveationSchedule(passes=SCHED.passes * 3),
                          device="cpu")
    r.set_camera(cam)
    before = dict(kernel_build.LAUNCHES)
    with pytest.raises(ValueError, match="9 passes"):
        r.render()
    assert kernel_build.LAUNCHES == before


# --- the callers, with the kernels' wrappers replaced by their plain versions


def _plain_film(scene, camera, gaze_x, gaze_y, subframe, canvas, slot_values,
                config, schedule):
    rays_list = [raygen.generate_pass_rays(
        camera, p, config.width, config.height, gaze_x, gaze_y,
        prng_key(0)) for p in schedule.passes]
    renderer.plain_composite_passes(scene, camera, gaze_x, gaze_y, subframe,
                                    canvas, rays_list, slot_values, config,
                                    schedule)
    pad = film.schedule_padding(schedule, config.width, config.height)
    return film.finalize(canvas, pad, config)


@pytest.fixture
def as_on_the_card(monkeypatch):
    """The predicate answers for CPU tensors as for CUDA ones; the
    kernels' paths run their plain versions; returns the calls made."""
    calls = {"raygen": 0, "film": 0}
    real = renderer.frame_on_kernels

    def predicate(device, *args, **kwargs):
        return real(CUDA, *args, **kwargs)

    def gen(*args):
        calls["raygen"] += 1
        return renderer.plain_frame_rays(*args)

    def flm(*args):
        calls["film"] += 1
        return _plain_film(*args)

    monkeypatch.setattr(renderer, "frame_on_kernels", predicate)
    monkeypatch.setattr(renderer, "kernel_frame_rays", gen)
    monkeypatch.setattr(renderer, "kernel_film", flm)
    return calls


def _counted(fn):
    before = tracing.snapshot()
    out = fn()
    got = tracing.diff(before, tracing.snapshot())
    return out, got["raygen"], got["film"]


def _renderer(scene, cam, config):
    r = renderer.Renderer(scene, config, SCHED, seed=3, device="cpu")
    r.set_camera(cam)
    return r


@pytest.mark.parametrize("sampler,antialias,kernels", [
    ("random", True, True), ("random", False, True),
    ("stratified", True, False), ("blue_noise", True, False),
])
def test_renderer_frames_by_sampler(textured, as_on_the_card, monkeypatch,
                                    sampler, antialias, kernels):
    scene, cam = textured
    config = RenderConfig(width=W, height=H, max_depth=2, sampler=sampler,
                          antialias=antialias)
    frame, rg, fl = _counted(_renderer(scene, cam, config).render)
    path = "kernel" if kernels else "plain"
    assert rg == {path: 1} and fl == {path: 1}
    assert as_on_the_card == {"raygen": int(kernels), "film": int(kernels)}
    # the same frame as the plain path's
    monkeypatch.setattr(renderer, "frame_on_kernels", lambda *a, **k: False)
    want = _renderer(scene, cam, config).render()
    np.testing.assert_array_equal(frame, want)


def test_accumulating_frames_match_the_plain_path(textured, as_on_the_card,
                                                  monkeypatch):
    scene, cam = textured
    config = RenderConfig(width=W, height=H, max_depth=2)
    r = _renderer(scene, cam, config)
    got = [r.render((5, 4)) for _ in range(3)]
    assert as_on_the_card == {"raygen": 3, "film": 3}
    monkeypatch.setattr(renderer, "frame_on_kernels", lambda *a, **k: False)
    r = _renderer(scene, cam, config)
    for g in got:
        np.testing.assert_array_equal(g, r.render((5, 4)))


def test_aov_frames_take_the_plain_film(textured, as_on_the_card):
    scene, cam = textured
    r = _renderer(scene, cam, RenderConfig(width=W, height=H, max_depth=2))
    _, rg, fl = _counted(r.render_aov)
    assert rg == {"kernel": 1} and fl == {"plain": 1}
    assert as_on_the_card == {"raygen": 1, "film": 0}


def test_stereo_pairs_take_both_kernels(textured, as_on_the_card):
    scene, cam = textured
    sr = StereoRenderer(scene, RenderConfig(width=W, height=H, max_depth=2),
                        SCHED, device="cpu")
    _, rg, fl = _counted(lambda: sr.render(cam, cam))
    assert rg == {"kernel": 2} and fl == {"kernel": 2}
    assert as_on_the_card == {"raygen": 2, "film": 2}


def test_sharded_frames_take_the_plain_raygen(textured, as_on_the_card):
    scene, cam = textured
    config = RenderConfig(width=W, height=H, max_depth=2)
    pad = film.schedule_padding(SCHED, W, H)
    canvas = film.new_canvas(W, H, pad, "cpu")
    _, rg, fl = _counted(lambda: tiles.render_frame_sharded(
        scene, cam.device_params("cpu"), W // 2, H // 2, 0, canvas,
        prng_key(0), config, SCHED, tiles.make_mesh(["cpu"] * 2)))
    # the ranks trace slices of the slots; their joined values are whole
    assert rg == {"plain": 2} and fl == {"kernel": 1}
    assert as_on_the_card == {"raygen": 0, "film": 1}


def test_partial_passes_take_the_plain_raygen(textured, as_on_the_card):
    scene, cam = textured
    config = RenderConfig(width=W, height=H, max_depth=1)
    renderer.render_pass_partial(scene, cam.device_params("cpu"),
                                 SCHED.passes[0], W, H, W // 2, H // 2,
                                 prng_key(0), config,
                                 sample_ids=torch.arange(2))
    assert as_on_the_card == {"raygen": 0, "film": 0}


@pytest.mark.parametrize("kind", ["spectral", "demand"])
def test_spectral_and_demand_frames_take_both_kernels(as_on_the_card, kind):
    if kind == "spectral":
        meshes, cam, images = scenes.box_city_textured(n=2, seed=0)
        scene = build_scene(meshes, gradient_sky_probe(width=32, height=16),
                            images, device="cpu")
        config = RenderConfig(width=W, height=H, max_depth=2, spectral=True)
    else:
        from fovpathtracing_optixcodelatest_tpu_torch.models.demand import (
            DemandLoader,
        )

        meshes, cam, images = scenes.box_city_textured(n=2, seed=0)
        loader = DemandLoader(64, device="cpu")
        for image in images:
            loader.create_texture(image)
        scene = build_scene(meshes, gradient_sky_probe(width=32, height=16),
                            device="cpu", demand=loader.launch_prepare())
        config = RenderConfig(width=W, height=H, max_depth=2)
    cam = dataclasses.replace(cam, aspect=W / H)
    _, rg, fl = _counted(_renderer(scene, cam, config).render)
    assert rg == {"kernel": 1} and fl == {"kernel": 1}


# --- the sources


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def test_constants_match_the_sources():
    grid = _read("pass_grid.cuh")
    assert f"kMaxPasses = {frame_ops.MAX_PASSES};" in grid
    assert f"kRngStride = {raygen.RNG_STRIDE};" in grid
    assert f"kOffBand = {raygen.OFF_BAND};" in grid
    assert (frame_ops.RNG_STRIDE, frame_ops.OFF_BAND) == (raygen.RNG_STRIDE,
                                                         raygen.OFF_BAND)
    # the counter hash is shared, not copied
    assert "uint32_t mix(" in _read("rng.cuh")
    for src in ("shade.cu", "frame.cu"):
        assert '#include "rng.cuh"' in _read(src)
        assert "uint32_t mix(" not in _read(src)


def test_kernel_names_count_as_shading_not_traversal(textured,
                                                     stand_in_kernels):
    sys.path.insert(0, REPO)
    try:
        from fovbench.metrics import traversal_ms
    finally:
        sys.path.remove(REPO)
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                       r"(\w+)\s*\(", _read("frame.cu"))
    assert sorted(names) == ["film_kernel", "raygen_kernel"]
    assert not any(traversal_ms.is_traversal(n) for n in names)
    assert not traversal_ms.is_traversal(
        "(anonymous namespace)::film_kernel(FilmArgs)")
    assert "frame" in kernel_build.SOURCES
    # a launch counts under the kernel's name
    camp = textured[1].device_params("cpu")
    grids = renderer.pass_grids(SCHED, W, H, 3, 4)
    frame_ops.generate_rays(camp, grids, W, H, 3, 4, prng_key(0), True)
    assert kernel_build.LAUNCHES == {"raygen": 1}
    assert stand_in_kernels.calls[0][0] == "fov_raygen"


def test_raygen_packing(textured):
    _, cam = textured
    camp = cam.device_params("cpu")
    key = fold_in(prng_key(4), 2)
    gx, gy = 3, H - 2  # the centred passes reach off the frame
    grids = renderer.pass_grids(SCHED, W, H, gx, gy)
    args, out = frame_ops.raygen_inputs(camp, grids, W, H, gx, gy, key, True)
    rays = [raygen.generate_pass_rays(camp, p, W, H, gx, gy, key)
            for p in SCHED.passes]
    n = sum(r["ray_ids"].numel() for r in rays)
    assert args.n == n == out["origin"].shape[0]
    assert (args.key0, args.key1) == key_words(key)
    assert (args.width, args.height, args.gaze_x, args.gaze_y) == (W, H, gx,
                                                                   gy)
    assert args.antialias == 1 and args.num_passes == len(SCHED.passes)
    ray0 = ring0 = 0
    for i, (p, r) in enumerate(zip(SCHED.passes, rays)):
        g = args.passes[i]
        assert (args.ray_base[i], args.ring_base[i]) == (ray0, ring0)
        assert (g.lw, g.lh) == r["launch"] and (g.ox, g.oy) == r["offset"]
        assert (g.factor, g.spp) == (p.factor, p.spp)
        assert g.r_inner == np.float32(p.r_inner)
        assert g.r_outer == np.float32(p.r_outer)
        ray0 += r["ray_ids"].numel()
        ring0 += r["ring"].numel()
    assert out["ring"].numel() == ring0
    for k in ("origin", "direction", "active", "ray_ids", "ring"):
        assert getattr(args, k) == out[k].data_ptr()
    assert args.eye == camp.eye.data_ptr() and args.w == camp.w.data_ptr()
    assert out["ray_ids"].dtype == torch.int64
    assert frame_ops.raygen_inputs(camp, grids, W, H, gx, gy, key,
                                   False)[0].antialias == 0


def _slot_values(schedule):
    vals = []
    for p in schedule.passes:
        lw, lh = raygen.pass_launch_dims(p, W, H)
        vals.append({f: torch.rand((lw * lh, p.spp, 3))
                     for f in ("radiance", "alpha")})
    return vals


def test_film_packing(textured):
    scene, cam = textured
    camp = cam.device_params("cpu")
    config = RenderConfig(width=W, height=H, exposure_stops=3.0, white=0.7)
    pad = film.schedule_padding(SCHED, W, H)
    canvas = film.new_canvas(W, H, pad, "cpu")
    gx, gy = 1, 2
    vals = _slot_values(SCHED)
    for subframe, blends in ((0, [0, 0, 0]), (6, [1, 0, 0])):
        args, frame = frame_ops.film_inputs(**renderer.film_arguments(
            scene, camp, gx, gy, subframe, canvas, vals, config, SCHED))
        assert [args.passes[i].blend for i in range(3)] == blends
    assert args.passes[0].lerp == np.float32(1.0) / np.float32(7.0)
    assert frame.shape == (H, W, 3) and frame.dtype == torch.uint8
    assert args.frame == frame.data_ptr() and args.canvas == \
        canvas.data_ptr()
    assert (args.canvas_h, args.canvas_w, args.pad) == (H + 2 * pad,
                                                        W + 2 * pad, pad)
    assert (args.probe_h, args.probe_w) == (32, 64)
    assert args.probe == scene.probe.data.data_ptr()
    assert args.exposure_scale == 8.0
    assert args.inv_white == np.float32(1.0) / np.float32(0.7)
    assert (args.exposure_on, args.tonemap_on) == (1, 1)
    for i, v in enumerate(vals):
        assert args.passes[i].radiance == v["radiance"].data_ptr()
        assert args.passes[i].alpha == v["alpha"].data_ptr()
    # the box: the crop and every pass's region
    xs, ys = [pad, pad + W], [pad, pad + H]
    for p in SCHED.passes:
        lw, lh = raygen.pass_launch_dims(p, W, H)
        ox, oy = raygen.pass_offset(p, gx, gy)
        xs += [pad + ox, pad + ox + lw * p.factor]
        ys += [pad + oy, pad + oy + lh * p.factor]
    assert (args.box_x0, args.box_y0, args.box_x1, args.box_y1) == (
        min(xs), min(ys), max(xs), max(ys))
    off = dataclasses.replace(config, exposure_correction=False,
                              tone_mapping=False, accumulate=False)
    args, _ = frame_ops.film_inputs(**renderer.film_arguments(
        scene, camp, gx, gy, 6, canvas, vals, off, SCHED))
    assert (args.exposure_on, args.tonemap_on, args.passes[0].blend) == (
        0, 0, 0)


@pytest.mark.parametrize("fault", [
    "strided", "dtype", "device", "camera", "slots", "canvas", "passes",
    "spp", "region", "ids"])
def test_packing_refuses_what_the_kernels_do_not_take(textured, fault):
    scene, cam = textured
    camp = cam.device_params("cpu")
    config = RenderConfig(width=W, height=H)
    schedule = SCHED
    pad = film.schedule_padding(schedule, W, H)
    canvas = film.new_canvas(W, H, pad, "cpu")
    vals = _slot_values(schedule)
    if fault == "strided":
        v = vals[1]["radiance"]
        vals[1]["radiance"] = torch.cat([v, v], 1)[:, ::2]
    elif fault == "dtype":
        vals[0]["alpha"] = vals[0]["alpha"].double()
    elif fault == "device":
        vals[2]["alpha"] = torch.zeros(vals[2]["alpha"].shape,
                                       device="meta")
    elif fault == "camera":  # the basis on another device than the canvas
        camp = dataclasses.replace(camp, u=torch.zeros(3, device="meta"))
    elif fault == "slots":  # a slice of the slots, not the whole pass
        vals[0]["radiance"] = vals[0]["radiance"][:, :2].contiguous()
    elif fault == "canvas":
        canvas = film.new_canvas(W, H, pad + 1, "cpu")
    elif fault == "passes":
        schedule = FoveationSchedule(passes=SCHED.passes * 3)
    elif fault == "spp":
        schedule = FoveationSchedule.uniform(65)
    elif fault == "region":  # a centred pass wider than the padding
        p = FoveationPass(factor=1, spp=1, r_inner=0.0, r_outer=1e9,
                          redraw=True, launch_w=4 * W, launch_h=4,
                          centered=True, center_offset=2 * W)
        grids = renderer.pass_grids(FoveationSchedule(passes=(p,)), W, H, 0,
                                    0)
        with pytest.raises(ValueError, match="leaves the padded canvas"):
            frame_ops.film_box(grids, pad, W, H)
        return
    if fault == "ids":
        with pytest.raises(ValueError, match="overflows"):
            frame_ops.raygen_inputs(
                camp, renderer.pass_grids(FoveationSchedule.uniform(1),
                                          20000, 20000, 0, 0),
                20000, 20000, 0, 0, prng_key(0), True)
        return
    if fault in ("passes", "spp"):
        with pytest.raises(ValueError):
            frame_ops.raygen_inputs(
                camp, renderer.pass_grids(schedule, W, H, 20, 16), W, H, 20,
                16, prng_key(0), True)
    with pytest.raises(ValueError):
        frame_ops.film_inputs(**renderer.film_arguments(
            scene, camp, 20, 16, 1, canvas, vals, config, schedule))


def test_diff_reads_tables_without_the_new_groups():
    old = {"frames": 1, "ns": {}, "ns_total": {}, "syncs": {}, "lanes": {},
           "shade": {"kernel": 4}}
    new = tracing.snapshot()
    got = tracing.diff(old, new)
    assert set(got) >= {"raygen", "film"}
    assert tracing.diff(old, old)["raygen"] == {}
