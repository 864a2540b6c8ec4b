"""The port's sample-parallel frames (``parallel/tiles.py``) on 8 ranks on
the CPU (``["cpu"] * 8``), against the port's single-device frame and the
JAX package's ``render_frame``; ``render_pass_partial`` and
``generate_pass_rays(sample_ids=)`` against the JAX package.

Tolerances: the sharded frame and canvas against the port's single-device
ones: equal, bit for bit (the ranks' per-slot values are summed once, as
the single-device frame sums them; measured equal), also after 3
accumulated subframes; the traces count exact. Against JAX, the port's
existing gates (``test_torch_render.py``): frames 99% of the pixels within
1 LSB, the traces count exact; ray ids, active and ring masks exact, ray
directions within 1e-6; per-pixel sums rtol 1e-3 / atol 1e-5 on 99% of the
pixels. Disjoint ``render_pass_partial`` slices add up to the whole pass's
sums within 1e-6 relative (a regrouped float sum rounds differently).
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
from fovpathtracing_optixcodelatest_tpu.render import film as jfilm
from fovpathtracing_optixcodelatest_tpu.render import raygen as jraygen
from fovpathtracing_optixcodelatest_tpu.render import renderer as jrenderer
from fovpathtracing_optixcodelatest_tpu_torch import config as pconfig
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
    gradient_sky_probe,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import build_scene
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import fold_in, prng_key
from fovpathtracing_optixcodelatest_tpu_torch.parallel import tiles
from fovpathtracing_optixcodelatest_tpu_torch.render import film, raygen
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
    render_frame,
    render_pass_partial,
)

torch.set_num_threads(2)

W, H = 48, 36
MESH = ["cpu"] * 8


def _odd(cfg):
    """spp 3 and 5 on 8 ranks: the padded slots of an uneven split."""
    return cfg.FoveationSchedule(passes=(
        cfg.FoveationPass(factor=4, spp=3, r_inner=8.0, r_outer=1e9,
                          redraw=False),
        cfg.FoveationPass(factor=1, spp=5, r_inner=0.0, r_outer=9.0,
                          redraw=True, launch_w=18, launch_h=18,
                          centered=True, center_offset=9),
    ))


@pytest.fixture(scope="module")
def cornell():
    meshes, cam = scenes.cornell(sphere_subdiv=1)
    scene = build_scene(meshes, gradient_sky_probe(width=64, height=32),
                        device="cpu")
    camp = dataclasses.replace(cam, aspect=W / H).device_params("cpu")
    return scene, camp


@pytest.fixture(scope="module")
def jcornell():
    meshes, cam = jscenes.cornell(sphere_subdiv=1)
    scene = j_build(meshes, probe=j_sky(width=64, height=32))
    return scene, dataclasses.replace(cam, aspect=W / H).device_params()


def _both(scene, camp, sched, gaze, key, subframes=1):
    """The single-device and the 8-rank frames over ``subframes``
    accumulated subframes (key fold_in(key, i))."""
    cfg = pconfig.RenderConfig(width=W, height=H)
    pad = film.schedule_padding(sched, W, H)
    c1 = film.new_canvas(W, H, pad, "cpu")
    c2 = c1.clone()
    mesh = tiles.make_mesh(MESH)
    fn = tiles.make_sharded_renderer(cfg, sched, mesh)
    for i in range(subframes):
        k = fold_in(key, i) if subframes > 1 else key
        c1, f1, s1 = render_frame(scene, camp, *gaze, i, c1, k, cfg, sched)
        c2, f2, t2 = fn(scene, camp, *gaze, i, c2, k)
    return (c1, f1, s1), (c2, f2, t2)


def _jax_frame(jscene, jcamp, sched, gaze, key):
    cfg = jconfig.RenderConfig(width=W, height=H)
    canvas = jfilm.new_canvas(W, H, jfilm.schedule_padding(sched, W, H))
    _, frame, stats = jrenderer.render_frame(
        jscene, jcamp, jnp.int32(gaze[0]), jnp.int32(gaze[1]), jnp.int32(0),
        canvas, key, cfg, sched)
    return np.asarray(frame), int(stats["traces"])


def _within_1lsb(a, b) -> float:
    return float((np.abs(a.astype(int) - b.astype(int)).max(-1) <= 1).mean())


def test_make_mesh_and_sample_slices():
    mesh = tiles.make_mesh(MESH)
    assert mesh == [torch.device("cpu")] * 8
    # rank r holds r*ceil(spp/n) + [0, ceil(spp/n)): every slot once
    for spp in (1, 3, 5, 8, 32):
        ids = torch.cat([tiles._device_sample_ids(spp, 8, r)
                         for r in range(8)])
        assert ids.tolist() == list(range(8 * -(-spp // 8)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tiles.make_mesh()


@pytest.mark.parametrize("name", ["uniform8", "odd_spp"])
def test_sharded_frame_equals_single_and_jax(name, cornell, jcornell):
    scene, camp = cornell
    if name == "uniform8":
        sched, jsched = (pconfig.FoveationSchedule.uniform(8),
                         jconfig.FoveationSchedule.uniform(8))
        gaze, seed = (24, 18), 7
    else:
        sched, jsched, gaze, seed = _odd(pconfig), _odd(jconfig), (20, 16), 3
    key = np.asarray(jax.random.PRNGKey(seed))
    (c1, f1, s1), (c2, f2, t2) = _both(scene, camp, sched, gaze, key)
    assert torch.equal(f1, f2) and torch.equal(c1, c2)
    assert int(s1["traces"]) == int(t2)
    want, traces = _jax_frame(*jcornell, jsched, gaze, jax.random.PRNGKey(seed))
    assert _within_1lsb(f2.numpy(), want) >= 0.99
    assert int(t2) == traces


def test_sharded_accumulation_three_subframes(cornell):
    scene, camp = cornell
    (c1, f1, _), (c2, f2, _) = _both(
        scene, camp, pconfig.FoveationSchedule.uniform(8), (24, 18),
        prng_key(11), subframes=3)
    # JAX's test holds the canvas within 1e-6; here it is exact
    assert torch.equal(f1, f2) and torch.equal(c1, c2)


@pytest.mark.parametrize("sampler", ["random", "stratified", "blue_noise"])
def test_pass_rays_over_sample_slices_match_jax(sampler):
    cam = dataclasses.replace(scenes.cornell()[1], aspect=W / H)
    jcam = dataclasses.replace(jscenes.cornell()[1], aspect=W / H)
    key = jax.random.fold_in(jax.random.PRNGKey(5), 0)
    p = _odd(pconfig).passes[1]
    jp = _odd(jconfig).passes[1]
    full = raygen.generate_pass_rays(cam.device_params("cpu"), p, W, H, 20,
                                     16, np.asarray(key), sampler=sampler)
    n_pix = 18 * 18
    for ids in ([0, 1], [2, 3], [4, 5], [6]):  # 4 ranks; slots 5, 6 pad
        got = raygen.generate_pass_rays(
            cam.device_params("cpu"), p, W, H, 20, 16, np.asarray(key),
            sampler=sampler, sample_ids=torch.tensor(ids))
        want = jraygen.generate_pass_rays(
            jcam.device_params(), jp, W, H, jnp.int32(20), jnp.int32(16),
            key, sampler=sampler, sample_ids=jnp.asarray(ids, jnp.int32))
        for f in ("active", "ray_ids", "ring"):
            assert np.array_equal(got[f].numpy(), np.asarray(want[f])), f
        assert np.abs(got["direction"].numpy()
                      - np.asarray(want["direction"])).max() <= 1e-6
        assert got["samples_here"] == len(ids) and got["spp"] == 5
        # the slots below spp are the full pass's rays for those slots
        real = [i for i in ids if i < 5]
        sel = (torch.arange(n_pix)[:, None] * 5
               + torch.tensor(real, dtype=torch.int64)[None, :]).reshape(-1)
        mine = (torch.arange(n_pix)[:, None] * len(ids)
                + torch.arange(len(real))[None, :]).reshape(-1)
        for f in ("direction", "active", "ray_ids"):
            assert torch.equal(got[f][mine], full[f][sel]), f
        pad_lanes = torch.tensor([i >= 5 for i in ids]).repeat(n_pix)
        assert not got["active"][pad_lanes].any()


def test_render_pass_partial_matches_jax(cornell, jcornell):
    scene, camp = cornell
    jscene, jcamp = jcornell
    sched, jsched = _odd(pconfig), _odd(jconfig)
    cfg = pconfig.RenderConfig(width=W, height=H)
    jcfg = jconfig.RenderConfig(width=W, height=H)
    pass_key = jax.random.fold_in(jax.random.PRNGKey(2), 1)
    p, jp = sched.passes[1], jsched.passes[1]
    whole = render_pass_partial(scene, camp, p, W, H, 20, 16,
                                np.asarray(pass_key), cfg)
    parts = [render_pass_partial(scene, camp, p, W, H, 20, 16,
                                 np.asarray(pass_key), cfg,
                                 sample_ids=torch.tensor(ids))
             for ids in ([0, 1], [2, 3], [4, 5])]
    for i in (0, 1):
        added = sum(x[i] for x in parts)
        scale = whole[i].abs().max().item()
        assert (added - whole[i]).abs().max().item() <= 1e-6 * scale
    assert sum(int(x[3]) for x in parts) == int(whole[3])
    jfn = jax.jit(lambda: jrenderer.render_pass_partial(
        jscene, jcamp, jp, W, H, jnp.int32(20), jnp.int32(16), pass_key,
        jcfg, sample_ids=jnp.asarray([2, 3], jnp.int32)))
    want = jfn()
    got = parts[1]
    assert int(got[3]) == int(want[3])
    for g, w in ((got[0], want[0]), (got[1], want[1]),
                 (got[4]["normal"], want[4]["normal"]),
                 (got[4]["albedo"], want[4]["albedo"])):
        ok = np.isclose(g.numpy(), np.asarray(w), rtol=1e-3,
                        atol=1e-5).all(axis=1)
        assert ok.mean() >= 0.99
