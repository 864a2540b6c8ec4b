"""The port's scene-sharded frames (``parallel/scene_shard.py``) on 8
ranks on the CPU: ``tri_pack`` padded and cut into 8 row blocks.

Tolerances: ``pad_scene_rows`` equals the JAX package's bit for bit; the
block walk of ``take_tri_pack`` equals the whole table's gather bit for
bit (texture id -1 and the material ids included); the sharded frame,
canvas and traces, and ``Renderer(multichip="scene")``'s frames, equal the
single-device ones bit for bit (measured equal).
"""

import dataclasses

import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu.models import scenes as jscenes
from fovpathtracing_optixcodelatest_tpu.models.probe import (
    gradient_sky_probe as j_sky,
)
from fovpathtracing_optixcodelatest_tpu.models.scene import build_scene as j_build
from fovpathtracing_optixcodelatest_tpu.parallel import (
    scene_shard as j_scene_shard,
)
from fovpathtracing_optixcodelatest_tpu_torch.config import (
    FoveationSchedule,
    RenderConfig,
)
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
    gradient_sky_probe,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import build_scene
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import prng_key
from fovpathtracing_optixcodelatest_tpu_torch.parallel import (
    scene_shard,
    tiles,
)
from fovpathtracing_optixcodelatest_tpu_torch.render import film
from fovpathtracing_optixcodelatest_tpu_torch.render.integrator import (
    take_tri_pack,
)
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
    Renderer,
    render_frame,
)

torch.set_num_threads(2)

W, H = 48, 36
MESH = tiles.make_mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def city():
    meshes, cam = scenes.box_city(n=3, seed=2)
    scene = build_scene(meshes, gradient_sky_probe(width=64, height=32),
                        device="cpu")
    return scene, dataclasses.replace(cam, aspect=W / H), meshes


@pytest.mark.parametrize("n_dev", [8, 7])
def test_pad_scene_rows_matches_jax(city, n_dev):
    # 120 triangles: no padding on 8 ranks, 6 zero rows on 7
    scene, _, _ = city
    jmeshes, _ = jscenes.box_city(n=3, seed=2)
    jscene = j_build(jmeshes, probe=j_sky(width=64, height=32))
    padded = scene_shard.pad_scene_rows(scene, n_dev)
    want = np.asarray(
        j_scene_shard.pad_scene_rows(jscene, n_dev).geom.tri_pack)
    got = padded.tri_pack.numpy()
    assert got.shape == want.shape and got.shape[0] % n_dev == 0
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert (padded is scene) == (scene.num_triangles % n_dev == 0)
    assert scene_shard.pad_scene_rows(padded, n_dev) is padded
    mesh = tiles.make_mesh(["cpu"] * n_dev)
    ranks = scene_shard.shard_scene(padded, mesh)
    t_pad = got.shape[0]
    for r, rs in enumerate(ranks):
        # each rank holds t_pad / n_dev rows, its own
        assert rs.tri_pack.shape[0] == t_pad // n_dev and rs.pack_rank == r
        rows = padded.tri_pack[r * t_pad // n_dev:(r + 1) * t_pad // n_dev]
        # compared as bits: the texture id -1 is a NaN in float32
        assert torch.equal(rs.tri_pack.view(torch.int32),
                           rows.contiguous().view(torch.int32))
        # the replicated arrays are copied once a device: one copy here
        assert rs.bvh is ranks[0].bvh
    if n_dev == 7:
        with pytest.raises(ValueError, match="pad_scene_rows"):
            scene_shard.shard_scene(scene, mesh)


def test_take_tri_pack_over_blocks_is_the_whole_gather(city):
    scene, _, _ = city
    padded = scene_shard.pad_scene_rows(scene, 8)
    ranks = scene_shard.shard_scene(padded, MESH)
    rng = np.random.default_rng(0)
    tri = torch.as_tensor(rng.integers(0, scene.num_triangles, 4000))
    whole = take_tri_pack(padded, tri)
    col = 12 + 22  # the material flags
    for rs in ranks:
        got = take_tri_pack(rs, tri)
        assert torch.equal(got.view(torch.int32), whole.view(torch.int32))
        flags = take_tri_pack(rs, tri, col)
        assert torch.equal(flags.view(torch.int32),
                           padded.tri_pack[tri, col].view(torch.int32))
    tex = whole[:, 10].contiguous().view(torch.int32)
    assert (tex == -1).all()  # the untextured city: every texture id -1
    assert (whole[:, 9].contiguous().view(torch.int32) > 0).any()


def test_scene_sharded_frame_equals_single(city):
    scene, cam, _ = city
    cfg = RenderConfig(width=W, height=H, max_depth=3)
    sched = FoveationSchedule.uniform(8)
    camp = cam.device_params("cpu")
    pad = film.schedule_padding(sched, W, H)
    canvas = film.new_canvas(W, H, pad, "cpu")
    key = prng_key(7)
    c1, f1, s1 = render_frame(scene, camp, 24, 18, 0, canvas.clone(), key,
                              cfg, sched)
    padded = scene_shard.pad_scene_rows(scene, 8)
    c2, f2, t2 = scene_shard.render_frame_scene_sharded(
        padded, camp, 24, 18, 0, canvas.clone(), key, cfg, sched, MESH)
    assert torch.equal(f1, f2) and torch.equal(c1, c2)
    assert int(s1["traces"]) == int(t2)


@pytest.mark.parametrize("multichip", ["scene", "samples"])
def test_renderer_multichip_matches_single(city, multichip):
    scene, cam, _ = city
    cfg = RenderConfig(width=W, height=H, max_depth=2)
    sched = FoveationSchedule.uniform(8)
    r1 = Renderer(scene, cfg, sched, device="cpu")
    r2 = Renderer(scene, cfg, sched, device="cpu", multichip=multichip,
                  mesh=["cpu"] * 8)
    for r in (r1, r2):
        r.set_camera(cam)
    for _ in range(2):
        assert np.array_equal(r1.render(), r2.render())
        assert r1.stats["traces"] == r2.stats["traces"]
    assert torch.equal(r1.canvas, r2.canvas)
    if multichip == "scene":
        assert r2.scene.tri_pack.shape[0] % 8 == 0
    with pytest.raises(ValueError, match="demand"):
        Renderer(scene, cfg, sched, device="cpu", multichip=multichip,
                 demand_loader=object())
