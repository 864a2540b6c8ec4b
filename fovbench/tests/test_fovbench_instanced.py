"""A render-time-instanced scene through the harness: ``box_city_tiled``'s
instance table built two-level by the port and checked against the
reference's flattened world on the CPU at a tiny size; ``flatten`` against
the port's ``InstancedScene.flatten``; the generator's one-tile world
against ``box_city_fast``; and the flat configurations' scenes as before."""

import json
import os

import numpy as np
import pytest

from conftest import BENCH, REPO, TINY_LIMITS, tiny_tree
from fovbench import harness, instances
from fovbench.scenes import box_city_fast, box_city_tiled

TILED = {"generator": "box_city_tiled", "n": 2, "tiles": 2, "seed": 0,
         "spread": 40.0, "palette": 8}


def tiled_tree(dst: str) -> str:
    """``conftest.tiny_tree``'s tree (64x36, the scaled schedule) with its
    configuration's scene replaced by ``box_city_tiled`` n=2 on 2 x 2
    tiles. Returns its ``fovbench/`` directory."""
    fb = tiny_tree(dst, n=2)
    path = os.path.join(fb, "configs", "tiny.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["geometry"] = dict(TILED)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return fb


@pytest.mark.parametrize("mix", ["fixate", "stereo_saccade"])
def test_an_instanced_run_agrees_with_the_flattened_reference(tmp_path, mix):
    tiny = tiled_tree(str(tmp_path))
    res, info = harness.run_cell(tiny, f"tiny.{mix}", 2 ** 31 + 25, 0.3,
                                 False, "cpu")
    lim = TINY_LIMITS["limits"]
    assert res["checks"] == {k: {"value": res["checks"][k]["value"],
                                 "limit": v} for k, v in lim.items()}
    assert res["correct"] and res["failed"] == 0, res["checks"]
    # the table holds one block; the world is its four placements
    block = 12 * 2 ** 2 + 12
    assert info["triangles"] == block
    assert info["world_triangles"] == 4 * block
    assert info["instances"] == 4
    assert info["checked_pixels"] >= 16


def _port_scene(meshes, table):
    from fovpathtracing_optixcodelatest_tpu_torch.models.instance import (
        Instance, InstancedScene)
    from fovpathtracing_optixcodelatest_tpu_torch.models.material import (
        Material)
    from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import HostMesh

    host = [HostMesh(vertex=m["vertex"], index=m["index"], normal=m["normal"],
                     texcoord=m["texcoord"],
                     material=Material(**m["material"]),
                     diffuse_texture_id=m["texture_id"]) for m in meshes]
    return InstancedScene(unique=host, textures=[], instances=[
        Instance(mesh_ids=tuple(i["mesh_ids"]), transform=i["transform"])
        for i in table])


def _ulps(a, b):
    """Largest distance in float32 units in the last place."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


def test_flatten_matches_the_ports():
    meshes, _, _, table = box_city_tiled.generate(**{
        k: v for k, v in TILED.items() if k != "generator"})
    # a turn that is not a quarter, so that the normals' inverse transpose
    # and renormalisation do real work
    a = np.deg2rad(30.0)
    skew = np.array([[np.cos(a), 0, np.sin(a), 3.5], [0, 1.5, 0, -0.25],
                     [-np.sin(a), 0, np.cos(a), 7.0], [0, 0, 0, 1]])
    table = table + [{"mesh_ids": [0, 2], "transform": skew}]
    want = _port_scene(meshes, table).flatten()
    got = instances.flatten(meshes, table)
    assert len(got) == len(want) == 4 * len(meshes) + 2
    for g, w in zip(got, want):
        assert _ulps(g["vertex"], w.vertex) <= 1
        assert _ulps(g["normal"], w.normal) <= 1
        assert np.array_equal(g["index"], w.index)
        assert np.array_equal(g["texcoord"], w.texcoord)


def test_one_unturned_tile_is_box_city_fast():
    """On the first seed whose one tile draws no turn."""
    seed = next(s for s in range(100) if box_city_tiled.generate(
        n=1, tiles=1, seed=s)[3][0]["transform"][0, 0] == 1)
    args = dict(n=3, seed=seed, spread=40.0, palette=8, texture_size=16)
    want, want_cam, want_img = box_city_fast.generate(**args)
    meshes, camera, images, table = box_city_tiled.generate(**args, tiles=1)
    assert camera == want_cam and len(table) == 1
    assert np.array_equal(table[0]["transform"], np.eye(4))
    assert all(np.array_equal(a, b) for a, b in zip(images, want_img))
    for world in (meshes, instances.flatten(meshes, table)):
        assert len(world) == len(want)
        for g, w in zip(world, want):
            assert set(g) == set(w)
            for k in ("vertex", "index", "normal", "texcoord"):
                assert g[k].dtype == w[k].dtype
                assert np.array_equal(g[k], w[k]), k
            assert g["material"] == w["material"]
            assert g["texture_id"] == w["texture_id"]


def test_the_tiles_turn_by_quarters_from_the_seed():
    _, _, _, table = box_city_tiled.generate(n=2, tiles=3, seed=9)
    turns = {tuple(i["transform"][0, [0, 2]]) for i in table}
    assert turns <= {(1, 0), (0, 1), (-1, 0), (0, -1)} and len(turns) > 1
    spots = sorted((i["transform"][0, 3], i["transform"][2, 3]) for i in table)
    assert spots == sorted((x, z) for x in (-80.0, 0.0, 80.0)
                           for z in (-80.0, 0.0, 80.0))
    _, _, _, again = box_city_tiled.generate(n=2, tiles=3, seed=9)
    assert all(np.array_equal(a["transform"], b["transform"])
               for a, b in zip(table, again))


@pytest.mark.parametrize("name", ["boxcity262k", "boxcity10m",
                                  "questpro262k"])
def test_the_flat_configurations_have_no_table(name):
    """Each configuration's own generators and keys, the box count and
    texture size cut (the 10M scene's arrays are about a gigabyte): no
    table, and ``generate_scene`` gives the generator's meshes as before."""
    bench = harness.load_json(os.path.join(REPO, "BENCHMARK.json"))
    cfg = harness.config_of(BENCH, bench, name)
    cfg["geometry"]["n"] = 4
    if cfg["textures"]:
        cfg["textures"]["size"] = 16
    meshes, camera, images, probe, table = harness.generate_with_table(cfg)
    assert table is None
    geo = dict(cfg["geometry"])
    assert geo.pop("generator") == "box_city_fast"
    want = box_city_fast.generate(
        **geo, texture_size=cfg["textures"]["size"] if cfg["textures"]
        else None)
    for got in ((meshes, camera, images),
                harness.generate_scene(cfg)[:3]):
        assert got[1] == want[1] and len(got[0]) == len(want[0])
        assert all(np.array_equal(a, b) for a, b in zip(got[2], want[2]))
        for g, w in zip(got[0], want[0]):
            assert all(np.array_equal(g[k], w[k]) for k in
                       ("vertex", "index", "normal", "texcoord"))
    assert np.array_equal(harness.generate_scene(cfg)[3], probe)
