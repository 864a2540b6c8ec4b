"""The JAX package's traversal entry points under their own names in the
port (``ops/traverse8.py``, ``ops/pallas_traverse.py``), and the repairs of
fault 35 (names and argument orders the port lacked), against the JAX
package on the CPU.

- On box_city n=4 (JAX's table carried across bit for bit), the port's
  ``traverse8.closest_hit`` and ``closest_hit_staged`` against JAX's
  ``closest_hit`` (JAX's staged walk gives its result, which JAX's own
  tests pin), and ``traverse8.occluded`` against JAX's
  ``occluded`` on a partial mask: ``hit``, ``tri_id`` and the occlusion
  answer exact, ``t`` within 1 ulp (ROADMAP §3: no FMA contraction moves
  it on box_city), ``pending`` all False.
- On a DFS table with treelets of 24 rows (built bit for bit alike in
  both packages), the port's ``closest_hit_treelet`` against JAX's
  ``closest_hit`` (JAX's treelet walk gives the plain walk's result, which
  its own tests pin), ``occluded_treelet`` against the port's
  ``occluded``, and ``use_treelet`` against JAX's at two row bounds.
- ``pallas_traverse.occluded_packets`` on the legacy table against JAX's
  Pallas kernel in interpret mode on one 1,024-ray packet.
- Each argument that changes JAX's answer in a way the port does not
  reproduce raises ``NotImplementedError`` naming its TPU schedule; the
  schedule-only ones leave the answer as it is.
- One test each of fault 35's repairs: ``models/probe.luminance``,
  ``DemandContext.num_pages``, ``WideBVH.instanced``,
  ``bvh_native.collapse_native``, ``generate_pass_rays`` and
  ``pass_backplate`` called positionally in JAX's order, and
  ``build_scene``'s positional ``leaf_size``/``arity``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu import config as jconfig
from fovpathtracing_optixcodelatest_tpu.models import demand as jdemand
from fovpathtracing_optixcodelatest_tpu.models import probe as jprobe
from fovpathtracing_optixcodelatest_tpu.models import scenes as jscenes
from fovpathtracing_optixcodelatest_tpu.models.mesh import (
    host_triangles as j_host_triangles,
)
from fovpathtracing_optixcodelatest_tpu.models.probe import (
    gradient_sky_probe as j_sky,
)
from fovpathtracing_optixcodelatest_tpu.models.scene import build_scene as j_build
from fovpathtracing_optixcodelatest_tpu.ops import bvh8 as jbvh8
from fovpathtracing_optixcodelatest_tpu.ops import bvh_native as jbvh_native
from fovpathtracing_optixcodelatest_tpu.ops import pallas_traverse as jpallas
from fovpathtracing_optixcodelatest_tpu.ops import tlas as jtlas
from fovpathtracing_optixcodelatest_tpu.ops import traverse8 as jtraverse8
from fovpathtracing_optixcodelatest_tpu.render import raygen as jraygen
from fovpathtracing_optixcodelatest_tpu.render import renderer as jrenderer
from fovpathtracing_optixcodelatest_tpu_torch import config as pconfig
from fovpathtracing_optixcodelatest_tpu_torch.models import demand, probe
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes as pscenes
from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import host_triangles
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
    DeviceBVH,
    build_scene,
    scene_from_arrays,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import (
    bvh8,
    bvh_native,
    pallas_traverse,
    tlas,
    traverse8,
)
from fovpathtracing_optixcodelatest_tpu_torch.render import raygen, renderer
from test_instancing import _grid_scene
from test_torch_instancing import to_port_scene
from test_torch_textures import jax_scene_arrays

torch.set_num_threads(2)

TMIN, TMAX = 0.01, 1e16


def _ulps(a, b):
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def _city_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform((-35.0, 0.0, -35.0), (35.0, 20.0, 35.0), (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def city():
    """box_city n=4 in both packages, the port's from JAX's arrays, and
    its triangles."""
    meshes = jscenes.box_city(n=4, seed=0)[0]
    jscene = j_build(meshes, probe=j_sky(width=64, height=32))
    pscene = scene_from_arrays(jax_scene_arrays(jscene), device="cpu")
    return jscene, pscene, j_host_triangles(meshes)


def _closest_against(got, want, name):
    assert set(got) == {"t", "tri_id", "u", "v", "hit", "pending"}, name
    got = {k: v.numpy() for k, v in got.items()}
    for k in ("hit", "tri_id"):
        assert np.array_equal(got[k], np.asarray(want[k])), (name, k)
    hit = got["hit"]
    assert 0.05 < hit.mean() < 1.0 and not got["pending"].any()
    assert _ulps(got["t"][hit], np.asarray(want["t"])[hit]).max() <= 1, name


def test_closest_hit_and_occluded_on_box_city_match_jax(city):
    jscene, pscene, _ = city
    o, d = _city_rays(4096, 1)
    want = jtraverse8.closest_hit(jscene.bvh, o, d, TMIN, TMAX)
    for fn in (traverse8.closest_hit, traverse8.closest_hit_staged):
        _closest_against(fn(pscene.bvh, o, d, TMIN, TMAX), want, fn.__name__)
    active = np.random.default_rng(2).random(o.shape[0]) < 0.7
    jocc = np.asarray(jtraverse8.occluded(jscene.bvh, o, d, TMIN, 40.0,
                                          active=jnp.asarray(active)))
    occ = traverse8.occluded(pscene.bvh, o, d, TMIN, 40.0,
                             active=active).numpy()
    assert np.array_equal(occ, jocc) and 0.05 < occ.mean() < 0.7


@pytest.fixture(scope="module")
def treelet_tables(city):
    """box_city n=4 as a DFS table with treelets of 24 rows in both
    packages (the JAX one and the port's upload)."""
    tris = city[2]
    want = jbvh8.build(tris, 6, 16, dfs=True, treelet_budget=24)
    got = bvh8.build(tris, 6, 16, dfs=True, treelet_budget=24)
    assert np.array_equal(np.asarray(want.table).view(np.uint32),
                          got.table.view(np.uint32)) and got.top_rows > 0
    return want, DeviceBVH.upload(got, "cpu")


def test_treelet_entry_points_give_the_full_walk(treelet_tables,
                                                monkeypatch):
    jb, pb = treelet_tables
    o, d = _city_rays(4096, 3)
    want = jtraverse8.closest_hit(jb, o, d, TMIN, TMAX)
    _closest_against(traverse8.closest_hit_treelet(pb, o, d, TMIN, TMAX),
                     want, "closest_hit_treelet")
    assert torch.equal(traverse8.occluded_treelet(pb, o, d, TMIN, 40.0),
                       traverse8.occluded(pb, o, d, TMIN, 40.0))
    for bound in (0, 10_000):
        monkeypatch.setattr(jtraverse8, "TREELET_MAX_ROWS", bound)
        monkeypatch.setattr(traverse8, "TREELET_MAX_ROWS", bound)
        assert traverse8.use_treelet(pb) == jtraverse8.use_treelet(jb) \
            == (bound > 0)


def test_treelet_entry_points_take_treelet_tables_only(city):
    pb = city[1].bvh
    o, d = _city_rays(16, 4)
    assert not traverse8.use_treelet(pb)
    for fn in (traverse8.closest_hit_treelet, traverse8.occluded_treelet):
        with pytest.raises(ValueError, match="treelet"):
            fn(pb, o, d, TMIN, TMAX)


def test_occluded_packets_matches_the_pallas_kernel(city):
    tris = city[2]
    jleg = jbvh8.build_legacy8(tris)
    leg = bvh8.build_legacy8(tris)
    pb = DeviceBVH(table=torch.from_numpy(leg.table),
                   stack_depth=leg.stack_depth, arity=leg.arity,
                   leaf_size=leg.leaf_size)
    o, d = _city_rays(1024, 5)
    active = np.random.default_rng(6).random(1024) < 0.8
    want = np.asarray(jpallas.occluded_packets(
        jleg, o, d, TMIN, 30.0, active=jnp.asarray(active), interpret=True))
    got = pallas_traverse.occluded_packets(pb, o, d, TMIN, 30.0,
                                           active=active, interpret=True)
    assert np.array_equal(got.numpy(), want) and 0.05 < want.mean() < 0.8


@pytest.mark.parametrize("fn,kw,schedule", [
    ("closest_hit", {"t_seed": np.ones(8, np.float32)}, "re-trace"),
    ("closest_hit", {"iter_cap": 4}, "phase-1"),
    ("closest_hit", {"entry0": np.zeros(8, np.uint32)}, "treelet"),
    ("closest_hit", {"max_steps": 10}, "loop bound"),
    ("closest_hit_staged", {"max_steps": 10}, "loop bound"),
    ("occluded", {"iter_cap": 4}, "phase-1"),
    ("occluded", {"return_pending": True}, "re-trace"),
    ("occluded", {"return_pops": True}, "pop counts"),
    ("occluded", {"entry0": np.zeros(8, np.uint32)}, "treelet"),
    ("occluded", {"max_steps": 10}, "loop bound"),
])
def test_result_changing_arguments_raise(city, fn, kw, schedule):
    o, d = _city_rays(8, 7)
    with pytest.raises(NotImplementedError, match=schedule):
        getattr(traverse8, fn)(city[1].bvh, o, d, TMIN, TMAX, **kw)


def test_schedule_arguments_leave_the_answer(city):
    pb = city[1].bvh
    o, d = _city_rays(512, 8)
    ref = traverse8.closest_hit(pb, o, d, TMIN, TMAX)
    got = traverse8.closest_hit(pb, o, d, TMIN, TMAX, None, 200_000, 1024,
                                window=True)
    staged = traverse8.closest_hit_staged(pb, o, d, TMIN, TMAX,
                                          phase1_cap=2, phase1_stack=3)
    for k in ref:
        assert torch.equal(got[k], ref[k]) and torch.equal(staged[k], ref[k])
    assert torch.equal(
        traverse8.occluded(pb, o, d, TMIN, 40.0, chunk=None, window=True),
        traverse8.occluded(pb, o, d, TMIN, 40.0))


# ---------------------------------------------------------------------------
# fault 35: names and argument orders the port lacked
# ---------------------------------------------------------------------------


def test_probe_luminance_is_jax_models_probe_luminance():
    rgb = np.random.default_rng(9).random((64, 3)).astype(np.float32)
    np.testing.assert_allclose(probe.luminance(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jprobe.luminance(jnp.asarray(rgb))),
                               rtol=1e-6)


def test_demand_context_num_pages_is_the_atlas_slot_count():
    img = np.random.default_rng(10).random((256, 192, 3)).astype(np.float32)
    loader = demand.DemandLoader(max_pages=8, device="cpu")
    jloader = jdemand.DemandLoader(max_pages=8)
    loader.create_texture(img)
    jloader.create_texture(img)
    ctx, jctx = loader.launch_prepare(), jloader.launch_prepare()
    assert ctx.num_pages == jctx.num_pages == 8
    assert ctx.total_pages == 12 != ctx.num_pages


def test_wide_bvh_instanced_as_jax():
    jsc = _grid_scene(2, 2, rot=True)
    jtwo = jtlas.build_instanced(*jtlas.scene_tables_from_instanced(jsc))
    two = tlas.build_instanced(*tlas.scene_tables_from_instanced(
        to_port_scene(jsc)))
    tris = host_triangles(pscenes.box_city(n=2, seed=0)[0])
    assert two.instanced == jtwo.instanced is True
    assert bvh8.build(tris).instanced == jbvh8.build(tris).instanced is False


def test_collapse_native_is_jax_collapse_native(city):
    tris = city[2]
    got = bvh_native.collapse_native(tris, 6, 16)
    want = jbvh_native.collapse_native(tris, 6, 16)
    assert got is not None and want is not None
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_generate_pass_rays_and_pass_backplate_in_jax_order(city):
    jscene, pscene, _ = city
    w, h, gx, gy = 96, 64, 40, 30
    cam = dataclasses.replace(jscenes.box_city(n=4)[1], aspect=w / h)
    pcam = dataclasses.replace(pscenes.box_city(n=4)[1], aspect=w / h)
    jcp, pcp = cam.device_params(), pcam.device_params("cpu")
    jp = jconfig.FoveationSchedule.reference_32_16_8().scaled(8).passes[1]
    pp = pconfig.FoveationSchedule.reference_32_16_8().scaled(8).passes[1]
    key = jax.random.fold_in(jax.random.PRNGKey(4), 1)
    ids = [1, 2]
    # (camera, p, width, height, gaze_x, gaze_y, key, antialias,
    # sample_ids, ray_id_base, sampler), every one positional
    want = jraygen.generate_pass_rays(jcp, jp, w, h, jnp.int32(gx),
                                      jnp.int32(gy), key, True,
                                      jnp.asarray(ids, jnp.int32), 5,
                                      "random")
    got = raygen.generate_pass_rays(pcp, pp, w, h, gx, gy, np.asarray(key),
                                    True, torch.tensor(ids), 5, "random")
    for f in ("active", "ray_ids", "ring"):
        assert np.array_equal(got[f].numpy(), np.asarray(want[f])), f
    assert np.abs(got["direction"].numpy()
                  - np.asarray(want["direction"])).max() <= 1e-6
    # (scene, camera, rays, width, height, p, gaze_x, gaze_y)
    jback = jrenderer.pass_backplate(jscene, jcp, want, w, h, jp,
                                     jnp.int32(gx), jnp.int32(gy))
    back = renderer.pass_backplate(pscene, pcp, got, w, h, pp, gx, gy)
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(jback).reshape(back.shape),
                               rtol=1e-5, atol=1e-6)


def test_build_scene_takes_leaf_size_and_arity_positionally():
    meshes = pscenes.box_city(n=2, seed=0)[0]
    jmeshes = jscenes.box_city(n=2, seed=0)[0]
    # (meshes, probe, texture_images, leaf_size, arity)
    got = build_scene(meshes, None, None, 12, 32, device="cpu").bvh
    want = j_build(jmeshes, None, None, 12, 32).bvh
    assert (got.leaf_size, got.arity) == (want.leaf_size, want.arity) \
        == (12, 32)
    assert np.array_equal(got.table.numpy().view(np.uint32),
                          np.asarray(want.table).view(np.uint32))
    assert bvh8.WIDTH == jbvh8.WIDTH
