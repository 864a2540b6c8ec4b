"""The PyTorch port's render-time instancing (two-level tables,
``ops/tlas.py``) against the JAX package on the CPU.

Tolerances: the tables (``table``, ``leaf_perm``, ``stack_depth``,
``inst_base``, ``blas_base``) and ``tri_pack`` bit for bit; traversal
``hit``, ``tri_id``, ``inst`` and the occlusion answer exact, ``t`` within
rtol 2e-5 / atol 1e-4 (the JAX instancing test's bound) and u/v within
2e-5 absolute: XLA on the CPU contracts the transform and the
Möller-Trumbore products into FMAs while the port rounds every operation
(measured on the 5x5 grid's 4,096 rays: no ray disagrees on hit, tri_id or
inst; t at most 17 ulp, 8.1e-6 absolute; u/v at most 7.9e-6). The
integrator: per-ray values within rtol 1e-3 / atol 1e-5 on at least 99%
of the rays (measured 100%), ``traces`` exact. The same walk tolerances
hold on a table whose instances enter their BLAS at a leaf row (the
kernels test that row in the instance entry's own step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu.config import RenderConfig as JConfig
from fovpathtracing_optixcodelatest_tpu.models import instance as jinstance
from fovpathtracing_optixcodelatest_tpu.models.material import (
    Material as JMaterial,
)
from fovpathtracing_optixcodelatest_tpu.models.mesh import (
    make_icosphere as j_icosphere,
)
from fovpathtracing_optixcodelatest_tpu.models.probe import (
    constant_probe as j_constant,
)
from fovpathtracing_optixcodelatest_tpu.models.scene import (
    build_scene_instanced as j_build_instanced,
)
from fovpathtracing_optixcodelatest_tpu.ops import tlas as jtlas
from fovpathtracing_optixcodelatest_tpu.ops import traverse8
from fovpathtracing_optixcodelatest_tpu.render.integrator import (
    trace_paths as j_trace_paths,
)
from fovpathtracing_optixcodelatest_tpu_torch.config import RenderConfig
from fovpathtracing_optixcodelatest_tpu_torch.models import instance as pinstance
from fovpathtracing_optixcodelatest_tpu_torch.models.material import Material
from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import make_box
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import constant_probe
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
    build_scene,
    build_scene_instanced,
    scene_arrays_instanced,
    scene_from_arrays,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import tlas, traverse
from fovpathtracing_optixcodelatest_tpu_torch.render.integrator import trace_paths
from fovpathtracing_optixcodelatest_tpu_torch.tools import kernel_times
from test_instancing import _grid_scene, _rays_grid, _rot_y, _translate
from test_torch_catcher_aov import to_jax_meshes
from test_torch_textures import jax_scene_arrays
from torch_blas_fields import leaf_root, small_blas_field

torch.set_num_threads(2)

TMIN, TMAX = 0.01, 1e16
CFG = (JConfig(width=16, height=16), RenderConfig(width=16, height=16))


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.uint32)


def to_port_scene(jsc):
    """A JAX ``InstancedScene`` as the port's (same arrays)."""
    from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import HostMesh

    unique = [HostMesh(vertex=m.vertex, index=m.index, normal=m.normal,
                       texcoord=m.texcoord,
                       material=Material(**dataclasses.asdict(m.material)),
                       diffuse_texture_id=m.diffuse_texture_id)
              for m in jsc.unique]
    return pinstance.InstancedScene(
        unique=unique,
        instances=[pinstance.Instance(i.mesh_ids, i.transform)
                   for i in jsc.instances],
        textures=list(jsc.textures))


def _jax_field():
    """The JAX test's 1,000-instance field, from the JAX package."""
    ball = j_icosphere((0.0, 0.0, 0.0), 0.45, 2,
                       JMaterial(color=(0.7, 0.7, 0.7), roughness=0.9))
    return jinstance.instanced([ball], [
        (0, _translate((i % 32) * 1.2, ((i // 32) % 8) * 1.3,
                       (i // 256) * 1.4)) for i in range(1000)])


@pytest.mark.parametrize("case", ["grid", "field"])
def test_two_level_tables_bit_exact(case):
    if case == "grid":
        jsc = _grid_scene(5, 5, rot=True)
        psc = to_port_scene(jsc)
    else:
        jsc = _jax_field()
        psc = kernel_times.instance_field()[0]
        assert psc.num_world_triangles == 320_000
    want = jtlas.build_instanced(*jtlas.scene_tables_from_instanced(jsc))
    got = tlas.build_instanced(*tlas.scene_tables_from_instanced(psc))
    assert np.array_equal(_bits(want.table), _bits(got.table))
    assert np.array_equal(np.asarray(want.leaf_perm), got.leaf_perm)
    for f in ("stack_depth", "num_instances", "inst_base", "blas_base",
              "arity", "leaf_size"):
        assert getattr(want, f) == getattr(got, f), f
    if case == "field":
        # one sphere's BLAS beside 1,000 instance rows and their TLAS
        assert got.num_instances == 1000 and got.num_rows < 1450
        assert got.num_rows - got.blas_base < 120
    # the scene around it: the unique meshes' tri_pack
    jscene = j_build_instanced(jsc, probe=j_constant((2.0,) * 3))
    arrays = scene_arrays_instanced(psc, constant_probe((2.0,) * 3))
    assert np.array_equal(_bits(jscene.geom.tri_pack),
                          _bits(arrays["tri_pack"]))
    assert np.array_equal(_bits(jscene.bvh.table), _bits(arrays["bvh_table"]))


@pytest.fixture(scope="module")
def grid5():
    jscene = j_build_instanced(_grid_scene(5, 5, rot=True),
                               probe=j_constant((2.0,) * 3))
    pscene = scene_from_arrays(jax_scene_arrays(jscene), device="cpu")
    o, d = _rays_grid(4096, seed=3, extent=7.0)
    return jscene, pscene, o, d


def test_scene_from_arrays_carries_the_instanced_scene(grid5):
    jscene, pscene, _, _ = grid5
    b = pscene.bvh
    assert b.instanced and jscene.bvh.instanced
    assert (b.num_instances, b.inst_base, b.blas_base, b.stack_depth) == (
        jscene.bvh.num_instances, jscene.bvh.inst_base,
        jscene.bvh.blas_base, jscene.bvh.stack_depth)
    assert pscene.num_triangles == jscene.num_triangles == 12 + 80


def test_instanced_closest_hit_matches_jax(grid5):
    jscene, pscene, o, d = grid5
    want = traverse8.closest_hit(jscene.bvh, o, d, TMIN, TMAX)
    b = pscene.bvh
    stats = {}
    got = traverse.closest_hit_plain(
        b.table, torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)),
        torch.ones(o.shape[0], dtype=torch.bool), TMIN, TMAX, *b.walk_args,
        stats=stats, **b.instance_kwargs)
    hit = got["hit"].numpy()
    for f in ("hit", "tri_id", "inst"):
        assert np.array_equal(got[f].numpy(), np.asarray(want[f])), f
    assert 0.1 < hit.mean() < 0.9
    assert (got["inst"].numpy()[~hit] == -1).all()
    np.testing.assert_allclose(got["t"].numpy()[hit],
                               np.asarray(want["t"])[hit], rtol=2e-5,
                               atol=1e-4)
    for f in ("u", "v"):
        np.testing.assert_allclose(got[f].numpy()[hit],
                                   np.asarray(want[f])[hit], rtol=0,
                                   atol=2e-5)
    # each hit entered at least one instance; rows per kind are counted
    assert stats["inst_rows"] >= hit.sum() and stats["leaf_rows"] > 0


def test_instanced_occlusion_matches_jax(grid5):
    jscene, pscene, o, d = grid5
    want = np.asarray(traverse8.occluded(jscene.bvh, o, d, TMIN, TMAX))
    b = pscene.bvh
    rng = np.random.default_rng(4)
    act = rng.random(o.shape[0]) < 0.8
    got = traverse.occluded_plain(
        b.table, torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)),
        torch.tensor(act), TMIN, TMAX, *b.walk_args, **b.instance_kwargs)
    assert np.array_equal(got.numpy(), want & act)
    assert 0.1 < want.mean() < 0.9


def test_instanced_trace_paths_matches_jax():
    jscene = j_build_instanced(_grid_scene(3, 3, rot=True),
                               probe=j_constant((2.0,) * 3))
    pscene = scene_from_arrays(jax_scene_arrays(jscene), device="cpu")
    n = 2048
    o, d = _rays_grid(n, seed=7, extent=4.0)
    key = jax.random.PRNGKey(2)
    want = jax.jit(lambda o, d: j_trace_paths(
        jscene, o, d, jnp.ones(n, bool), key, CFG[0]))(o, d)
    got = trace_paths(pscene, torch.tensor(np.asarray(o)),
                      torch.tensor(np.asarray(d)),
                      torch.ones(n, dtype=torch.bool), np.asarray(key), CFG[1])
    assert int(got["traces"]) == int(want["traces"])
    for f in ("radiance", "alpha", "normal", "albedo"):
        ok = np.isclose(got[f].numpy(), np.asarray(want[f]), rtol=1e-3,
                        atol=1e-5).all(axis=1)
        assert ok.mean() >= 0.99, (f, ok.mean())
    assert got["radiance"].numpy().max() > 0


def test_rotated_instance_normals():
    # a box turned 90 degrees about y: rays down -z meet its object +x face,
    # whose world normal is +z (the JAX package's rotated-normal check)
    box = make_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                   Material(color=(1.0, 1.0, 1.0), roughness=1.0))
    jsc = jinstance.instanced(to_jax_meshes([box]), [(0, _rot_y(90.0))])
    jscene = j_build_instanced(jsc, probe=j_constant((2.0,) * 3))
    pscene = build_scene_instanced(pinstance.instanced([box],
                                                       [(0, _rot_y(90.0))]),
                                   constant_probe((2.0,) * 3), device="cpu")
    n = 64
    o = np.tile([[0.0, 0.0, 5.0]], (n, 1)).astype(np.float32)
    d = np.tile([[0.0, 0.0, -1.0]], (n, 1)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    want = j_trace_paths(jscene, jnp.asarray(o), jnp.asarray(d),
                         jnp.ones(n, bool), key, CFG[0])
    got = trace_paths(pscene, torch.tensor(o), torch.tensor(d),
                      torch.ones(n, dtype=torch.bool), np.asarray(key), CFG[1])
    nrm = got["normal"].numpy()
    assert np.allclose(np.abs(nrm[:, 2]), 1.0, atol=1e-3)
    assert np.allclose(nrm[:, 0], 0.0, atol=1e-3)
    np.testing.assert_allclose(nrm, np.asarray(want["normal"]), atol=1e-6)


def test_instanced_matches_flattened_in_the_port():
    # the JAX test's gate: same RNG streams, same geometry -> the same
    # paths but for rounding ties
    sc = to_port_scene(_grid_scene(3, 3, rot=True))
    probe = constant_probe((2.0,) * 3)
    scene_i = build_scene_instanced(sc, probe, device="cpu")
    scene_f = build_scene(sc.flatten(), probe, device="cpu")
    n = 2048
    o, d = (torch.tensor(np.asarray(x)) for x in _rays_grid(n, seed=7,
                                                            extent=4.0))
    act = torch.ones(n, dtype=torch.bool)
    key = np.asarray(jax.random.PRNGKey(2))
    ri = trace_paths(scene_i, o, d, act, key, CFG[1])["radiance"].numpy()
    rf = trace_paths(scene_f, o, d, act, key, CFG[1])["radiance"].numpy()
    np.testing.assert_allclose(ri.mean(0), rf.mean(0), rtol=0.05, atol=0.01)
    assert np.isclose(ri, rf, rtol=1e-3, atol=1e-3).all(1).mean() > 0.9


def test_instance_models_match_jax():
    jsc = _grid_scene(2, 2, rot=True)
    psc = to_port_scene(jsc)
    assert psc.num_unique_triangles == jsc.num_unique_triangles
    assert psc.num_world_triangles == jsc.num_world_triangles
    for a, b in zip(jsc.flatten(), psc.flatten()):
        assert np.array_equal(a.vertex, b.vertex)
        assert np.array_equal(a.normal, b.normal)
    m = _translate(-3.0, 1.0, 0.5) @ _rot_y(20.0)
    jsc.replace_transform(1, m)
    psc.replace_transform(1, m)
    assert np.array_equal(jsc.flatten()[1].vertex, psc.flatten()[1].vertex)
    assert np.array_equal(jsc.instances[1].transform,
                          psc.instances[1].transform)


@pytest.mark.parametrize("walk", ["closest_hit", "occluded"])
def test_leaf_root_instances_match_jax(walk):
    # pyramids (6 triangles) and quads whose instance rows enter the BLAS
    # at its one leaf row, in both packages' tables
    field = small_blas_field()
    jb = jtlas.build_instanced(*field)
    pb = tlas.build_instanced(*field)
    table = leaf_root(np.asarray(jb.table), jb.inst_base, jb.blas_base,
                      jb.arity)
    assert np.array_equal(_bits(table), _bits(leaf_root(
        pb.table, pb.inst_base, pb.blas_base, pb.arity)))
    jb = dataclasses.replace(jb, table=jnp.asarray(table))
    o, d = _rays_grid(4096, seed=5, extent=6.0)
    rng = np.random.default_rng(6)
    act = rng.random(o.shape[0]) < 0.9
    args = (torch.tensor(table), torch.tensor(np.asarray(o)),
            torch.tensor(np.asarray(d)), torch.tensor(act), TMIN, TMAX,
            pb.stack_depth, pb.arity, pb.leaf_size)
    kw = {"num_instances": pb.num_instances, "inst_base": pb.inst_base,
          "blas_base": pb.blas_base}
    if walk == "occluded":
        want = np.asarray(traverse8.occluded(jb, o, d, TMIN, TMAX)) & act
        got = traverse.occluded_plain(*args, **kw).numpy()
        assert np.array_equal(got, want)
        assert 0.05 < want.mean() < 0.9
        return
    want = traverse8.closest_hit(jb, o, d, TMIN, TMAX)
    got = traverse.closest_hit_plain(*args, **kw)
    hit = got["hit"].numpy()
    for f in ("hit", "tri_id", "inst"):
        w = np.where(act, np.asarray(want[f]), -1 if f != "hit" else False)
        assert np.array_equal(got[f].numpy(), w), f
    assert 0.05 < hit.mean() < 0.9
    # both meshes are hit: triangles 0-5 (pyramid) and 6-7 (quad)
    tris = got["tri_id"].numpy()[hit]
    assert tris.min() < 6 <= tris.max()
    np.testing.assert_allclose(got["t"].numpy()[hit],
                               np.asarray(want["t"])[hit], rtol=2e-5,
                               atol=1e-4)
    for f in ("u", "v"):
        np.testing.assert_allclose(got[f].numpy()[hit],
                                   np.asarray(want[f])[hit], rtol=0,
                                   atol=2e-5)
