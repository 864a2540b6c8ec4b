"""The PyTorch port's traversals against the JAX package.

The plain versions of K1/K2/K3 (what the CUDA kernels are held against on
the card) must reproduce ``traverse8.closest_hit`` / ``traverse8.occluded``
and the Pallas ``occluded_packets`` (interpret mode) on the same tables, and
agree with the brute-force oracles.

Tolerances: hit, tri_id and occlusion exact (the port walks the children in
the reference's packed-key order, so even equal-t hits resolve to the same
triangle); t within 5e-6 relative and u/v within 2e-6 absolute, because
XLA on the CPU contracts some of the Möller-Trumbore products into FMAs
while the port rounds every operation (measured: t bit-exact on box_city,
at most 19 ulp on cornell's icosphere; u/v <= 1.2e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu.models import scenes as jscenes
from fovpathtracing_optixcodelatest_tpu.models.mesh import (
    host_triangles as j_host_triangles,
)
from fovpathtracing_optixcodelatest_tpu.models.probe import constant_probe
from fovpathtracing_optixcodelatest_tpu.models.scene import build_scene as j_build
from fovpathtracing_optixcodelatest_tpu.ops import bvh8 as jbvh8
from fovpathtracing_optixcodelatest_tpu.ops import pallas_traverse, traverse8
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import scene_from_arrays
from fovpathtracing_optixcodelatest_tpu_torch.ops import (
    intersect,
    kernel_build,
    packet_traverse,
    traverse,
)

torch.set_num_threads(2)

TMIN, TMAX = 0.01, 1e16
UV_ATOL = 2e-6
T_RTOL = 5e-6


def _arrays(jscene):
    return {
        "bvh_table": np.asarray(jscene.bvh.table),
        "bvh_stack_depth": jscene.bvh.stack_depth,
        "bvh_arity": jscene.bvh.arity,
        "bvh_leaf_size": jscene.bvh.leaf_size,
        "tri_pack": np.asarray(jscene.geom.tri_pack),
        "material_rows": np.asarray(jscene.materials.packed),
        "probe_data": np.asarray(jscene.probe.data),
        "probe_pdf_x": np.asarray(jscene.probe.pdf_x),
        "probe_pdf_y": np.asarray(jscene.probe.pdf_y),
        "probe_sample_rows": np.asarray(jscene.probe.sample_rows),
    }


def _rays(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    active = rng.random(n) < 0.9
    return o, d, active


SCENES = {
    "box_city": (lambda: jscenes.box_city(n=4, seed=0)[0],
                 (-35.0, 0.0, -35.0), (35.0, 20.0, 35.0)),
    "cornell": (lambda: jscenes.cornell(sphere_subdiv=1)[0],
                (-1.9, -1.9, -1.9), (1.9, 1.9, 1.9)),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene_pair(request):
    make, lo, hi = SCENES[request.param]
    jscene = j_build(make(), probe=constant_probe((1.0, 1.0, 1.0)))
    pscene = scene_from_arrays(_arrays(jscene), device="cpu")
    o, d, active = _rays(3000, lo, hi, seed=len(request.param))
    return jscene, pscene, o, d, active


def _bvh_args(pscene):
    b = pscene.bvh
    return TMIN, TMAX, b.stack_depth, b.arity, b.leaf_size


def test_closest_hit_plain_matches_traverse8(scene_pair):
    jscene, pscene, o, d, active = scene_pair
    ref = traverse8.closest_hit(jscene.bvh, jnp.asarray(o), jnp.asarray(d),
                                TMIN, TMAX, active=jnp.asarray(active))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = traverse.closest_hit_plain(
        pscene.bvh.table, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(active), *_bvh_args(pscene))
    got = {k: v.numpy() for k, v in got.items()}
    assert np.array_equal(got["hit"], ref["hit"])
    assert np.array_equal(got["tri_id"], ref["tri_id"])
    h = got["hit"]
    assert 0.2 < h.mean() < 1.0
    t_rel = np.abs(got["t"][h] - ref["t"][h]) / ref["t"][h]
    assert t_rel.max() <= T_RTOL
    for c in ("u", "v"):
        assert np.abs(got[c][h] - ref[c][h]).max() <= UV_ATOL
    assert (got["tri_id"][~active] == -1).all()
    assert np.isinf(got["t"][~h]).all()


def test_closest_hit_plain_matches_brute_force(scene_pair):
    _, pscene, o, d, active = scene_pair
    tp = pscene.tri_pack
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    got = traverse.closest_hit_plain(pscene.bvh.table, ot, dt,
                                     torch.ones(len(o), dtype=torch.bool),
                                     *_bvh_args(pscene))
    ref = intersect.brute_force_closest_hit(tp[:, 36:39], tp[:, 39:42],
                                            tp[:, 42:45], ot, dt, TMIN, TMAX)
    assert torch.equal(got["hit"], ref["hit"])
    h = got["hit"]
    # same Möller-Trumbore arithmetic: the closest t is the same float
    assert torch.equal(got["t"][h], ref["t"][h])
    # different visit order: only exact-t ties may pick another triangle
    diff = h & (got["tri_id"].long() != ref["tri_id"])
    assert diff.float().mean() <= 0.001


def test_occluded_plain_matches_traverse8_and_oracle(scene_pair):
    jscene, pscene, o, d, active = scene_pair
    ref = np.asarray(traverse8.occluded(jscene.bvh, jnp.asarray(o),
                                        jnp.asarray(d), TMIN, TMAX,
                                        active=jnp.asarray(active)))
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    got = traverse.occluded_plain(pscene.bvh.table, ot, dt,
                                  torch.from_numpy(active), *_bvh_args(pscene))
    assert np.array_equal(got.numpy(), ref)
    assert not got.numpy()[~active].any()
    tp = pscene.tri_pack
    oracle = intersect.brute_force_occluded(tp[:, 36:39], tp[:, 39:42],
                                            tp[:, 42:45], ot, dt, TMIN, TMAX)
    # any-hit over the BVH can only differ from the oracle on grazing rays
    assert (got[active] == oracle[active]).float().mean() >= 0.999


@pytest.mark.parametrize("n,seed", [(1500, 5), (2048, 1)])
def test_occluded_packets_plain_matches_pallas_interpret(n, seed):
    meshes, _ = jscenes.box_city(n=8, seed=3)
    wb = jbvh8.build_legacy8(j_host_triangles(meshes))
    o, d, _ = _rays(n, (-30.0, 0.0, -30.0), (30.0, 30.0, 30.0), seed)
    active = np.arange(n) % 2 == 0  # odd lanes inactive
    ref = np.asarray(pallas_traverse.occluded_packets(
        wb, jnp.asarray(o), jnp.asarray(d), TMIN, TMAX,
        active=jnp.asarray(active), interpret=True))
    table = torch.tensor(np.asarray(wb.table))
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(active),
            TMIN, TMAX, wb.stack_depth, wb.leaf_size)
    got = packet_traverse.occluded_packets_plain(table, *args).numpy()
    assert got.shape == (n,)
    assert not got[1::2].any()
    assert np.array_equal(got, ref)
    assert 0.05 < got[::2].mean() < 0.95


def test_wrappers_run_the_plain_versions_on_cpu(scene_pair):
    _, pscene, o, d, active = scene_pair
    args = (pscene.bvh.table, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(active), *_bvh_args(pscene))
    before = dict(kernel_build.LAUNCHES)
    a = traverse.closest_hit(*args)
    b = traverse.closest_hit_plain(*args)
    for k in ("t", "tri_id", "u", "v", "hit"):
        assert torch.equal(a[k], b[k])
    assert torch.equal(traverse.occluded(*args), traverse.occluded_plain(*args))
    assert kernel_build.LAUNCHES == before  # no kernel ran


@pytest.mark.parametrize("bad", ["dtype", "shape", "active", "depth"])
def test_wrappers_check_their_inputs(scene_pair, bad):
    _, pscene, o, d, active = scene_pair
    table, ot, dt = pscene.bvh.table, torch.from_numpy(o), torch.from_numpy(d)
    act = torch.from_numpy(active)
    depth = pscene.bvh.stack_depth
    if bad == "dtype":
        ot = ot.double()
    elif bad == "shape":
        dt = dt[:, :2]
    elif bad == "active":
        act = act[:10]
    else:
        depth = traverse.MAX_STACK + 1
    with pytest.raises(ValueError):
        traverse.closest_hit(table, ot, dt, act, TMIN, TMAX, depth,
                             pscene.bvh.arity, pscene.bvh.leaf_size)

