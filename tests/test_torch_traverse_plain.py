"""The plain K1/K2 at a stack too small for the tree, against the JAX
package's truncated traversals, the checks the CUDA wrappers make, and the
work (rows, child and triangle tests) the plain K1-K3 count.

``traverse8.closest_hit`` / ``traverse8.occluded`` with ``stack_cap`` flag
the rays whose stack overflowed as ``pending`` and leave their result
undefined; the port's own overflow rule (K1 keeps the largest keys of a
node's hit children that fit, K2 pushes no more children) is pinned by the
card tests against the plain versions, not by JAX.

- K1 walks the children in the reference's order, so its stack holds the
  same entries as JAX's at every step: on every ray JAX does not flag,
  hit and tri_id must be equal and t/u/v within the tolerances of
  tests/test_torch_traverse.py (XLA on the CPU contracts some products
  into FMAs).
- JAX's occlusion flags an overflowed ray only when it found no hit, and it
  pushes children by descending code where K2 pushes them in slot order, so
  the two stacks overflow on different rays. On every ray JAX does not
  flag, K2 may report occluded only where JAX does, and any disagreement
  must be one where K2's small stack changed its own answer (it differs
  from K2 at the table's full stack depth, which tests/test_torch_traverse.py
  holds equal to JAX).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu.models import scenes as jscenes
from fovpathtracing_optixcodelatest_tpu.models.probe import constant_probe
from fovpathtracing_optixcodelatest_tpu.models.scene import build_scene as j_build
from fovpathtracing_optixcodelatest_tpu.ops import traverse8
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import scene_from_arrays
from fovpathtracing_optixcodelatest_tpu_torch.ops import (
    packet_traverse,
    traverse,
)
from test_torch_traverse import T_RTOL, TMAX, TMIN, UV_ATOL, _arrays, _rays

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def box_city():
    jscene = j_build(jscenes.box_city(n=4, seed=0)[0],
                     probe=constant_probe((1.0, 1.0, 1.0)))
    pscene = scene_from_arrays(_arrays(jscene), device="cpu")
    o, d, active = _rays(3000, (-35.0, 0.0, -35.0), (35.0, 20.0, 35.0),
                         seed=8)
    return jscene, pscene, o, d, active


def _plain_args(pscene, o, d, active, depth):
    b = pscene.bvh
    return (b.table, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(active), TMIN, TMAX, depth, b.arity,
            b.leaf_size)


@pytest.mark.parametrize("depth", [2, 3])
def test_closest_hit_plain_small_stack_matches_traverse8(box_city, depth):
    jscene, pscene, o, d, active = box_city
    assert depth < pscene.bvh.stack_depth
    ref = traverse8.closest_hit(jscene.bvh, jnp.asarray(o), jnp.asarray(d),
                                TMIN, TMAX, active=jnp.asarray(active),
                                stack_cap=depth)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = traverse.closest_hit_plain(*_plain_args(pscene, o, d, active,
                                                  depth))
    got = {k: v.numpy() for k, v in got.items()}
    ok = ~ref["pending"]
    # the cap bites on some rays and leaves most of the others whole
    assert 0.05 < ref["pending"].mean() < 0.8
    assert np.array_equal(got["hit"][ok], ref["hit"][ok])
    assert np.array_equal(got["tri_id"][ok], ref["tri_id"][ok])
    h = ok & got["hit"]
    assert h.sum() > 100
    assert (np.abs(got["t"][h] - ref["t"][h]) / ref["t"][h]).max() <= T_RTOL
    for c in ("u", "v"):
        assert np.abs(got[c][h] - ref[c][h]).max() <= UV_ATOL, c


@pytest.mark.parametrize("depth", [2, 3])
def test_occluded_plain_small_stack_matches_traverse8(box_city, depth):
    jscene, pscene, o, d, active = box_city
    occ, pending = traverse8.occluded(
        jscene.bvh, jnp.asarray(o), jnp.asarray(d), TMIN, TMAX,
        active=jnp.asarray(active), stack_cap=depth, return_pending=True)
    occ, pending = np.asarray(occ), np.asarray(pending)
    got = traverse.occluded_plain(*_plain_args(pscene, o, d, active,
                                               depth)).numpy()
    full = traverse.occluded_plain(*_plain_args(
        pscene, o, d, active, pscene.bvh.stack_depth)).numpy()
    ok = ~pending
    assert 0.05 < pending.mean() < 0.8
    assert ok.sum() > 1000
    # only genuine occluders, and every disagreement is K2's own overflow
    assert not (got & ~occ)[ok].any()
    differs = ok & (got != occ)
    assert (got != full)[differs].all()
    assert (got == occ)[ok].mean() > 0.8
    assert not got[~active].any()


@pytest.mark.parametrize("layout", [(8, 4), (16, 4), (4, 6)])
def test_kernel_layout_refuses_other_layouts(box_city, layout):
    table = box_city[1].bvh.table
    traverse._kernel_layout(table, 10, 16, 6)  # the compiled layout passes
    with pytest.raises(ValueError, match="layout"):
        traverse._kernel_layout(table, 10, *layout)


def test_kernel_layout_refuses_a_misaligned_table(box_city):
    table = box_city[1].bvh.table
    flat = torch.empty(table.numel() + 1, dtype=torch.float32)
    shifted = flat[1:].view(table.shape)  # 4 bytes past an aligned start
    shifted.copy_(table)
    assert shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        traverse._kernel_layout(shifted, 10, 16, 6)
    with pytest.raises(ValueError, match="columns"):
        traverse._kernel_layout(table[:, :60], 10, 16, 6)


@pytest.mark.parametrize("leaf_size,width,match", [
    (2, 64, "layout"), (6, 64, "layout"), (4, 72, "columns")])
def test_k3_layout_refuses_what_it_is_not_compiled_for(box_city, leaf_size,
                                                       width, match):
    # K3 takes the legacy table only: 64 columns, leaf size 4
    want = (packet_traverse.WIDTH, packet_traverse.KERNEL_LEAF_SIZE)
    table = torch.zeros((10, width))
    traverse._kernel_layout(table[:, :64].contiguous(), 10, 8, 4, want=want,
                            width=64)
    with pytest.raises(ValueError, match=match):
        traverse._kernel_layout(table, 10, 8, leaf_size, want=want, width=64)


def test_k3_walk_counts_need_a_kernel(box_city):
    # the packets and rows K3 fetched exist only for a launch
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        packet_traverse.occluded_packets(torch.zeros((10, 64)), o, o + 1.0,
                                         torch.ones(4, dtype=torch.bool),
                                         TMIN, TMAX, 5, 4, fetched={})


# ---------------------------------------------------------------------------
# the work the plain versions count for chip_smoke.py's operations bound
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def city_legacy():
    from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import build_scene

    return build_scene(scenes.box_city(n=4, seed=0)[0], device="cpu",
                       legacy8=True)


def _walk(scene, kind, o, d, active):
    stats = {}
    b, leg = scene.bvh, scene.legacy
    if kind == "occluded_packets":
        packet_traverse.occluded_packets_plain(
            leg.table, o, d, active, TMIN, TMAX, leg.stack_depth,
            leg.leaf_size, stats=stats)
    else:
        getattr(traverse, f"{kind}_plain")(
            b.table, o, d, active, TMIN, TMAX, b.stack_depth, b.arity,
            b.leaf_size, stats=stats)
    return stats


def _root_children(scene, kind) -> int:
    """Non-empty child slots of the root row."""
    if kind == "occluded_packets":
        meta = scene.legacy.table[0, 48:64].contiguous().view(torch.int32)
        return int((meta[1::2] >= 0).sum())
    arity = scene.bvh.arity
    codes = scene.bvh.table[0, 3 * arity: 4 * arity].contiguous()
    return int((codes.view(torch.int32) != 0).sum())


KINDS = ["closest_hit", "occluded", "occluded_packets"]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_counts_the_root_tests_of_rays_that_miss(city_legacy, kind):
    # rays far outside the city pointing away from it fetch the root only
    # and slab-test each of its non-empty children once
    n = 50
    o = torch.full((n, 3), 1000.0)
    d = torch.full((n, 3), 3.0 ** -0.5)
    active = torch.arange(n) % 5 != 0
    k = int(active.sum())
    stats = _walk(city_legacy, kind, o, d, active)
    assert stats == {"node_rows": k, "leaf_rows": 0, "distinct_rows": 1,
                     "child_tests": k * _root_children(city_legacy, kind),
                     "tri_tests": 0}


@pytest.mark.parametrize("kind", KINDS)
def test_plain_counts_only_real_children_and_triangles(city_legacy, kind):
    o, d, active = (torch.from_numpy(x) for x in _rays(
        2000, (-35.0, 0.0, -35.0), (35.0, 20.0, 35.0), seed=9))
    stats = _walk(city_legacy, kind, o, d, active)
    arity, leaf = ((8, city_legacy.legacy.leaf_size)
                   if kind == "occluded_packets"
                   else (city_legacy.bvh.arity, city_legacy.bvh.leaf_size))
    assert stats["node_rows"] > 0 and stats["leaf_rows"] > 0
    # every fetched row holds at least one child or triangle, and the city's
    # tree has nodes with empty slots and leaves with padding
    assert stats["node_rows"] <= stats["child_tests"]
    assert stats["child_tests"] < arity * stats["node_rows"]
    assert stats["leaf_rows"] <= stats["tri_tests"]
    assert stats["tri_tests"] < leaf * stats["leaf_rows"]
    # 2,000 rays share rows: fewer distinct rows than fetches, and no more
    # than the table holds
    table = city_legacy.legacy.table if kind == "occluded_packets" \
        else city_legacy.bvh.table
    assert 1 < stats["distinct_rows"] <= table.shape[0]
    assert stats["distinct_rows"] < stats["node_rows"] + stats["leaf_rows"]
