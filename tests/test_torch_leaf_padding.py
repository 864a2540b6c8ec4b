"""The fact the (32, 24) kernels' padding skip rests on, for every table the
port packs, against the JAX package's table of the same triangles, on the
CPU.

``closest_hit_kernel<32, 24>``, ``occluded_kernel<32, 24>`` and its
non-culling instantiation stop testing a leaf row at the first third of
its slots whose first slot is padding. That is exact because every packer
writes a leaf's padding as a suffix of slots whose id is -1 and whose nine
triangle words are 0, and a zero triangle hits nothing (det = 0). Pinned
here on a seeded soup of small triangles (leaves of many fills) that also
holds a real degenerate triangle at the origin (nine zero words, a real
id: only the id marks padding):

- the native (16, 6) and (32, 12) tables, the Python-collapsed (32, 24)
  table, ``pack_wide(dfs=True, treelet_budget=)`` at (32, 24) and a
  two-level (32, 24) table's BLAS leaves, in both packages (equal bit for
  bit): every reached leaf row's padding is such a suffix;
- a plain walk that skips a leaf's thirds from the first whose first slot
  is padding (``closest_hit_plain`` / ``occluded_plain`` with their
  triangle test masked there) answers as the plain walks do, bit for bit,
  while skipping tests;
- ``kernel_times.table_structure`` counts a table's rows, children and
  used thirds as a walk over its codes finds them.
"""

import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu.ops import bvh8 as jbvh8
from fovpathtracing_optixcodelatest_tpu.ops import bvh_native as jbvh_native
from fovpathtracing_optixcodelatest_tpu.ops import tlas as jtlas
from fovpathtracing_optixcodelatest_tpu_torch.ops import (
    bvh8,
    bvh_native,
    tlas,
    traverse,
)
from fovpathtracing_optixcodelatest_tpu_torch.tools import kernel_times
from torch_blas_fields import _translate

torch.set_num_threads(2)

TMIN, TMAX = 1e-3, 1e16
TABLES = ["native16x6", "native32x12", "python32x24", "treelet32x24",
          "blas32x24"]


@pytest.fixture(autouse=True)
def no_cache(monkeypatch):
    monkeypatch.setenv("FOVTPU_BVH_CACHE", "")


def _soup(n=700, seed=3):
    """n small random triangles in a 10-unit cube, the first a degenerate
    triangle at the origin (all nine packed words 0)."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-5.0, 5.0, (n, 1, 3))
    tris = (centre + rng.normal(0.0, 0.4, (n, 3, 3))).astype(np.float32)
    tris[0] = 0.0
    return tris


def _field(tris):
    """(unique, mesh ids, transforms): the soup as one BLAS under three
    instances, one mirrored."""
    return ([tris], [0, 0, 0],
            [np.eye(4), _translate(14.0, 0.0, 0.0),
             _translate(0.0, 0.0, 14.0) @ np.diag([1.0, -1.0, 1.0, 1.0])])


def _build(kind, pkg):
    """(table, arity, leaf, walk kwargs) of the soup in table ``kind`` from
    the port's builders (``pkg`` "port") or the JAX package's ("jax")."""
    tris = _soup()
    native, b8, tl = ((bvh_native, bvh8, tlas) if pkg == "port"
                      else (jbvh_native, jbvh8, jtlas))
    if kind == "native16x6":
        b = native.build(tris, leaf_size=6, arity=16)
    elif kind == "native32x12":
        b = native.build(tris, leaf_size=12, arity=32)
    elif kind == "python32x24":
        b = native.build(tris, leaf_size=24, arity=32)
    elif kind == "treelet32x24":
        b = b8.build(tris, 24, 32, dfs=True, treelet_budget=16)
    else:
        b = tl.build_instanced(*_field(tris), leaf_size=24, arity=32)
    kw = {}
    if kind == "blas32x24":
        kw = {"num_instances": int(b.num_instances),
              "inst_base": int(b.inst_base), "blas_base": int(b.blas_base)}
    return (np.asarray(b.table, dtype=np.float32), int(b.arity),
            int(b.leaf_size), int(b.stack_depth), kw)


def _reached(table, arity, kw):
    """(node rows, leaf rows) a walk reaches from the root (and, on a
    two-level table, from every instance's BLAS root)."""
    words = table.view(np.uint32)
    todo = [0]
    if kw:
        todo += [int(words[r, 0]) for r in range(kw["inst_base"],
                                                  kw["blas_base"])]
    nodes, leaves = set(), set()
    while todo:
        code = todo.pop()
        row, kind = code >> 2, code & 3
        if kind == 1:
            leaves.add(row)
        elif kind == 0 and row not in nodes:
            nodes.add(row)
            todo += [int(c) for c in words[row, 3 * arity: 4 * arity] if c]
    return sorted(nodes), sorted(leaves)


@pytest.mark.parametrize("kind", TABLES)
def test_leaf_padding_is_a_suffix_of_zero_triangles(kind):
    port, jax_ = _build(kind, "port"), _build(kind, "jax")
    assert np.array_equal(port[0].view(np.uint32), jax_[0].view(np.uint32))
    degenerate = 0
    for table, arity, leaf, _, kw in (port, jax_):
        leaves = _reached(table, arity, kw)[1]
        assert leaves
        words = table.view(np.uint32)
        fills = set()
        for row in leaves:
            ids = words[row, 9 * leaf: 10 * leaf].view(np.int32)
            n = int((ids >= 0).sum())
            fills.add(n)
            assert n >= 1 and (ids[:n] >= 0).all(), (row, ids)
            assert (ids[n:] == -1).all(), (row, ids)
            assert not words[row, 9 * n: 9 * leaf].any(), row
            real = words[row, : 9 * n].reshape(n, 9)
            degenerate += int((~real.any(axis=1)).sum())
        if leaf > 6:
            assert len(fills) > 3, fills  # leaves of many fills
    assert degenerate == 2  # the origin triangle, once in each package


def _skipping(tri_test, leaf, skipped):
    """``traverse.tri_test`` for a plain walk's leaf loop that stops at the
    first third whose first slot is padding: slot k's test answers no hit
    on every leaf row whose thirds 1 .. k // 3 start with an id of -1. The
    walk slices slot k's words from its leaf rows, so the rows and k are
    read from the slice."""
    def test(tri, o, d, tmin, tmax, cull):
        hit, t, u, v = tri_test(tri, o, d, tmin, tmax, cull)
        rows = tri._base
        assert rows is not None and rows.shape[1] >= 10 * leaf
        k = (tri.storage_offset() - rows.storage_offset()) // 9
        h = k // 3
        if h == 0:
            return hit, t, u, v
        ids = rows[:, 9 * leaf: 10 * leaf].contiguous().view(torch.int32)
        skip = (ids[:, 3: 3 * h + 1: 3] < 0).any(dim=1)
        skipped[0] += int(skip.sum())
        return hit & ~skip, t, u, v
    return test


def _rays(n, seed, field):
    """Rays from above aimed into the soup (on ``field``, into each of its
    three instances in turn)."""
    rng = np.random.default_rng(seed)
    target = rng.uniform(-4.0, 4.0, (n, 3))
    if field:
        target[:, 0] += 14.0 * (np.arange(n) % 3 == 1)
        target[:, 2] += 14.0 * (np.arange(n) % 3 == 2)
    o = target + rng.normal(0.0, 3.0, (n, 3))
    o[:, 1] = rng.uniform(8.0, 12.0, n)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32),
            torch.tensor(d, dtype=torch.float32))


@pytest.mark.parametrize("kind", TABLES)
def test_walk_skipping_padding_thirds_answers_as_the_plain_walks(
        kind, monkeypatch):
    table, arity, leaf, depth, kw = _build(kind, "port")
    table = torch.tensor(table)
    o, d = _rays(1500, 9, bool(kw))
    act = torch.ones(o.shape[0], dtype=torch.bool)
    args = (table, o, d, act, TMIN, TMAX, depth, arity, leaf)
    k1 = traverse.closest_hit_plain(*args, **kw)
    k2 = [traverse.occluded_plain(*args, **kw, cull_backface=c)
          for c in (True, False)]
    skipped = [0]
    monkeypatch.setattr(traverse, "tri_test",
                        _skipping(traverse.tri_test, leaf, skipped))
    s1 = traverse.closest_hit_plain(*args, **kw)
    s2 = [traverse.occluded_plain(*args, **kw, cull_backface=c)
          for c in (True, False)]
    for c in ("t", "u", "v"):
        assert torch.equal(s1[c].view(torch.int32), k1[c].view(torch.int32))
    assert torch.equal(s1["tri_id"], k1["tri_id"])
    assert all(torch.equal(a, b) for a, b in zip(s2, k2))
    assert k1["hit"].float().mean() > 0.5 and k2[0].any()
    assert skipped[0] > 0  # the walks really skipped thirds


def test_table_structure_counts_what_a_walk_reaches():
    table, arity, leaf, _, _ = _build("python32x24", "port")
    b = bvh_native.build(_soup(), leaf_size=24, arity=32)
    got = kernel_times.table_structure(b)
    nodes, leaves = _reached(table, arity, {})
    words = table.view(np.uint32)
    codes = words[:, 3 * arity: 4 * arity]
    fill = [(words[r, 9 * leaf: 10 * leaf].view(np.int32) >= 0).sum()
            for r in leaves]
    assert got["rows"] == table.shape[0]
    assert (got["node_rows"], got["leaf_rows"]) == (len(nodes), len(leaves))
    assert got["children_per_node"] == pytest.approx(
        (codes[nodes] != 0).sum() / len(nodes))
    assert got["node_rows_past_slot_15"] == int(
        (codes[nodes][:, 16:] != 0).any(axis=1).sum())
    assert got["triangles_per_leaf"] == pytest.approx(np.mean(fill))
    thirds = np.bincount((np.array(fill) + 2) // 3, minlength=9)
    assert got["used_thirds"] == thirds.tolist()
    assert sum(got["used_thirds"]) == len(leaves)
    assert got["thirds_per_leaf"] == pytest.approx(
        np.dot(np.arange(9), thirds) / len(leaves))
