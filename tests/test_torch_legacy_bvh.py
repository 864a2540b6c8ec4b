"""The port's threaded BVH (``ops/bvh.py``) and pure-Python wide builder
(``ops/bvh8.collapse_bvh2``/``build``/``build_legacy8``,
``bvh_native.build(force_python=True)``) against the JAX package's, on the
same triangles.

Tolerance: none. Every array must equal JAX's bit for bit (float arrays
compared as their bit patterns), because both builders take their splits
from the same numpy arithmetic in the same order.
"""

import dataclasses

import numpy as np
import pytest

from fovpathtracing_optixcodelatest_tpu.models import scenes as jscenes
from fovpathtracing_optixcodelatest_tpu.models.material import Material
from fovpathtracing_optixcodelatest_tpu.models.mesh import (
    host_triangles,
    make_box,
    make_icosphere,
)
from fovpathtracing_optixcodelatest_tpu.ops import bvh as jbvh
from fovpathtracing_optixcodelatest_tpu.ops import bvh8 as jbvh8
from fovpathtracing_optixcodelatest_tpu.ops import bvh_native as jbvh_native
from fovpathtracing_optixcodelatest_tpu_torch.ops import bvh, bvh8, bvh_native


def _scene(seed=0, boxes=20):
    """``tests/test_bvh.py``'s scene (20 boxes) or
    ``tests/test_traverse_packet.py``'s (15 boxes): an icosphere and
    random boxes."""
    rng = np.random.default_rng(seed)
    meshes = [make_icosphere((0, 0, 0), 1.0, 2, Material())]
    for _ in range(boxes):
        pos = rng.uniform(-4, 4, 3)
        ext = rng.uniform(0.2, 0.8, 3)
        meshes.append(make_box(tuple(pos), tuple(ext), Material()))
    return host_triangles(meshes)


SCENES = {
    "bvh_scene": lambda: _scene(0, 20),
    "packet_scene": lambda: _scene(4, 15),
    "cornell": lambda: host_triangles(jscenes.cornell()[0]),
    "box_city": lambda: host_triangles(jscenes.box_city(n=4, seed=0)[0]),
    "one_triangle": lambda: np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]],
                                       dtype=np.float32),
}
FIELDS = [f.name for f in dataclasses.fields(bvh.BVH)]


@pytest.fixture(scope="module", params=sorted(SCENES))
def tris(request):
    return SCENES[request.param]()


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    assert np.array_equal(a, b), what


def _same_wide(p, j):
    _same(p.table, j.table, "table")
    _same(p.leaf_perm, j.leaf_perm, "leaf_perm")
    for k in ("leaf_size", "arity", "packed", "stack_depth"):
        assert getattr(p, k) == getattr(j, k), k


def test_threaded_build_equals_jax(tris):
    got, want = bvh.build(tris), jbvh.build(tris)
    assert got.num_nodes == want.num_nodes
    for f in FIELDS:
        _same(getattr(got, f), getattr(want, f), f)


def test_threaded_build_structure():
    # tests/test_bvh.py's structure checks on the port's build
    tris = _scene()
    b = bvh.build(tris)
    m = b.num_nodes
    assert (b.tri_count <= bvh.LEAF_SIZE).all()
    assert b.tri_count.sum() == tris.shape[0]
    used = b.tri_perm[b.tri_perm >= 0]
    assert sorted(used.tolist()) == list(range(tris.shape[0]))
    assert (b.miss_link <= m).all() and (b.hit_link <= m).all()
    np.testing.assert_allclose(b.aabb_lo[0], tris.min(axis=(0, 1)), atol=1e-5)
    np.testing.assert_allclose(b.aabb_hi[0], tris.max(axis=(0, 1)), atol=1e-5)
    # .to moves every array; the host arrays stay as they were
    t = b.to("cpu")
    for f in FIELDS:
        assert np.array_equal(getattr(t, f).numpy(), getattr(b, f)), f
    assert t.num_nodes == m


@pytest.mark.parametrize("leaf_size,arity", [(6, 16), (4, 8)])
def test_collapse_and_wide_builds_equal_jax(tris, leaf_size, arity):
    got = bvh8.collapse_bvh2(tris, leaf_size, arity)
    want = jbvh8.collapse_bvh2(tris, leaf_size, arity)
    for name, a, b in zip(("boxes", "meta", "order_slots"), got, want):
        _same(a, b, name)
    _same_wide(bvh8.build(tris, leaf_size, arity),
               jbvh8.build(tris, leaf_size, arity))
    if arity == 8:
        _same_wide(bvh8.build_legacy8(tris, leaf_size),
                   jbvh8.build_legacy8(tris, leaf_size))


def test_force_python_equals_jax_and_bypasses_the_cache(monkeypatch,
                                                        tmp_path):
    tris = _scene()
    monkeypatch.setattr(bvh_native, "BVH_CACHE_MIN_TRIS", 1)
    monkeypatch.setenv("FOVTPU_BVH_CACHE", str(tmp_path))
    # a Python build neither writes the cache ...
    clock = {}
    py = bvh_native.build(tris, force_python=True, timings=clock)
    assert set(clock) == {"collapse_s", "pack_s"}
    assert list(tmp_path.iterdir()) == []
    _same_wide(py, jbvh_native.build(tris, force_python=True))
    # ... nor reads the native build that the cache holds for these
    # triangles and parameters
    native = bvh_native.build(tris)
    assert len(list(tmp_path.iterdir())) == 1
    warm = {}
    assert _same_table(bvh_native.build(tris, timings=warm), native)
    assert set(warm) == {"key_s", "load_s"}
    again = bvh_native.build(tris, force_python=True)
    _same_wide(again, py)
    assert not _same_table(again, native)


def _same_table(a, b) -> bool:
    return a.table.shape == b.table.shape and np.array_equal(
        a.table.view(np.uint32), b.table.view(np.uint32))


def test_python_and_native_trees_differ():
    # the two builders of one scene: the same shapes, another tree (the
    # JAX package's collapse_bvh2 is no mirror of its native builder)
    tris = host_triangles(jscenes.box_city(n=4, seed=0)[0])
    pb, pm, po = bvh8.collapse_bvh2(tris, 6, 16)
    nb, nm, no = bvh_native.collapse(tris, 6, 16)
    assert pb.shape == nb.shape == (12, 16, 6) and po.shape == no.shape
    assert np.array_equal(pm, nm)
    filled = pm[..., 1] >= 0
    # empty slots: +-inf in Python, +-FLT_MAX in the native builder
    assert np.isinf(pb[~filled]).all() and np.isfinite(nb[~filled]).all()
    # the same boxes, but other triangles under them
    assert np.array_equal(pb[filled], nb[filled])
    assert int((po != no).sum()) == 20  # of 204 slot ids

    def leaves(meta, order):
        return {tuple(sorted(order[a:a + c].tolist()))
                for a, c in meta.reshape(-1, 2) if c > 0}

    assert len(leaves(pm, po) - leaves(nm, no)) == 6  # of 38 leaves
    assert not _same_table(bvh8.build(tris), bvh_native.build(tris))
