"""The JAX package's deep-scene tables in the PyTorch port, against the JAX
package on the CPU.

- The row orders (``ops/bvh8.py``): ``dfs_permute_host``,
  ``group_small_siblings_host``, ``treelet_permute_host``, ``pack_wide``
  and ``build(dfs=, treelet_budget=)`` equal JAX's bit for bit: ``table``
  as uint32, ``leaf_perm``, the permutation, ``stack_depth``, ``top_rows``,
  ``top_stack`` and ``treelet_stack``; at the shapes of
  ``tests/test_bvh.py`` ((8, 4) with budgets 16 and 24), at (16, 6) and
  (32, 12), with grouping on and off (``FOVTPU_TGROUP``) and another
  ``FOVTPU_TGROUP_DIV``.
- ``bvh_native.build``'s rule, with ``DEEP_TRIS_THRESHOLD`` (and
  ``DEEP_TREELET_BUDGET``, ``DEEPER_TRIS_THRESHOLD``) made small in both
  packages at run time: a named layout or ``dfs`` gives JAX's table for
  the same call; nothing named gives the (16, 6) table in pack order; the
  cache keys the row order.
- The plain walks on DFS and treelet tables equal ``traverse8``'s on the
  same tables: ``hit``, ``tri_id`` and occlusion exact, ``t/u/v`` within
  the FMA contraction ROADMAP §3 records; and the plain table's hits and
  t, as JAX's ``test_dfs_interleaved_build_parity`` holds.
- A frame on JAX's treelet table, carried across by ``scene_from_arrays``,
  meets the port-against-JAX gate (99% of the pixels within 1 LSB,
  ``traces`` exact).
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
from fovpathtracing_optixcodelatest_tpu.ops import bvh8 as jbvh8
from fovpathtracing_optixcodelatest_tpu.ops import bvh_native as jbvh_native
from fovpathtracing_optixcodelatest_tpu.ops import traverse8
from fovpathtracing_optixcodelatest_tpu.render import film as jfilm
from fovpathtracing_optixcodelatest_tpu.render.renderer import render_frame as j_render
from fovpathtracing_optixcodelatest_tpu_torch import config as pconfig
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes as pscenes
from fovpathtracing_optixcodelatest_tpu_torch.models.material import Material
from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
    host_triangles,
    make_box,
    make_icosphere,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
    build_scene,
    scene_arrays,
    scene_from_arrays,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import (
    bvh8,
    bvh_native,
    traverse,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import prng_key
from fovpathtracing_optixcodelatest_tpu_torch.render import film
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import render_frame

torch.set_num_threads(2)

TMIN, TMAX = 0.01, 1e16
# ROADMAP §3: XLA's FMA contraction moves t by up to 19 ulp on cornell's
# icosphere and u/v by up to 1.2e-6
T_RTOL, UV_ATOL = 3e-6, 2e-6
FIELDS = ("stack_depth", "dfs", "top_rows", "top_stack", "treelet_stack",
          "arity", "leaf_size")


def _scene(seed=31):
    """``tests/test_bvh.py``'s scene: an icosphere and 20 random boxes
    (560 triangles)."""
    rng = np.random.default_rng(seed)
    meshes = [make_icosphere((0, 0, 0), 1.0, 2, Material())]
    for _ in range(20):
        pos = rng.uniform(-4, 4, 3)
        ext = rng.uniform(0.2, 0.8, 3)
        meshes.append(make_box(tuple(pos), tuple(ext), Material()))
    return host_triangles(meshes)


@pytest.fixture(autouse=True)
def no_cache(monkeypatch):
    # every build packs anew; a test that wants the cache turns it on
    monkeypatch.setenv("FOVTPU_BVH_CACHE", "")


def _same_table(got, want) -> bool:
    return (np.array_equal(got.table.view(np.uint32),
                           np.asarray(want.table).view(np.uint32))
            and np.array_equal(got.leaf_perm, np.asarray(want.leaf_perm))
            and all(getattr(got, f) == getattr(want, f) for f in FIELDS))


# (arity, leaf, dfs, treelet budget, FOVTPU_TGROUP, FOVTPU_TGROUP_DIV)
BUILDS = [
    (8, 4, False, 16, "1", "4"), (8, 4, False, 16, "0", "4"),
    (8, 4, False, 24, "1", "4"), (8, 4, False, 24, "0", "4"),
    (16, 6, False, 24, "1", "4"), (16, 6, False, 48, "1", "2"),
    (32, 12, False, 16, "1", "4"), (32, 12, False, 16, "0", "4"),
    (16, 6, True, 0, "1", "4"), (32, 12, True, 0, "1", "4"),
]


@pytest.mark.parametrize("arity,leaf,dfs,budget,group,div", BUILDS)
def test_build_equals_jax_bit_for_bit(monkeypatch, arity, leaf, dfs, budget,
                                      group, div):
    monkeypatch.setenv("FOVTPU_TGROUP", group)
    monkeypatch.setenv("FOVTPU_TGROUP_DIV", div)
    tris = _scene()
    got = bvh8.build(tris, leaf, arity, dfs=dfs, treelet_budget=budget)
    want = jbvh8.build(tris, leaf, arity, dfs=dfs, treelet_budget=budget)
    assert _same_table(got, want)
    assert got.dfs and bool(got.top_rows) == bool(budget)
    plain = bvh8.build(tris, leaf, arity)
    if budget and group == "1":
        assert got.num_rows > plain.num_rows  # group rows were added
    else:
        assert got.num_rows == plain.num_rows
    # the same rows, reordered: every triangle in exactly one slot
    ids = got.leaf_perm[got.leaf_perm >= 0]
    assert np.array_equal(np.sort(ids), np.arange(tris.shape[0]))


def _packed(arity, leaf):
    """The plain packed table of ``_scene`` (table, leaf_perm), built by
    the port (equal to JAX's, ``tests/test_torch_legacy_bvh.py``)."""
    b = bvh8.build(_scene(), leaf, arity)
    return b.table, b.leaf_perm


@pytest.mark.parametrize("arity,leaf,budget", [(8, 4, 24), (32, 12, 16)])
@pytest.mark.parametrize("step", ["dfs", "group", "treelet"])
def test_host_steps_equal_jax(arity, leaf, budget, step):
    """Each host step alone on the same input table (copies: grouping
    rewrites its input's parent rows in place, as JAX's does)."""
    table, leaf_perm = _packed(arity, leaf)
    args = {"dfs": (arity,), "group": (arity, budget),
            "treelet": (arity, budget)}[step]
    fn = {"dfs": "dfs_permute_host", "group": "group_small_siblings_host",
          "treelet": "treelet_permute_host"}[step]
    got = getattr(bvh8, fn)(table.copy(), leaf_perm.copy(), *args)
    want = getattr(jbvh8, fn)(table.copy(), leaf_perm.copy(), *args)
    assert len(got) == len(want)
    assert np.array_equal(got[0].view(np.uint32), want[0].view(np.uint32))
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    assert np.uint32(bvh8._EMPTY_BOX_PAIR) == np.uint32(jbvh8._EMPTY_BOX_PAIR)


@pytest.fixture
def small_deep(monkeypatch):
    """Both packages' size rule engaged at small sizes: "deep" from 100
    triangles, treelets of 24 rows (nothing of the JAX package's files
    changes: its module attributes are patched at run time)."""
    for mod in (bvh_native, jbvh_native):
        monkeypatch.setattr(mod, "DEEP_TRIS_THRESHOLD", 100)
        monkeypatch.setattr(mod, "DEEP_TREELET_BUDGET", 24)


NAMED = [{"leaf_size": 12, "arity": 32}, {"leaf_size": 12, "arity": 32,
                                           "dfs": False},
         {"dfs": True}, {"dfs": False}, {"arity": 16}, {"leaf_size": 6}]


@pytest.mark.parametrize("named", NAMED, ids=lambda k: "-".join(
    f"{a}{v}" for a, v in k.items()))
def test_named_build_of_a_deep_scene_is_jax(small_deep, named):
    tris = _scene()
    got = bvh_native.build(tris, **named)
    want = jbvh_native.build(tris, **named)
    assert _same_table(got, want)
    assert got.dfs == named.get("dfs", True)
    assert bool(got.top_rows) == named.get("dfs", True)


def test_jax_tests_dfs_call_on_a_small_scene_is_jax():
    # tests/test_bvh.py's call: a TypeError in the port before; below the
    # deep threshold, DFS rows without treelets
    tris = _scene(13)
    got = bvh_native.build(tris, leaf_size=6, arity=16, dfs=True)
    assert got.dfs and got.top_rows == 0
    assert _same_table(got, jbvh_native.build(tris, leaf_size=6, arity=16,
                                              dfs=True))
    plain = bvh_native.build(tris, leaf_size=6, arity=16, dfs=False)
    assert got.table.shape == plain.table.shape
    assert not np.array_equal(got.table.view(np.uint32),
                              plain.table.view(np.uint32))


def test_named_build_of_a_deeper_scene_is_jax(small_deep, monkeypatch):
    # L24/A32 with treelets: the Python collapse, as JAX falls through
    for mod in (bvh_native, jbvh_native):
        monkeypatch.setattr(mod, "DEEPER_TRIS_THRESHOLD", 200)
    tris = _scene()
    got = bvh_native.build(tris, dfs=True)
    assert (got.arity, got.leaf_size) == (32, 24) and got.top_rows
    assert _same_table(got, jbvh_native.build(tris, dfs=True))


def test_unnamed_build_keeps_the_default_table(small_deep):
    tris = _scene()
    got = bvh_native.build(tris)
    assert (got.arity, got.leaf_size, got.dfs, got.top_rows) == (16, 6,
                                                                 False, 0)
    assert _same_table(got, jbvh_native.build(tris, leaf_size=6, arity=16,
                                              dfs=False))
    assert bvh_native.layout(10**8) == (6, 16, False, 0)
    # JAX's own default there is the deep one
    assert jbvh_native.build(tris).top_rows > 0


def test_cache_keys_the_row_order(small_deep, tmp_path, monkeypatch):
    import os

    monkeypatch.setenv("FOVTPU_BVH_CACHE", str(tmp_path))
    monkeypatch.setattr(bvh_native, "BVH_CACHE_MIN_TRIS", 1)
    tris = _scene()
    key = bvh_native._cache_key
    assert key(tris, 12, 32, True, 24) != key(tris, 12, 32, False, 0)
    assert key(tris, 12, 32, True, 24) != key(tris, 12, 32, True, 0)
    with_groups = key(tris, 12, 32, True, 24)
    monkeypatch.setenv("FOVTPU_TGROUP", "0")
    assert key(tris, 12, 32, True, 24) != with_groups
    monkeypatch.setenv("FOVTPU_TGROUP", "1")
    monkeypatch.setenv("FOVTPU_TGROUP_DIV", "2")
    assert key(tris, 12, 32, True, 24) != with_groups
    monkeypatch.delenv("FOVTPU_TGROUP_DIV")
    cold, warm = {}, {}
    deep = bvh_native.build(tris, leaf_size=12, arity=32, timings=cold)
    again = bvh_native.build(tris, leaf_size=12, arity=32, timings=warm)
    assert "collapse_s" in cold and set(warm) == {"key_s", "load_s"}
    assert _same_table(again, deep) and again.top_rows > 0
    plain = bvh_native.build(tris, leaf_size=12, arity=32, dfs=False)
    assert not plain.dfs and len(os.listdir(tmp_path)) == 2
    # a cache file without the row-order fields is rebuilt, not misread
    path = tmp_path / (with_groups + ".npz")
    with np.load(path) as z:
        old = {k: z[k] for k in z.files if k not in ("dfs", "top_rows")}
    np.savez(path, **old)
    assert bvh_native._cache_load(str(path)) is None
    assert _same_table(bvh_native.build(tris, leaf_size=12, arity=32), deep)


def test_build_scene_named_layout_carries_the_row_order(small_deep):
    meshes = pscenes.box_city(n=8, seed=0)[0]
    jb = j_build(jscenes.box_city(n=8, seed=0)[0], leaf_size=12,
                 arity=32).bvh
    arrays = scene_arrays(meshes, leaf_size=12, arity=32)
    b = scene_from_arrays(arrays, "cpu").bvh
    assert jb.top_rows > 0 and b.dfs
    assert np.array_equal(b.table.numpy().view(np.uint32),
                          np.asarray(jb.table).view(np.uint32))
    for f in FIELDS:
        assert getattr(b, f) == getattr(jb, f), f
    default = build_scene(meshes, device="cpu").bvh
    assert (default.arity, default.dfs, default.top_rows) == (16, False, 0)


def _rays(n, seed):
    """Rays from the box [-6, 6]^3 towards points of [-3, 3]^3, where the
    scene's boxes lie."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (n, 3))
    d = rng.uniform(-3, 3, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("arity,leaf,dfs,budget", [
    (16, 6, True, 0), (32, 12, False, 16), (8, 4, False, 24)])
def test_plain_walks_match_jax_on_deep_tables(arity, leaf, dfs, budget):
    tris = _scene()
    pb = bvh8.build(tris, leaf, arity, dfs=dfs, treelet_budget=budget)
    jb = jbvh8.build(tris, leaf, arity, dfs=dfs, treelet_budget=budget)
    assert _same_table(pb, jb)
    o, d = _rays(1000, seed=arity + leaf)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    # op by op: compiling the walks takes longer than running them here
    with jax.disable_jit():
        ref = traverse8.closest_hit(jb, jo, jd, TMIN, TMAX)
        jocc = traverse8.occluded(jb, jo, jd, TMIN, TMAX)
        jocc_n = traverse8.occluded(jb, jo, jd, TMIN, TMAX,
                                    cull_backface=False)

    def walks(b):
        args = (torch.from_numpy(b.table), torch.from_numpy(o),
                torch.from_numpy(d), torch.ones(len(o), dtype=torch.bool),
                TMIN, TMAX, b.stack_depth, arity, leaf)
        return (traverse.closest_hit_plain(*args),
                traverse.occluded_plain(*args),
                traverse.occluded_plain(*args, cull_backface=False))

    got, occ, occ_n = walks(pb)
    h = np.asarray(ref["hit"])
    assert np.array_equal(got["hit"].numpy(), h)
    assert np.array_equal(got["tri_id"].numpy(), np.asarray(ref["tri_id"]))
    np.testing.assert_allclose(got["t"].numpy()[h], np.asarray(ref["t"])[h],
                               rtol=T_RTOL)
    for c in ("u", "v"):
        assert np.abs(got[c].numpy()[h] - np.asarray(ref[c])[h]).max() \
            <= UV_ATOL
    assert 0.2 < h.mean() < 1.0
    assert np.array_equal(occ.numpy(), np.asarray(jocc))
    assert np.array_equal(occ_n.numpy(), np.asarray(jocc_n))
    assert 0 < int(occ.sum()) < int(occ_n.sum()) < len(o)
    # the plain table gives the same hits at the same t
    p_got, p_occ, p_occ_n = walks(bvh8.build(tris, leaf, arity))
    assert torch.equal(p_got["hit"], got["hit"])
    assert torch.equal(p_got["t"], got["t"])
    assert torch.equal(p_occ, occ) and torch.equal(p_occ_n, occ_n)


def _jax_arrays(jscene) -> dict:
    """The JAX scene's arrays under ``scene_from_arrays``'s keys (an
    untextured scene whose probe has sample rows)."""
    b, p = jscene.bvh, jscene.probe
    return {
        "bvh_table": np.asarray(b.table), "bvh_stack_depth": b.stack_depth,
        "bvh_arity": b.arity, "bvh_leaf_size": b.leaf_size,
        "bvh_num_instances": b.num_instances, "bvh_inst_base": b.inst_base,
        "bvh_blas_base": b.blas_base, "bvh_dfs": b.dfs,
        "bvh_top_rows": b.top_rows, "bvh_top_stack": b.top_stack,
        "bvh_treelet_stack": b.treelet_stack,
        "tri_pack": np.asarray(jscene.geom.tri_pack),
        "material_rows": np.asarray(jscene.materials.packed),
        "probe_data": np.asarray(p.data), "probe_pdf_x": np.asarray(p.pdf_x),
        "probe_pdf_y": np.asarray(p.pdf_y),
        "probe_sample_rows": np.asarray(p.sample_rows),
    }


def test_frame_on_jax_treelet_table_matches_jax(small_deep, monkeypatch):
    monkeypatch.setattr(traverse8, "WINDOW_ROWS", 32)
    w, h = 32, 24
    meshes, cam = jscenes.box_city(n=6, seed=2)
    jscene = j_build(meshes, probe=j_sky(width=64, height=32), leaf_size=12,
                     arity=32)
    jb = jscene.bvh
    assert jb.top_rows > 0 and jb.num_rows > bvh_native.build(
        host_triangles(pscenes.box_city(n=6, seed=2)[0]), leaf_size=12,
        arity=32, dfs=False).num_rows  # group rows were added
    sched = jconfig.FoveationSchedule.uniform(1)
    jcam = dataclasses.replace(cam, aspect=w / h).device_params()
    pad = film.schedule_padding(sched, w, h)
    with jax.disable_jit():  # as above: running beats compiling here
        _, jframe, jstats = j_render(
            jscene, jcam, jnp.int32(w // 2), jnp.int32(h // 2), jnp.int32(0),
            jfilm.new_canvas(w, h, pad), jax.random.PRNGKey(0),
            jconfig.RenderConfig(width=w, height=h), sched)
    pscene = scene_from_arrays(_jax_arrays(jscene), "cpu")
    assert pscene.bvh.top_rows == jb.top_rows and pscene.bvh.dfs
    pcam = pscenes.box_city(n=6, seed=2)[1]
    _, frame, stats = render_frame(
        pscene, dataclasses.replace(pcam, aspect=w / h).device_params("cpu"),
        w // 2, h // 2, 0, film.new_canvas(w, h, pad, "cpu"), prng_key(0),
        pconfig.RenderConfig(width=w, height=h),
        pconfig.FoveationSchedule.uniform(1))
    a, b = frame.numpy().astype(int), np.asarray(jframe).astype(int)
    assert (np.abs(a - b).max(-1) <= 1).mean() >= 0.99
    assert int(stats["traces"]) == int(jstats["traces"])
