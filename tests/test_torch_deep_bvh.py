"""Deep scenes in the PyTorch port (``ops/bvh_native.py``) against the JAX
package on the CPU.

- Parity with JAX's deep path: with ``DEEP_TRIS_THRESHOLD``,
  ``DEEP_TREELET_BUDGET`` and ``traverse8.WINDOW_ROWS`` made small (as
  ``tests/test_bvh.py`` does), JAX builds a small scene as a deep scene (an
  L12/A32 table in DFS order with treelets) and walks it; the port's plain
  K1/K2 on its (16, 6) table must give the same ``hit``, ``tri_id`` and
  occlusion, and ``t/u/v`` within the FMA contraction ROADMAP §3 records
  (XLA contracts Möller-Trumbore products on the CPU); the rendered frames
  agree on at least 99% of the pixels within 1 LSB.
- The 1M refusal is gone: ``box_city_fast(n=300)`` (1,080,012 triangles)
  builds the (16, 6) table with its exact stack bound, and the plain K1
  agrees with the brute-force oracle on 64 rays.
- The npz cache (the port of ``tests/test_bvh_cache.py``): a cache hit is
  bit-identical, one file a key, a new key for new parameters, geometry or
  packing code.
- ``Scene.memory_report``'s byte counts equal JAX's for the arrays both
  packages keep on the device.
"""

import dataclasses
import os

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
from fovpathtracing_optixcodelatest_tpu.ops import bvh_native as jbvh_native
from fovpathtracing_optixcodelatest_tpu.ops import traverse8
from fovpathtracing_optixcodelatest_tpu.render.renderer import render_frame as j_render
from fovpathtracing_optixcodelatest_tpu_torch import config as pconfig
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes as pscenes
from fovpathtracing_optixcodelatest_tpu_torch.models.material import Material
from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
    host_triangles,
    make_box,
    make_icosphere,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import gradient_sky_probe
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import build_scene
from fovpathtracing_optixcodelatest_tpu_torch.ops import bvh8, bvh_native, intersect
from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import prng_key
from fovpathtracing_optixcodelatest_tpu_torch.render import film
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import render_frame

torch.set_num_threads(2)

TMIN, TMAX = 0.01, 1e16
# ROADMAP §3: XLA's FMA contraction moves t by up to 19 ulp on cornell's
# icosphere and u/v by up to 1.2e-6
T_RTOL, UV_ATOL = 3e-6, 2e-6


@pytest.fixture
def jax_deep(monkeypatch):
    """JAX's deep path, engaged at small sizes."""
    monkeypatch.setattr(jbvh_native, "DEEP_TRIS_THRESHOLD", 100)
    monkeypatch.setattr(jbvh_native, "DEEP_TREELET_BUDGET", 16)
    monkeypatch.setattr(traverse8, "WINDOW_ROWS", 32)


def _rays(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _walk_args(b):
    return (b.stack_depth, b.arity, b.leaf_size)


def test_plain_walks_match_jax_deep_path(jax_deep):
    meshes, _ = jscenes.box_city(n=6, seed=2)
    jscene = j_build(meshes)
    jb = jscene.bvh
    assert (jb.leaf_size, jb.arity) == (12, 32) and jb.dfs and jb.top_rows
    pscene = build_scene(pscenes.box_city(n=6, seed=2)[0], device="cpu")
    pb = pscene.bvh
    assert (pb.arity, pb.leaf_size) == (bvh8.ARITY, bvh8.LEAF_SIZE)
    o, d = _rays(2000, (-40.0, 0.0, -40.0), (40.0, 25.0, 40.0), seed=4)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    # op by op: compiling the A32 walks takes longer than running them here
    with jax.disable_jit():
        ref = traverse8.closest_hit(jb, jo, jd, TMIN, TMAX)
        jocc = traverse8.occluded(jb, jo, jd, TMIN, TMAX)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    every = torch.ones(len(o), dtype=torch.bool)
    got = traverse.closest_hit_plain(pb.table, ot, dt, every, TMIN, TMAX,
                                     *_walk_args(pb))
    h = np.asarray(ref["hit"])
    assert np.array_equal(got["hit"].numpy(), h)
    assert np.array_equal(got["tri_id"].numpy(), np.asarray(ref["tri_id"]))
    np.testing.assert_allclose(got["t"].numpy()[h], np.asarray(ref["t"])[h],
                               rtol=T_RTOL)
    for c in ("u", "v"):
        assert np.abs(got[c].numpy()[h] - np.asarray(ref[c])[h]).max() \
            <= UV_ATOL
    assert 0.2 < got["hit"].float().mean() < 1.0
    occ = traverse.occluded_plain(pb.table, ot, dt, every, TMIN, TMAX,
                                  *_walk_args(pb))
    assert np.array_equal(occ.numpy(), np.asarray(jocc))
    assert 0 < int(occ.sum()) < len(o)


def test_frame_matches_jax_deep_path(jax_deep):
    w, h = 32, 24
    meshes, cam = jscenes.box_city(n=6, seed=2)
    jscene = j_build(meshes, probe=j_sky(width=64, height=32))
    assert jscene.bvh.top_rows > 0  # JAX built it as a deep scene
    sched = jconfig.FoveationSchedule.uniform(1)
    jcam = dataclasses.replace(cam, aspect=w / h).device_params()
    pad = film.schedule_padding(sched, w, h)
    from fovpathtracing_optixcodelatest_tpu.render import film as jfilm

    with jax.disable_jit():  # as above: running beats compiling here
        _, jframe, jstats = j_render(
            jscene, jcam, jnp.int32(w // 2), jnp.int32(h // 2), jnp.int32(0),
            jfilm.new_canvas(w, h, pad), jax.random.PRNGKey(0),
            jconfig.RenderConfig(width=w, height=h), sched)
    pmeshes, pcam = pscenes.box_city(n=6, seed=2)
    pscene = build_scene(pmeshes, gradient_sky_probe(width=64, height=32),
                         device="cpu")
    _, frame, stats = render_frame(
        pscene, dataclasses.replace(pcam, aspect=w / h).device_params("cpu"),
        w // 2, h // 2, 0, film.new_canvas(w, h, pad, "cpu"), prng_key(0),
        pconfig.RenderConfig(width=w, height=h),
        pconfig.FoveationSchedule.uniform(1))
    a, b = frame.numpy().astype(int), np.asarray(jframe).astype(int)
    assert (np.abs(a - b).max(-1) <= 1).mean() >= 0.99
    assert int(stats["traces"]) == int(jstats["traces"])


def test_million_triangle_scene_builds(monkeypatch):
    monkeypatch.setenv("FOVTPU_BVH_CACHE", "")  # build, do not load
    meshes, _ = pscenes.box_city_fast(n=300, seed=0)
    tris = host_triangles(meshes)
    assert tris.shape[0] == 1_080_012
    timings = {}
    wb = bvh_native.build(tris, timings=timings)  # was NotImplementedError
    assert set(timings) == {"collapse_s", "pack_s"}
    assert (wb.arity, wb.leaf_size) == (bvh8.ARITY, bvh8.LEAF_SIZE)
    assert wb.table.shape[1] == 4 * bvh8.ARITY
    node_rows = int((wb.leaf_perm == -1).all(axis=1).sum())
    codes = wb.table[:node_rows, 3 * wb.arity: 4 * wb.arity].view(np.int32)
    assert wb.stack_depth == bvh8.lifo_stack_bound(codes) + 1
    assert wb.stack_depth <= traverse.MAX_STACK
    # every triangle sits in exactly one leaf slot
    ids = wb.leaf_perm[wb.leaf_perm >= 0]
    assert ids.size == tris.shape[0] and np.unique(ids).size == ids.size
    o, d = _rays(64, (-40.0, 1.0, -40.0), (40.0, 20.0, 40.0), seed=3)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    got = traverse.closest_hit_plain(
        torch.from_numpy(wb.table), ot, dt, torch.ones(64, dtype=torch.bool),
        TMIN, TMAX, *_walk_args(wb))
    t = torch.from_numpy(tris)
    ref = intersect.brute_force_closest_hit(t[:, 0], t[:, 1] - t[:, 0],
                                            t[:, 2] - t[:, 0], ot, dt, TMIN,
                                            TMAX, chunk=65536)
    assert torch.equal(got["hit"], ref["hit"]) and bool(got["hit"].any())
    h = got["hit"]
    assert torch.equal(got["t"][h], ref["t"][h])
    # a different visit order may only pick another triangle at an exact tie
    assert (got["tri_id"][h] != ref["tri_id"][h]).sum() <= 1


def _tris():
    rng = np.random.default_rng(7)
    meshes = [make_icosphere((0, 0, 0), 1.0, 2, Material())]
    for _ in range(8):
        meshes.append(make_box(tuple(rng.uniform(-3, 3, 3)),
                               tuple(rng.uniform(0.2, 0.6, 3)), Material()))
    return host_triangles(meshes)


def test_bvh_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("FOVTPU_BVH_CACHE", str(tmp_path))
    monkeypatch.setattr(bvh_native, "BVH_CACHE_MIN_TRIS", 1)
    tris = _tris()
    cold = {}
    wb1 = bvh_native.build(tris, timings=cold)
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix == ".npz"
    assert set(cold) == {"key_s", "collapse_s", "pack_s", "save_s"}

    warm = {}
    wb2 = bvh_native.build(tris, timings=warm)  # a cache hit
    assert set(warm) == {"key_s", "load_s"}
    assert np.array_equal(wb1.table.view(np.uint32), wb2.table.view(np.uint32))
    assert np.array_equal(wb1.leaf_perm, wb2.leaf_perm)
    for f in dataclasses.fields(wb1):
        if f.name not in ("table", "leaf_perm"):
            assert getattr(wb1, f.name) == getattr(wb2, f.name), f.name
            assert type(getattr(wb2, f.name)) is type(getattr(wb1, f.name))

    # other packing parameters -> another key -> a second file
    bvh_native.build(tris, leaf_size=4, arity=8)
    assert len(list(tmp_path.iterdir())) == 2
    # other geometry -> another key
    tris2 = tris.copy()
    tris2[0, 0, 0] += 0.25
    bvh_native.build(tris2)
    assert len(list(tmp_path.iterdir())) == 3
    # "" disables the cache; small scenes are never cached
    monkeypatch.setenv("FOVTPU_BVH_CACHE", "")
    bvh_native.build(tris2 + 1.0)
    monkeypatch.setenv("FOVTPU_BVH_CACHE", str(tmp_path))
    monkeypatch.setattr(bvh_native, "BVH_CACHE_MIN_TRIS", 10**6)
    bvh_native.build(tris2 + 2.0)
    assert len(list(tmp_path.iterdir())) == 3


def test_bvh_cache_key_follows_the_packing_sources(tmp_path, monkeypatch):
    # the key hashes the packing code's sources: an edit of any of them
    # (here a copy of one with a byte added) gives a new key, and the
    # cache then builds anew instead of returning the old table
    tris = _tris()
    names = [os.path.basename(p) for p in bvh_native.PACKING_SOURCES]
    assert names == ["bvh_builder.cpp", "bvh8.py", "bvh_native.py"]
    key = bvh_native._cache_key(tris, 6, 16)
    assert key == bvh_native._cache_key(tris, 6, 16)
    edited = tmp_path / "bvh8.py"
    edited.write_bytes(open(bvh_native.PACKING_SOURCES[1], "rb").read()
                       + b"\n")
    sources = list(bvh_native.PACKING_SOURCES)
    sources[1] = str(edited)
    monkeypatch.setattr(bvh_native, "PACKING_SOURCES", tuple(sources))
    bvh_native.packing_digest.cache_clear()
    try:
        assert bvh_native._cache_key(tris, 6, 16) != key
        monkeypatch.setenv("FOVTPU_BVH_CACHE", str(tmp_path / "cache"))
        monkeypatch.setattr(bvh_native, "BVH_CACHE_MIN_TRIS", 1)
        timings = {}
        bvh_native.build(tris, timings=timings)
        assert "collapse_s" in timings  # a miss: built, not loaded
    finally:
        monkeypatch.undo()
        bvh_native.packing_digest.cache_clear()
    assert bvh_native._cache_key(tris, 6, 16) == key


def test_memory_report_counts_match_jax():
    meshes, _ = jscenes.box_city(n=4, seed=0)
    jscene = j_build(meshes, probe=j_sky(width=64, height=32))
    pscene = build_scene(pscenes.box_city(n=4, seed=0)[0],
                         gradient_sky_probe(width=64, height=32),
                         device="cpu", shading_normals=True)
    parts = pscene.memory_bytes()
    assert parts["bvh.table"] == jscene.bvh.table.nbytes
    assert parts["geom.tri_pack"] == jscene.geom.tri_pack.nbytes
    # the probe's tables (sample rows and the two marginal pdfs)
    p = jscene.probe
    assert parts["probe"] == sum(np.asarray(x).nbytes for x in (
        p.data, p.pdf_x, p.pdf_y, p.sample_rows))
    # the corner shading normals (9 floats) and their flag, as JAX keeps
    # tri_n0..2 and has_shading_normals in its unpacked geometry; the path
    # tracer's scenes leave them out
    assert parts["geom.shading_normals"] == pscene.num_triangles * 10 * 4
    slim = build_scene(pscenes.box_city(n=4, seed=0)[0], device="cpu")
    assert slim.shading_normals is None
    assert slim.memory_bytes()["geom.shading_normals"] == 0
    report = pscene.memory_report(n_rays=1000)
    assert report.startswith("scene ") and "bvh.table" in report
