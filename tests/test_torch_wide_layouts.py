"""The JAX package's wide BVH packings, (arity, leaf size) = (32, 12) and
(32, 24), in the PyTorch port, against the JAX package on the CPU.

- ``bvh_native.build`` equals JAX's ``build(..., dfs=False)`` bit for bit
  (``table``, ``leaf_perm``, ``stack_depth``) at (16, 6), (32, 12) and
  (32, 24) on box_city n=16 (3,084 triangles). The native collapse refuses
  leaves of more than 15 triangles; there the port's ``build`` raised
  ``RuntimeError`` and now collapses in Python, as JAX's does, and the
  npz cache keeps such a table under a key of its own. The two-level
  tables fall through the same way (``tlas.build_instanced``).
- The plain K1, K2 and non-culling K2 on both wide tables against JAX's
  ``traverse8.closest_hit`` and ``occluded`` on the same tables: ``hit``,
  ``tri_id`` and occlusion exact, ``t/u/v`` within the FMA contraction
  ROADMAP §3 records (XLA contracts Möller-Trumbore products on the CPU).
- ``build_scene(leaf_size=12, arity=32)`` renders the frame of JAX's
  ``build_scene(leaf_size=12, arity=32)`` (99% of the pixels within
  1 LSB, ``traces`` equal); without the arguments it keeps (16, 6).
- The kernel wrappers' layout check takes the three compiled layouts at
  their widths (64, 128 and 240 columns) and nothing else, for the
  instanced kernels too. (The kernels themselves: the ``cuda`` tests.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu import config as jconfig
from fovpathtracing_optixcodelatest_tpu.models import scenes as jscenes
from fovpathtracing_optixcodelatest_tpu.models.mesh import (
    host_triangles as j_host_triangles,
)
from fovpathtracing_optixcodelatest_tpu.models.probe import (
    gradient_sky_probe as j_sky,
)
from fovpathtracing_optixcodelatest_tpu.models.scene import build_scene as j_build
from fovpathtracing_optixcodelatest_tpu.ops import bvh_native as jbvh_native
from fovpathtracing_optixcodelatest_tpu.ops import tlas as jtlas
from fovpathtracing_optixcodelatest_tpu.ops import traverse8
from fovpathtracing_optixcodelatest_tpu.render import film as jfilm
from fovpathtracing_optixcodelatest_tpu.render.renderer import render_frame as j_render
from fovpathtracing_optixcodelatest_tpu_torch import config as pconfig
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes as pscenes
from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import host_triangles
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import gradient_sky_probe
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import build_scene
from fovpathtracing_optixcodelatest_tpu_torch.ops import (
    bvh8,
    bvh_native,
    kernel_build,
    tlas,
    traverse,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import prng_key
from fovpathtracing_optixcodelatest_tpu_torch.render import film
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import render_frame
from torch_blas_fields import _translate, leaf_slots, pyramid_tris, twin_tris
from torch_stand_in_kernels import stand_in_kernels  # noqa: F401 (a fixture)

torch.set_num_threads(2)

TMIN, TMAX = 0.01, 1e16
# ROADMAP §3: XLA's FMA contraction moves t by up to 19 ulp on cornell's
# icosphere and u/v by up to 1.2e-6
T_RTOL, UV_ATOL = 3e-6, 2e-6
WIDE = [(32, 12), (32, 24)]


@pytest.fixture(scope="module")
def city16():
    tris = host_triangles(pscenes.box_city(n=16, seed=0)[0])
    jtris = j_host_triangles(jscenes.box_city(n=16, seed=0)[0])
    assert tris.shape == (3084, 3, 3) and np.array_equal(tris, jtris)
    return tris


@pytest.fixture(autouse=True)
def no_cache(monkeypatch):
    # every build here packs anew: the scenes are far below the cache's
    # threshold, and a test that wants the cache turns it on itself
    monkeypatch.setenv("FOVTPU_BVH_CACHE", "")


def _same_table(got, want) -> bool:
    return (np.array_equal(got.table.view(np.uint32),
                           np.asarray(want.table).view(np.uint32))
            and np.array_equal(got.leaf_perm, np.asarray(want.leaf_perm))
            and got.stack_depth == want.stack_depth
            and (got.arity, got.leaf_size) == (want.arity, want.leaf_size))


@pytest.mark.parametrize("arity,leaf", [(16, 6), *WIDE])
def test_build_equals_jax_bit_for_bit(city16, arity, leaf):
    got = bvh_native.build(city16, leaf_size=leaf, arity=arity)
    want = jbvh_native.build(city16, leaf_size=leaf, arity=arity, dfs=False)
    assert got.table.shape[1] == max(4 * arity, 10 * leaf)
    assert _same_table(got, want)


def test_l24_build_falls_through_to_the_python_collapse(city16):
    # the native collapse refuses the layout: the build used to raise here
    assert bvh_native.collapse(city16, 24, 32) is None
    assert bvh_native.collapse(city16, 12, 32) is not None
    got = bvh_native.build(city16, leaf_size=24, arity=32)
    assert _same_table(got, bvh8.build(city16, leaf_size=24, arity=32))
    assert _same_table(got, jbvh_native.build(city16, leaf_size=24,
                                              arity=32, dfs=False))
    # the native (32, 12) table is not the Python collapse's
    native = bvh_native.build(city16, leaf_size=12, arity=32)
    assert not _same_table(native, bvh8.build(city16, leaf_size=12,
                                              arity=32))


def test_python_collapsed_tables_cache_under_their_own_key(
        city16, tmp_path, monkeypatch):
    import os

    monkeypatch.setenv("FOVTPU_BVH_CACHE", str(tmp_path))
    monkeypatch.setattr(bvh_native, "BVH_CACHE_MIN_TRIS", 1)
    cold, warm = {}, {}
    built = bvh_native.build(city16, leaf_size=24, arity=32, timings=cold)
    again = bvh_native.build(city16, leaf_size=24, arity=32, timings=warm)
    assert "collapse_s" in cold and set(warm) == {"key_s", "load_s"}
    assert _same_table(again, built)
    name = bvh_native._cache_key(city16, 24, 32) + ".npz"
    assert os.listdir(tmp_path) == [name]
    # a native table of another layout takes a key of its own; a forced
    # Python build of a layout the native collapse takes neither reads the
    # native table cached under that layout nor is cached itself
    native = bvh_native.build(city16, leaf_size=12, arity=32)
    forced = bvh_native.build(city16, leaf_size=12, arity=32,
                              force_python=True)
    assert len(os.listdir(tmp_path)) == 2
    assert _same_table(forced, bvh8.build(city16, leaf_size=12, arity=32))
    assert not _same_table(forced, native)


@pytest.mark.parametrize("arity,leaf", WIDE)
def test_two_level_tables_fall_through_as_jax(city16, arity, leaf):
    # BLASes of 1,500 and 6 triangles under a TLAS of 8 instances: the
    # (32, 24) BLASes are the Python collapse's, as in the JAX package
    field = ([city16[:1500], pyramid_tris()], [0, 1] * 4,
             [_translate(40.0 * k, 0.0, 0.0) for k in range(8)])
    want = jtlas.build_instanced(*field, leaf_size=leaf, arity=arity)
    got = tlas.build_instanced(*field, leaf_size=leaf, arity=arity)
    assert np.array_equal(got.table.view(np.uint32),
                          np.asarray(want.table).view(np.uint32))
    assert np.array_equal(got.leaf_perm, np.asarray(want.leaf_perm))
    for f in ("stack_depth", "num_instances", "inst_base", "blas_base",
              "arity", "leaf_size"):
        assert getattr(got, f) == getattr(want, f), f


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform((-30.0, 0.0, -30.0), (30.0, 20.0, 30.0), (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("arity,leaf", WIDE)
def test_plain_walks_match_jax_on_wide_tables(arity, leaf):
    tris = host_triangles(pscenes.box_city(n=8, seed=1)[0])
    jb = jbvh_native.build(tris, leaf_size=leaf, arity=arity, dfs=False)
    pb = bvh_native.build(tris, leaf_size=leaf, arity=arity)
    assert _same_table(pb, jb)
    o, d = _rays(1500, seed=arity + leaf)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    # op by op: compiling the A32 walks takes longer than running them here
    with jax.disable_jit():
        ref = traverse8.closest_hit(jb, jo, jd, TMIN, TMAX)
        jocc = traverse8.occluded(jb, jo, jd, TMIN, TMAX)
        jocc_n = traverse8.occluded(jb, jo, jd, TMIN, TMAX,
                                    cull_backface=False)
    args = (torch.from_numpy(pb.table), torch.from_numpy(o),
            torch.from_numpy(d), torch.ones(len(o), dtype=torch.bool), TMIN,
            TMAX, pb.stack_depth, arity, leaf)
    got = traverse.closest_hit_plain(*args)
    h = np.asarray(ref["hit"])
    assert np.array_equal(got["hit"].numpy(), h)
    assert np.array_equal(got["tri_id"].numpy(), np.asarray(ref["tri_id"]))
    np.testing.assert_allclose(got["t"].numpy()[h], np.asarray(ref["t"])[h],
                               rtol=T_RTOL)
    for c in ("u", "v"):
        assert np.abs(got[c].numpy()[h] - np.asarray(ref[c])[h]).max() \
            <= UV_ATOL
    assert 0.2 < h.mean() < 1.0
    occ = traverse.occluded_plain(*args)
    occ_n = traverse.occluded_plain(*args, cull_backface=False)
    assert np.array_equal(occ.numpy(), np.asarray(jocc))
    assert np.array_equal(occ_n.numpy(), np.asarray(jocc_n))
    assert 0 < int(occ.sum()) < int(occ_n.sum()) < len(o)


def test_plain_k1_keeps_the_lower_slot_of_a_tie_as_jax():
    """A leaf holding a triangle twice: both copies hit at the same t, and
    the closest hit is the lower slot's, as JAX's serial ``t < best`` leaf
    loop keeps it (the kernels' group min-reduction must keep it too)."""
    tris = twin_tris()
    half = len(tris) // 2
    jb = jbvh_native.build(tris, leaf_size=12, arity=32, dfs=False)
    pb = bvh_native.build(tris, leaf_size=12, arity=32)
    assert _same_table(pb, jb)
    rng = np.random.default_rng(4)
    n = 512
    o = np.concatenate([rng.uniform(-4.9, 4.9, (n, 1)), np.full((n, 1), 5.0),
                        rng.uniform(-4.9, 4.9, (n, 1))], 1).astype(np.float32)
    d = np.concatenate([rng.normal(0, 0.05, (n, 1)), -np.ones((n, 1)),
                        rng.normal(0, 0.05, (n, 1))], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    with jax.disable_jit():
        ref = traverse8.closest_hit(jb, jnp.asarray(o), jnp.asarray(d), TMIN,
                                    TMAX)
    got = traverse.closest_hit_plain(
        torch.from_numpy(pb.table), torch.from_numpy(o), torch.from_numpy(d),
        torch.ones(n, dtype=torch.bool), TMIN, TMAX, pb.stack_depth, 32, 12)
    ids = got["tri_id"].numpy()
    assert np.array_equal(ids, np.asarray(ref["tri_id"]))
    hit = got["hit"].numpy()
    assert hit.mean() > 0.95  # a ray on a cell's edge may slip through
    ids = ids[hit]
    slots = leaf_slots(pb.table, 32, 12)
    twin = np.where(ids < half, ids + half, ids - half)
    for tid, other in zip(ids.tolist(), twin.tolist()):
        assert slots[tid][0] == slots[other][0]  # one leaf row
        assert slots[tid][1] < slots[other][1]  # the lower slot


def test_frame_matches_jax_at_l12_a32():
    w, h = 32, 24
    meshes, cam = jscenes.box_city(n=6, seed=2)
    jscene = j_build(meshes, probe=j_sky(width=64, height=32), leaf_size=12,
                     arity=32)
    assert (jscene.bvh.arity, jscene.bvh.leaf_size) == (32, 12)
    assert not jscene.bvh.dfs
    sched = jconfig.FoveationSchedule.uniform(1)
    jcam = dataclasses.replace(cam, aspect=w / h).device_params()
    pad = film.schedule_padding(sched, w, h)
    with jax.disable_jit():  # as above: running beats compiling here
        _, jframe, jstats = j_render(
            jscene, jcam, jnp.int32(w // 2), jnp.int32(h // 2), jnp.int32(0),
            jfilm.new_canvas(w, h, pad), jax.random.PRNGKey(0),
            jconfig.RenderConfig(width=w, height=h), sched)
    pmeshes, pcam = pscenes.box_city(n=6, seed=2)
    pscene = build_scene(pmeshes, gradient_sky_probe(width=64, height=32),
                         device="cpu", leaf_size=12, arity=32)
    pb = pscene.bvh
    assert (pb.arity, pb.leaf_size, pb.table.shape[1]) == (32, 12, 128)
    assert np.array_equal(pb.table.numpy().view(np.uint32),
                          np.asarray(jscene.bvh.table).view(np.uint32))
    _, frame, stats = render_frame(
        pscene, dataclasses.replace(pcam, aspect=w / h).device_params("cpu"),
        w // 2, h // 2, 0, film.new_canvas(w, h, pad, "cpu"), prng_key(0),
        pconfig.RenderConfig(width=w, height=h),
        pconfig.FoveationSchedule.uniform(1))
    a, b = frame.numpy().astype(int), np.asarray(jframe).astype(int)
    assert (np.abs(a - b).max(-1) <= 1).mean() >= 0.99
    assert int(stats["traces"]) == int(jstats["traces"])


def test_build_scene_keeps_the_default_layout():
    meshes = pscenes.box_city(n=4, seed=0)[0]
    b = build_scene(meshes, device="cpu").bvh
    assert (b.arity, b.leaf_size) == (bvh8.ARITY, bvh8.LEAF_SIZE) == (16, 6)
    wide = build_scene(meshes, device="cpu", leaf_size=24, arity=32).bvh
    assert (wide.arity, wide.leaf_size, wide.table.shape[1]) == (32, 24, 240)
    # one argument alone: the other keeps its default
    half = build_scene(meshes, device="cpu", leaf_size=3).bvh
    assert (half.arity, half.leaf_size) == (16, 3)


@pytest.mark.parametrize("arity,leaf,width", [(16, 6, 64), (32, 12, 128),
                                              (32, 24, 240)])
def test_kernel_layout_takes_the_compiled_layouts(arity, leaf, width):
    assert traverse.KERNEL_LAYOUTS[(arity, leaf)] == width
    table = torch.zeros((4, width))
    traverse._kernel_layout(table, 10, arity, leaf)
    for other in (64, 128, 240):
        if other != width:
            with pytest.raises(ValueError, match="columns"):
                traverse._kernel_layout(torch.zeros((4, other)), 10, arity,
                                        leaf)
    for bad in ((32, 6), (64, 12), (16, 12), (32, 16)):
        with pytest.raises(ValueError, match="layout"):
            traverse._kernel_layout(table, 10, *bad)


def test_wide_launch_counters(stand_in_kernels):
    # a wide layout's launches are counted beside the kernel's own count
    stand_in_kernels.structs["fov_traverse"] = traverse.TraverseArgs
    for lay in traverse.WIDE_LAYOUTS:
        for k in traverse.LAYOUT_KERNELS:  # none launched: each reads 0
            assert kernel_build.LAUNCHES[traverse.layout_name(k, *lay)] == 0
    rays = (torch.zeros((4, 128)), torch.zeros((3, 3)), torch.ones((3, 3)),
            torch.ones(3, dtype=torch.bool), 0.0, 1.0, 8)
    traverse._launch("closest_hit", traverse.TraverseArgs(), *rays, 32, 12)
    traverse._launch("occluded", traverse.TraverseArgs(), *rays, 16, 6)
    assert kernel_build.LAUNCHES == {"closest_hit": 1,
                                     "closest_hit_a32_l12": 1, "occluded": 1}
    assert kernel_build.LAUNCHES["occluded_a32_l12"] == 0
    # the struct names the kernel and the layout
    got = [c[2] for c in stand_in_kernels.calls]
    assert [(a.which, a.arity, a.leaf, a.n) for a in got] == [
        (0, 32, 12, 3), (1, 16, 6, 3)]
    kernel_build.reset_launches()
    assert not any(kernel_build.LAUNCHES.values())
