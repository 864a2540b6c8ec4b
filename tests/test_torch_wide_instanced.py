"""Two-level tables at the wide layouts (32, 12) and (32, 24) in the
PyTorch port, against the JAX package on the CPU.

``tlas.build_instanced(leaf_size=, arity=)`` packs them in both packages
(bit for bit); the port's plain instanced walks take them as
``traverse8``'s walks do, and on a CUDA tensor the instanced wrappers now
launch the kernels compiled at those layouts (``tests/
test_torch_kernels_cuda.py`` holds those to the plain versions on the
card). The plain occlusion walk is also held to JAX's on the tables the
card's two-level K2 is tested on for its exit inside a leaf (one BLAS
leaf, its occluder at each slot, ``torch_blas_fields.place_leaf_slots``)
and its code reads a group of four at a time (children spread over a
node row, ``spread_children``), answering as on the tables as built.

Tolerances (``tests/test_torch_instancing.py``'s): ``hit``, ``tri_id``,
``inst`` and the occlusion answer exact; ``t`` within rtol 2e-5 / atol
1e-4 and u/v within 2e-5 (XLA on the CPU contracts the instance transform
and the Möller-Trumbore products into FMAs); frames on at least 99% of the
pixels within 1 LSB, ``traces`` exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu import config as jconfig
from fovpathtracing_optixcodelatest_tpu.models.probe import (
    gradient_sky_probe as j_sky,
)
from fovpathtracing_optixcodelatest_tpu.models.scene import (
    build_scene_instanced as j_build_instanced,
)
from fovpathtracing_optixcodelatest_tpu.ops import tlas as jtlas
from fovpathtracing_optixcodelatest_tpu.ops import traverse8
from fovpathtracing_optixcodelatest_tpu.render import film as jfilm
from fovpathtracing_optixcodelatest_tpu.render.renderer import render_frame as j_render
from fovpathtracing_optixcodelatest_tpu_torch import config as pconfig
from fovpathtracing_optixcodelatest_tpu_torch.config import FoveationSchedule
from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import scene_from_arrays
from fovpathtracing_optixcodelatest_tpu_torch.ops import (
    kernel_build,
    tlas,
    traverse,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import prng_key
from fovpathtracing_optixcodelatest_tpu_torch.render import film
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import render_frame
from fovpathtracing_optixcodelatest_tpu_torch.tools import kernel_times
from test_instancing import _grid_scene, _rays_grid
from test_torch_textures import jax_scene_arrays
from torch_blas_fields import (
    _translate,
    gap_rows,
    leaf_root,
    occluder_field,
    occluder_order,
    occluder_rays,
    place_leaf_slots,
    pyramid_tris,
    spread_children,
)
from torch_stand_in_kernels import stand_in_kernels  # noqa: F401 (a fixture)

torch.set_num_threads(2)

TMIN, TMAX = 0.01, 1e16
WIDE = [(32, 12), (32, 24)]
INST = ("stack_depth", "num_instances", "inst_base", "blas_base", "arity",
        "leaf_size")


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.uint32)


def _tables(field, arity, leaf):
    """Both packages' two-level tables of ``field`` (unique triangles, mesh
    ids, transforms) at the layout, equal bit for bit."""
    jb = jtlas.build_instanced(*field, leaf_size=leaf, arity=arity)
    pb = tlas.build_instanced(*field, leaf_size=leaf, arity=arity)
    assert np.array_equal(_bits(jb.table), _bits(pb.table))
    assert np.array_equal(np.asarray(jb.leaf_perm), pb.leaf_perm)
    for f in INST:
        assert getattr(jb, f) == getattr(pb, f), f
    assert pb.table.shape[1] == max(4 * arity, 10 * leaf)
    return jb, pb


def _grid_field():
    jsc = _grid_scene(5, 5, rot=True)
    return jtlas.scene_tables_from_instanced(jsc)


def _leaf_field(leaf):
    """A pyramid and a leaf's worth of pyramids (``leaf`` triangles) under 8
    instances: each BLAS root node has one leaf child."""
    big = np.concatenate([pyramid_tris() + np.float32([1.0 * j, 0.0, 0.0])
                          for j in range(leaf // 6)])
    return ([pyramid_tris(), big], [0, 1] * 4,
            [_translate(3.0 * (k % 4), 0.0, 3.0 * (k // 4))
             for k in range(8)])


@pytest.mark.parametrize("entry", ["root", "leaf"])
@pytest.mark.parametrize("arity,leaf", WIDE)
def test_plain_instanced_walks_match_jax_at_wide_layouts(arity, leaf, entry):
    field = _grid_field() if entry == "root" else _leaf_field(leaf)
    jb, pb = _tables(field, arity, leaf)
    table = pb.table
    if entry == "leaf":  # the instances enter each BLAS at its leaf row
        table = leaf_root(pb.table, pb.inst_base, pb.blas_base, arity)
        jb = dataclasses.replace(jb, table=jnp.asarray(table))
    o, d = _rays_grid(2048, seed=arity + leaf, extent=9.0)
    # op by op: compiling the A32 walks takes longer than running them here
    with jax.disable_jit():
        want = traverse8.closest_hit(jb, o, d, TMIN, TMAX)
        jocc = traverse8.occluded(jb, o, d, TMIN, TMAX)
    args = (torch.tensor(table), torch.tensor(np.asarray(o)),
            torch.tensor(np.asarray(d)), torch.ones(2048, dtype=torch.bool),
            TMIN, TMAX, pb.stack_depth, arity, leaf)
    kw = {"num_instances": pb.num_instances, "inst_base": pb.inst_base,
          "blas_base": pb.blas_base}
    got = traverse.closest_hit_plain(*args, **kw)
    for f in ("hit", "tri_id", "inst"):
        assert np.array_equal(got[f].numpy(), np.asarray(want[f])), f
    hit = got["hit"].numpy()
    assert 0.01 < hit.mean() < 1.0  # the pyramids are small: 2% of rays
    assert len(np.unique(got["inst"].numpy()[hit])) > 4
    np.testing.assert_allclose(got["t"].numpy()[hit],
                               np.asarray(want["t"])[hit], rtol=2e-5,
                               atol=1e-4)
    for f in ("u", "v"):
        np.testing.assert_allclose(got[f].numpy()[hit],
                                   np.asarray(want[f])[hit], rtol=0,
                                   atol=2e-5)
    occ = traverse.occluded_plain(*args, **kw).numpy()
    assert np.array_equal(occ, np.asarray(jocc))
    assert 0 < occ.sum() < len(occ)


def test_plain_walks_match_jax_on_a_box_city_blas():
    # the deep field's BLAS at a small size (kernel_times.deep_field: two
    # instances of box_city_fast(6)'s 444 triangles, 82 apart) at (32, 12):
    # both packages' tables bit for bit, the plain walks against traverse8's
    sc, _ = kernel_times.deep_field(6, 2)
    field = tlas.scene_tables_from_instanced(sc)
    assert [len(t) for t in field[0]] == [444] and field[1] == [0, 0]
    jb, pb = _tables(field, 32, 12)
    assert pb.num_rows - pb.blas_base > 10  # a BLAS of many rows
    n = 1024
    rng = np.random.default_rng(17)
    o = np.stack([rng.uniform(-85.0, 85.0, n), rng.uniform(10.0, 30.0, n),
                  rng.uniform(-45.0, 45.0, n)], 1).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d[:, 1] = -np.abs(d[:, 1]) - 0.3
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    with jax.disable_jit():  # op by op, as above
        want = traverse8.closest_hit(jb, jnp.asarray(o), jnp.asarray(d),
                                     TMIN, TMAX)
        jocc = traverse8.occluded(jb, jnp.asarray(o), jnp.asarray(d), TMIN,
                                  TMAX)
    args = (torch.tensor(pb.table), torch.tensor(o), torch.tensor(d),
            torch.ones(n, dtype=torch.bool), TMIN, TMAX, pb.stack_depth, 32,
            12)
    kw = {"num_instances": 2, "inst_base": pb.inst_base,
          "blas_base": pb.blas_base}
    got = traverse.closest_hit_plain(*args, **kw)
    for f in ("hit", "tri_id", "inst"):
        assert np.array_equal(got[f].numpy(), np.asarray(want[f])), f
    hit = got["hit"].numpy()
    assert hit.mean() > 0.5 and set(got["inst"].numpy()[hit]) == {0, 1}
    np.testing.assert_allclose(got["t"].numpy()[hit],
                               np.asarray(want["t"])[hit], rtol=2e-5,
                               atol=1e-4)
    for f in ("u", "v"):
        np.testing.assert_allclose(got[f].numpy()[hit],
                                   np.asarray(want[f])[hit], rtol=0,
                                   atol=2e-5)
    occ = traverse.occluded_plain(*args, **kw).numpy()
    assert np.array_equal(occ, np.asarray(jocc))
    assert 0 < occ.sum() < n


def _occluded_against_jax(jb, pb, table, o, d, arity, leaf):
    """The plain two-level K2 on ``table`` (``pb``'s, its words moved)
    against ``traverse8.occluded`` on the same words (``jb`` its table's
    JAX build), op by op; returns the port's answer."""
    jb = dataclasses.replace(jb, table=jnp.asarray(table))
    with jax.disable_jit():  # op by op, as above
        want = traverse8.occluded(jb, jnp.asarray(o), jnp.asarray(d), TMIN,
                                  TMAX)
    args = (torch.tensor(table), torch.tensor(o), torch.tensor(d),
            torch.ones(o.shape[0], dtype=torch.bool), TMIN, TMAX,
            pb.stack_depth, arity, leaf)
    occ = traverse.occluded_plain(*args, num_instances=pb.num_instances,
                                  inst_base=pb.inst_base,
                                  blas_base=pb.blas_base)
    assert np.array_equal(occ.numpy(), np.asarray(want))
    return occ.numpy()


@pytest.mark.parametrize("arity,leaf,slot", [
    *[(32, 12, s) for s in (0, 2, 3, 11)],
    *[(32, 24, s) for s in (0, 2, 3, 11, 23)]])
def test_plain_occlusion_matches_jax_with_the_occluder_at_each_slot(
        arity, leaf, slot):
    # the leaf layouts the card's exit inside a leaf is held to
    # (tests/test_torch_kernels_cuda.py): one BLAS leaf, the occluder at
    # ``slot`` behind back faces and before farther triangles, under an
    # instance as is and one mirrored in y, whose object-space winding
    # makes the back faces occlude and the occluder a back face
    jb, pb = _tables(occluder_field(leaf), arity, leaf)
    order = occluder_order(leaf, slot)
    assert sorted(order) == list(range(leaf)) and order[slot] == 0
    table = place_leaf_slots(pb.table, pb.inst_base, pb.blas_base, arity,
                             leaf, order)
    o, d = occluder_rays(512, 71 + slot)
    occ = _occluded_against_jax(jb, pb, table, o, d, arity, leaf)
    # the slots do not change the answer
    assert np.array_equal(
        occ, _occluded_against_jax(jb, pb, pb.table, o, d, arity, leaf))
    first, mirrored = occ[0::2], occ[1::2]
    assert 0 < first.sum() < len(first) and 0 < mirrored.sum() < len(
        mirrored)
    # the mirrored instance's rays come from below: only the back faces
    # (above the occluder) stop them, over a wider area
    assert mirrored.mean() > first.mean()


@pytest.mark.parametrize("arity,leaf", WIDE)
def test_plain_walks_match_jax_with_empty_groups_between_children(arity,
                                                                  leaf):
    # the grid field's node rows with their children spread over the row
    # (empty groups of four between used ones), as the card's group-at-a-
    # time code reads are held to: the plain walk equals traverse8's and
    # the answers of the table as built
    jb, pb = _tables(_grid_field(), arity, leaf)
    spread = spread_children(pb.table, pb.inst_base, pb.blas_base, arity)
    assert gap_rows(spread, pb.inst_base, pb.blas_base, arity) > 0
    o, d = (np.asarray(a) for a in _rays_grid(1024, seed=5, extent=9.0))
    occ = _occluded_against_jax(jb, pb, spread, o, d, arity, leaf)
    assert np.array_equal(
        occ, _occluded_against_jax(jb, pb, pb.table, o, d, arity, leaf))
    assert 0 < occ.sum() < len(occ)


def test_wrappers_take_wide_two_level_tables(stand_in_kernels):
    """No layout of the compiled ones is refused for a two-level table: on
    CPU tensors the wrappers run the plain versions, and a launch (into a
    stand-in library) counts under the layout's instantiation."""
    stand_in_kernels.structs["fov_traverse"] = traverse.TraverseArgs
    for arity, leaf in WIDE:
        _, pb = _tables(_leaf_field(leaf), arity, leaf)
        o, d = _rays_grid(256, seed=1, extent=12.0)
        args = (torch.tensor(pb.table), torch.tensor(np.asarray(o)),
                torch.tensor(np.asarray(d)),
                torch.ones(256, dtype=torch.bool), TMIN, TMAX,
                pb.stack_depth, arity, leaf)
        kw = {"num_instances": pb.num_instances, "inst_base": pb.inst_base,
              "blas_base": pb.blas_base}
        before = dict(kernel_build.LAUNCHES)
        got = traverse.closest_hit(*args, **kw)
        want = traverse.closest_hit_plain(*args, **kw)
        for f in ("t", "tri_id", "inst", "hit"):
            assert torch.equal(got[f], want[f]), f
        assert torch.equal(traverse.occluded(*args, **kw),
                           traverse.occluded_plain(*args, **kw))
        assert kernel_build.LAUNCHES == before  # CPU tensors: no launch
        traverse._kernel_layout(args[0], 256, arity, leaf)
        for k in traverse.INSTANCED_KERNELS:
            name = traverse.layout_name(k, arity, leaf)
            assert name == f"{k}_a{arity}_l{leaf}"
            saved = kernel_build.LAUNCHES.copy()
            traverse._launch(k, traverse.TraverseArgs(), *args)
            assert kernel_build.LAUNCHES[name] == saved[name] + 1
            assert kernel_build.LAUNCHES[k] == saved[k] + 1
            assert stand_in_kernels.calls[-1][2].which == traverse.WHICH[k]
    with pytest.raises(ValueError, match="layout"):
        traverse._kernel_layout(torch.zeros((4, 64)), 10, 16, 4)


def test_field_rays_at_the_wide_layouts_on_cpu():
    # kernel_times' field mode with --layout: the field's tables at the
    # wide layouts (tlas.build_instanced's), the same rays through each
    sched = FoveationSchedule.reference_32_16_8().scaled(8)
    rays = kernel_times.field_rays("cpu", count=32, width=120, height=68,
                                   schedule=sched, layouts=WIDE)
    calls = kernel_times.field_calls(rays)
    assert list(calls) == [
        "ik1_primary", "ik2_shadow", "ik1_primary_a32_l12",
        "ik2_shadow_a32_l12", "ik1_primary_a32_l24", "ik2_shadow_a32_l24",
        "flat_k1_primary", "flat_k2_shadow"]
    out = {k: f() for k, f in calls.items()}
    for arity, leaf in WIDE:
        b = rays["wide"][(arity, leaf)]
        want = tlas.build_instanced(
            *tlas.scene_tables_from_instanced(rays["field"]),
            leaf_size=leaf, arity=arity)
        assert np.array_equal(_bits(b.table.numpy()), _bits(want.table))
        assert (b.num_instances, b.inst_base, b.blas_base) == (
            32, want.inst_base, want.blas_base)
        assert rays["wide_build_s"][(arity, leaf)] > 0
        mism = kernel_times.field_mismatches(rays, calls, layout=(arity,
                                                                  leaf))
        assert not any(mism.values()), mism
        # one geometry in three tables: the same hits and occlusion
        tag = traverse.layout_name("", arity, leaf)
        for k in ("hit", "t", "tri_id", "inst"):
            assert torch.equal(out["ik1_primary" + tag][k],
                               out["ik1_primary"][k]), k
        assert torch.equal(out["ik2_shadow" + tag], out["ik2_shadow"])
    assert out["ik1_primary"]["hit"].any()


def test_city_field_is_one_big_blas():
    sc, cam = kernel_times.city_field()
    assert sc.num_unique_triangles == 1500 and len(sc.instances) == 8
    assert sc.num_world_triangles == 12_000 and isinstance(cam, Camera)
    unique, ids, mats = tlas.scene_tables_from_instanced(sc)
    b = tlas.build_instanced(unique, ids, mats, leaf_size=24, arity=32)
    # the BLAS fills many leaf rows: more rows than its root and the TLAS
    assert b.num_rows - b.blas_base > 60


@pytest.mark.parametrize("arity,leaf", WIDE)
def test_frame_matches_jax_on_wide_two_level_tables(arity, leaf):
    w, h = 32, 24
    jsc = _grid_scene(3, 3, rot=True)
    jscene = j_build_instanced(jsc, probe=j_sky(width=64, height=32))
    jb, _ = _tables(jtlas.scene_tables_from_instanced(jsc), arity, leaf)
    jscene = dataclasses.replace(jscene, bvh=jb)
    cam = Camera(eye=(1.5, 4.0, 7.0), lookat=(1.5, 0.3, 1.5), fov_y=50.0,
                 aspect=w / h)
    sched = jconfig.FoveationSchedule.uniform(1)
    pad = film.schedule_padding(pconfig.FoveationSchedule.uniform(1), w, h)
    from fovpathtracing_optixcodelatest_tpu.models.camera import (
        Camera as JCamera,
    )

    jcam = JCamera(eye=cam.eye, lookat=cam.lookat, fov_y=cam.fov_y,
                   aspect=cam.aspect).device_params()
    with jax.disable_jit():  # as above: running beats compiling here
        _, jframe, jstats = j_render(
            jscene, jcam, jnp.int32(w // 2), jnp.int32(h // 2), jnp.int32(0),
            jfilm.new_canvas(w, h, pad), jax.random.PRNGKey(0),
            jconfig.RenderConfig(width=w, height=h), sched)
    pscene = scene_from_arrays(jax_scene_arrays(jscene), "cpu")
    assert (pscene.bvh.arity, pscene.bvh.leaf_size) == (arity, leaf)
    assert pscene.bvh.instanced
    _, frame, stats = render_frame(
        pscene, cam.device_params("cpu"), w // 2, h // 2, 0,
        film.new_canvas(w, h, pad, "cpu"), prng_key(0),
        pconfig.RenderConfig(width=w, height=h),
        pconfig.FoveationSchedule.uniform(1))
    a, b = frame.numpy().astype(int), np.asarray(jframe).astype(int)
    assert (np.abs(a - b).max(-1) <= 1).mean() >= 0.99
    assert int(stats["traces"]) == int(jstats["traces"])
    assert 0 < a.mean() < 255
