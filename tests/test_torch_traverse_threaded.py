"""The port's threaded per-ray walk (``ops/traverse_threaded.py``) and packet
walk (``ops/traverse_packet.py``) against the JAX package's
``ops/traverse.py`` and ``ops/traverse_packet.py``, on the same BVH arrays
and rays, and against the port's brute force (``ops/intersect.py``).

Tolerances: hit, tri_id, occlusion and ``steps`` exact; t within
``T_ULP`` ulp and u/v within ``UV_ATOL``, because XLA on the CPU contracts
some Möller-Trumbore products into FMAs while the port rounds every
operation (measured on these scenes and rays: t at most 7 ulp, u/v at most
2.3e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu.models.material import Material
from fovpathtracing_optixcodelatest_tpu.models.mesh import (
    host_triangles,
    make_box,
    make_icosphere,
)
from fovpathtracing_optixcodelatest_tpu.ops import bvh as jbvh
from fovpathtracing_optixcodelatest_tpu.ops import traverse as jtraverse
from fovpathtracing_optixcodelatest_tpu.ops import (
    traverse_packet as jtraverse_packet,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import (
    bvh,
    intersect,
    traverse_packet,
    traverse_threaded,
)

torch.set_num_threads(2)

TMIN, TMAX = 0.01, 1e16
T_ULP = 7
UV_ATOL = 2.5e-6


def _scene(seed=0, boxes=15):
    rng = np.random.default_rng(seed)
    meshes = [make_icosphere((0, 0, 0), 1.0, 2, Material())]
    for _ in range(boxes):
        pos = rng.uniform(-4, 4, 3)
        ext = rng.uniform(0.2, 0.8, 3)
        meshes.append(make_box(tuple(pos), tuple(ext), Material()))
    return host_triangles(meshes)


def _rays(n, seed=1, coherent=False):
    """``tests/test_traverse_packet.py``'s rays: random origins and
    directions, or a narrow cone from (0, 0, 8) looking down -z."""
    rng = np.random.default_rng(seed)
    if coherent:
        o = np.tile([[0.0, 0.0, 8.0]], (n, 1)).astype(np.float32)
        d = rng.normal(size=(n, 3)) * [0.2, 0.2, 1.0]
        d[:, 2] = -np.abs(d[:, 2])
    else:
        o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.fixture(scope="module")
def pair():
    tris = _scene()
    return tris, jbvh.build(tris), bvh.build(tris).to("cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _check_hits(got, want, steps=True):
    h = np.asarray(want["hit"])
    np.testing.assert_array_equal(got["hit"].numpy(), h)
    np.testing.assert_array_equal(got["tri_id"].numpy(),
                                  np.asarray(want["tri_id"]))
    if steps:
        assert got["steps"] == int(want["steps"])
    gt = got["t"].numpy()[h].view(np.int32).astype(np.int64)
    wt = np.asarray(want["t"])[h].view(np.int32)
    assert np.abs(gt - wt).max(initial=0) <= T_ULP
    for c in ("u", "v"):
        np.testing.assert_allclose(got[c].numpy()[h], np.asarray(want[c])[h],
                                   rtol=0, atol=UV_ATOL)


@pytest.mark.parametrize("coherent", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_threaded_walks_equal_jax(pair, coherent, masked):
    _, jb, pb = pair
    o, d = _rays(2048, seed=3, coherent=coherent)
    active = (np.arange(2048) % 3 != 0) if masked else None
    ja = None if active is None else jnp.asarray(active)
    pa = None if active is None else _t(active)
    want = jtraverse.closest_hit(jb, jnp.asarray(o), jnp.asarray(d), TMIN,
                                 TMAX, active=ja)
    got = traverse_threaded.closest_hit(pb, _t(o), _t(d), TMIN, TMAX,
                                        active=pa)
    assert np.asarray(want["hit"]).any()
    _check_hits(got, want)
    if masked:
        assert not got["hit"][~pa].any()
    want_occ = np.asarray(jtraverse.occluded(jb, jnp.asarray(o),
                                             jnp.asarray(d), TMIN, TMAX,
                                             active=ja))
    got_occ = traverse_threaded.occluded(pb, _t(o), _t(d), TMIN, TMAX,
                                         active=pa)
    assert want_occ.any() and not want_occ.all()
    np.testing.assert_array_equal(got_occ.numpy(), want_occ)


def test_threaded_max_steps_cuts_the_walk_as_jax(pair):
    _, jb, pb = pair
    o, d = _rays(2048, seed=5)
    want = jtraverse.closest_hit(jb, jnp.asarray(o), jnp.asarray(d), TMIN,
                                 TMAX, max_steps=9)
    got = traverse_threaded.closest_hit(pb, _t(o), _t(d), TMIN, TMAX,
                                        max_steps=9)
    assert got["steps"] == 9
    _check_hits(got, want)
    want_occ = np.asarray(jtraverse.occluded(jb, jnp.asarray(o),
                                             jnp.asarray(d), TMIN, TMAX,
                                             max_steps=9))
    np.testing.assert_array_equal(
        traverse_threaded.occluded(pb, _t(o), _t(d), TMIN, TMAX,
                                   max_steps=9).numpy(), want_occ)


@pytest.mark.parametrize("packet_size", [32, 64, 128])
@pytest.mark.parametrize("coherent", [False, True])
def test_packet_walks_equal_jax(pair, packet_size, coherent):
    # N not a multiple of the packet: the padding lanes must not show
    _, jb, pb = pair
    o, d = _rays(1000, seed=3, coherent=coherent)
    want = jtraverse_packet.closest_hit(jb, jnp.asarray(o), jnp.asarray(d),
                                        TMIN, TMAX, packet_size=packet_size)
    got = traverse_packet.closest_hit(pb, _t(o), _t(d), TMIN, TMAX,
                                      packet_size=packet_size)
    assert got["t"].shape == (1000,)
    _check_hits(got, want)
    # the packet walk answers as the per-ray walk does
    _check_hits(got, traverse_threaded.closest_hit(pb, _t(o), _t(d), TMIN,
                                                   TMAX), steps=False)
    o, d = o[:777], d[:777]
    want_occ = np.asarray(jtraverse_packet.occluded(
        jb, jnp.asarray(o), jnp.asarray(d), TMIN, TMAX,
        packet_size=packet_size))
    got_occ = traverse_packet.occluded(pb, _t(o), _t(d), TMIN, TMAX,
                                       packet_size=packet_size)
    np.testing.assert_array_equal(got_occ.numpy(), want_occ)
    np.testing.assert_array_equal(
        got_occ.numpy(),
        traverse_threaded.occluded(pb, _t(o), _t(d), TMIN, TMAX).numpy())


def test_packet_active_mask_and_leaf_cap(pair):
    _, jb, pb = pair
    o, d = _rays(300, seed=7, coherent=True)
    active = np.arange(300) % 3 != 0
    want = jtraverse_packet.closest_hit(jb, jnp.asarray(o), jnp.asarray(d),
                                        TMIN, TMAX,
                                        active=jnp.asarray(active),
                                        packet_size=32, leaf_cap=6)
    got = traverse_packet.closest_hit(pb, _t(o), _t(d), TMIN, TMAX,
                                      active=_t(active), packet_size=32,
                                      leaf_cap=6)
    assert not got["hit"][::3].any() and got["hit"].any()
    _check_hits(got, want)
    want_occ = np.asarray(jtraverse_packet.occluded(
        jb, jnp.asarray(o), jnp.asarray(d), TMIN, TMAX,
        active=jnp.asarray(active), packet_size=32))
    got_occ = traverse_packet.occluded(pb, _t(o), _t(d), TMIN, TMAX,
                                       active=_t(active), packet_size=32)
    assert not got_occ[::3].any()
    np.testing.assert_array_equal(got_occ.numpy(), want_occ)


def test_threaded_walk_against_brute_force():
    # tests/test_bvh.py's oracle bars: hit exact, t within rtol 1e-4, the
    # same triangle on > 99% of hits (shared edges tie), occlusion > 99.9%
    tris = _scene(seed=0, boxes=20)
    pb = bvh.build(tris).to("cpu")
    v0 = _t(tris[:, 0])
    e1, e2 = _t(tris[:, 1] - tris[:, 0]), _t(tris[:, 2] - tris[:, 0])
    o, d = _rays(2048, seed=1)
    ref = intersect.brute_force_closest_hit(v0, e1, e2, _t(o), _t(d), TMIN,
                                            TMAX)
    got = traverse_threaded.closest_hit(pb, _t(o), _t(d), TMIN, TMAX)
    h = ref["hit"]
    assert torch.equal(got["hit"], h)
    np.testing.assert_allclose(got["t"][h].numpy(), ref["t"][h].numpy(),
                               rtol=1e-4, atol=1e-5)
    assert (got["tri_id"] == ref["tri_id"])[h].float().mean() > 0.99
    occ_ref = intersect.brute_force_occluded(v0, e1, e2, _t(o), _t(d), TMIN,
                                             TMAX)
    occ = traverse_threaded.occluded(pb, _t(o), _t(d), TMIN, TMAX)
    assert (occ == occ_ref).float().mean() > 0.999


def test_threaded_walk_prunes():
    # tests/test_bvh.py's check: coherent rays step far fewer times than
    # the tree has nodes
    tris = _scene(seed=2, boxes=20)
    pb = bvh.build(tris).to("cpu")
    n = 512
    o = np.tile(np.asarray([[0.0, 0.0, 10.0]], dtype=np.float32), (n, 1))
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n, 3)) * np.asarray([0.05, 0.05, 1.0])
    d[:, 2] = -np.abs(d[:, 2])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    out = traverse_threaded.closest_hit(pb, _t(o), _t(d), TMIN, TMAX)
    assert 0 < out["steps"] < pb.num_nodes


def test_single_triangle():
    tris = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], dtype=np.float32)
    pb = bvh.build(tris).to("cpu")
    out = traverse_threaded.closest_hit(
        pb, torch.tensor([[0.2, 0.2, 5.0]]), torch.tensor([[0.0, 0.0, -1.0]]),
        0.0, 100.0)
    assert bool(out["hit"][0]) and int(out["tri_id"][0]) == 0
    assert abs(float(out["t"][0]) - 5.0) < 1e-5


def test_walks_refuse_a_bvh_on_another_device(pair):
    tris, _, _ = pair
    host = bvh.build(tris)
    o, d = _rays(8)
    for walk in (traverse_threaded.closest_hit, traverse_threaded.occluded,
                 traverse_packet.closest_hit, traverse_packet.occluded):
        with pytest.raises(ValueError, match="bvh.to"):
            walk(host, _t(o), _t(d), TMIN, TMAX)
        with pytest.raises(ValueError, match="meta"):
            walk(host.to("meta"), _t(o), _t(d), TMIN, TMAX)


def test_argmin_takes_the_first_minimum_as_jax():
    # the leaf test's tie order: equal t and all-inf rows
    inf = float("inf")
    t = np.asarray([[2.0, 1.0, 1.0, 3.0], [inf, inf, inf, inf],
                    [0.5, 0.5, 0.5, 0.5], [inf, 4.0, inf, 4.0]], np.float32)
    want = np.asarray(jnp.argmin(jnp.asarray(t), axis=1))
    np.testing.assert_array_equal(want, [1, 0, 0, 1])
    np.testing.assert_array_equal(torch.argmin(_t(t), dim=1).numpy(), want)


# The bench frame's bounce-0 shadow ray 37278 (box_city n=24 seed 0, 960x540
# reference_32_16_8), which grazes a leaf's box, and ray 37120 of its
# 256-ray packet, as float32 bit patterns (the card's rays, phase o of
# chip_smoke.py)
UNION_ORIGIN_BITS = [[-1053905960, -1086682528, 1109393408],
                     [-1045316352, 1081512132, 1109327768]]
UNION_DIRECTION_BITS = [[1059219353, -1085938684, 862860129],
                        [-1147299679, -1082150641, -1119354050]]


def test_packet_walk_is_a_union_walk_as_jax():
    # a packet descends where any of its rays hits a box and tests each
    # ray at every leaf it reaches: the grazing ray, whose own slab test
    # rejects a leaf by rounding, is found occluded (as brute force finds
    # it) when the other ray leads the packet there, and not alone; the
    # per-ray walk never reaches that leaf. Both packages alike.
    from fovpathtracing_optixcodelatest_tpu.models import scenes as jscenes

    tris = host_triangles(jscenes.box_city(n=24, seed=0)[0])
    jb, pb = jbvh.build(tris), bvh.build(tris).to("cpu")
    o = np.array(UNION_ORIGIN_BITS, np.int32).view(np.float32)
    d = np.array(UNION_DIRECTION_BITS, np.int32).view(np.float32)

    def both(walk_j, walk_p, k, **kw):
        j = np.asarray(walk_j(jb, jnp.asarray(o[:k]), jnp.asarray(d[:k]),
                              TMIN, TMAX, **kw))
        p = walk_p(pb, _t(o[:k]), _t(d[:k]), TMIN, TMAX, **kw).numpy()
        np.testing.assert_array_equal(p, j)
        return p.tolist()

    assert both(jtraverse_packet.occluded, traverse_packet.occluded, 2,
                packet_size=2) == [True, True]
    assert both(jtraverse_packet.occluded, traverse_packet.occluded, 1,
                packet_size=2) == [False]
    assert both(jtraverse.occluded, traverse_threaded.occluded,
                2) == [False, True]
    v0 = _t(tris[:, 0])
    e1, e2 = _t(tris[:, 1] - tris[:, 0]), _t(tris[:, 2] - tris[:, 0])
    assert intersect.brute_force_occluded(v0, e1, e2, _t(o), _t(d), TMIN,
                                          TMAX).tolist() == [True, True]
