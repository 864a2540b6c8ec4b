"""The port's CUDA kernels (K1, K2, K3) against their plain PyTorch versions.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels have no CPU
mode) and skip without one. They import nothing of JAX, so they run on a
machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Tolerance: every output exact (hit, tri_id, occlusion, and t/u/v bit for
bit), since the kernels are built with --fmad=false and repeat the plain
versions' operations in the same order. K1, K2 and K3 fetch their lanes
from a counter in chunks of 32 and skip inactive lanes, so they are also
held to the plain versions at sparse active masks, at lane counts around a
chunk's edge, and at stacks small enough to overflow (the plain versions
pin the overflow rule); a layout other than (16, 6) for K1/K2, or than 64
columns and leaf size 4 for K3, must raise. K3 walks packets of 32 rays
whose makeup depends on scheduling, so two launches on the same rays must
also agree, and its answer must equal K2's on the same rays.

The instanced K1 and K2 (two-level tables, ``ops/tlas.py``) are held to
their plain versions the same way, ``inst`` included: on a rotated grid of
box and ball instances with a mirrored one, at sparse masks, ragged lane
counts, the stack depth the TLAS+BLAS bound gives (without its safety
entry: no ray may overflow it) and a small one that overflows; a mirrored
one-sided quad shows occlusion culling by the object-space winding. They
test an instance's BLAS root in the instance entry's own step, so they are
also held to the plain versions on a table whose instances enter their
BLAS at a leaf row (``leaf_root``), where they must answer as on the same
table entered at its root node.

The kernels' resources as the CUDA runtime reports them: no kernel keeps
local memory (no spill), and the single-level K1, K2 and non-culling K2
keep their registers and resident blocks.

K2's non-culling instantiation (``occluded(..., cull_backface=False)``, the
04 raycast's shadow ray) is held to its plain version at the same sparse
masks, ragged lane counts and small stacks; it must find the back faces
the culling K2 skips, and refuse two-level tables and other layouts.

The two-rank frames of ``parallel/`` on the card (mesh [cuda:0, cuda:0]:
the sample slicing and the cross-rank assembly really run), sample-split
and with ``tri_pack`` cut in two row blocks, equal the single-device
frame and canvas bit for bit over two subframes, and launch K1 and K2.
"""

import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
from fovpathtracing_optixcodelatest_tpu_torch.models.instance import instanced
from fovpathtracing_optixcodelatest_tpu_torch.models.material import Material
from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
    make_box,
    make_icosphere,
    make_quad,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
    build_scene,
    build_scene_instanced,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import (
    kernel_build,
    packet_traverse,
    tlas,
    traverse,
)
from torch_blas_fields import _rot_y, _translate, leaf_root, small_blas_field

TMIN, TMAX = 0.01, 1e16


def _launched(**counts):
    """The launch counters with ``counts`` and every other kernel at 0."""
    return {k: counts.get(k, 0) for k in kernel_build.LAUNCHES}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rays(n, seed, dev):
    rng = np.random.default_rng(seed)
    o = rng.uniform((-35.0, 0.0, -35.0), (35.0, 20.0, 35.0), (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = rng.random(n) < 0.9
    return (torch.tensor(o, dtype=torch.float32, device=dev),
            torch.tensor(d, dtype=torch.float32, device=dev),
            torch.tensor(active, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n,seed", [(3000, 0), (70_001, 1)])
def test_kernels_match_plain_versions(cuda_device, n, seed):
    scene = build_scene(scenes.box_city(n=4, seed=0)[0], device=cuda_device,
                        legacy8=True)
    b, leg = scene.bvh, scene.legacy
    o, d, act = _rays(n, seed, cuda_device)
    args = (b.table, o, d, act, TMIN, TMAX, b.stack_depth, b.arity,
            b.leaf_size)
    kernel_build.reset_launches()
    k = traverse.closest_hit(*args)
    p = traverse.closest_hit_plain(*args)
    for c in ("t", "u", "v", "tri_id", "hit"):
        assert torch.equal(k[c], p[c]), c
    assert 0.2 < k["hit"].float().mean() < 1.0
    occ = traverse.occluded(*args)
    assert torch.equal(occ, traverse.occluded_plain(*args))
    largs = (leg.table, o, d, act, TMIN, TMAX, leg.stack_depth,
             leg.leaf_size)
    assert torch.equal(packet_traverse.occluded_packets(*largs),
                       packet_traverse.occluded_packets_plain(*largs))
    assert torch.equal(packet_traverse.occluded_packets(*largs), occ)
    torch.cuda.synchronize()
    assert kernel_build.LAUNCHES == _launched(closest_hit=1, occluded=1,
                                              occluded_packets=2)


# ---------------------------------------------------------------------------
# K1/K2 (persistent warps fetching their lanes from a counter) at the edges
# of that fetch: sparse masks, ragged lane counts, small stacks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def city():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return build_scene(scenes.box_city(n=4, seed=0)[0], device="cuda",
                       legacy8=True)


def _k1_k2_against_plain(scene, o, d, act, depth):
    """Launch K1 and K2 once each and hold them to the plain versions;
    returns (K1 answer, K2 answer)."""
    b = scene.bvh
    args = (b.table, o, d, act, TMIN, TMAX, depth, b.arity, b.leaf_size)
    kernel_build.reset_launches()
    k = traverse.closest_hit(*args)
    occ = traverse.occluded(*args)
    torch.cuda.synchronize()
    launched = int(o.shape[0] > 0)
    assert kernel_build.LAUNCHES == _launched(closest_hit=launched,
                                              occluded=launched)
    p = traverse.closest_hit_plain(*args)
    for c in ("t", "u", "v", "tri_id", "hit"):
        assert torch.equal(k[c], p[c]), c
    assert torch.equal(occ, traverse.occluded_plain(*args))
    assert not occ[~act].any() and not k["hit"][~act].any()
    return k, occ


@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.0, 0.01, 0.35, 1.0])
def test_kernels_match_plain_at_active_share(city, share):
    n = 70_001
    o, d, _ = _rays(n, 7, city.device)
    rng = np.random.default_rng(11)
    act = torch.tensor(rng.random(n) < share, device=city.device)
    k, occ = _k1_k2_against_plain(city, o, d, act, city.bvh.stack_depth)
    if share > 0:
        assert k["hit"].any() and occ.any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 31, 33, 70_001])
def test_kernels_match_plain_at_ragged_n(city, n):
    o, d, act = _rays(n, 3, city.device)
    k, occ = _k1_k2_against_plain(city, o, d, act, city.bvh.stack_depth)
    assert k["t"].shape == occ.shape == (n,)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2, 3])
def test_kernels_keep_the_overflow_rule(city, depth):
    o, d, act = _rays(20_000, 5, city.device)
    k, occ = _k1_k2_against_plain(city, o, d, act, depth)
    b = city.bvh
    full = (b.table, o, d, act, TMIN, TMAX, b.stack_depth, b.arity,
            b.leaf_size)
    # the small stack overflowed and changed some answers
    assert not torch.equal(k["tri_id"], traverse.closest_hit(*full)["tri_id"])
    assert not torch.equal(occ, traverse.occluded(*full))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(8, 4), (16, 4), (4, 6)])
def test_kernels_refuse_other_layouts(city, layout):
    o, d, act = _rays(64, 0, city.device)
    b = city.bvh
    for fn in (traverse.closest_hit, traverse.occluded):
        with pytest.raises(ValueError, match="layout"):
            fn(b.table, o, d, act, TMIN, TMAX, b.stack_depth, *layout)
    shifted = torch.empty(b.table.numel() + 1, dtype=torch.float32,
                          device=city.device)[1:].view(b.table.shape)
    shifted.copy_(b.table)
    with pytest.raises(ValueError, match="aligned"):
        traverse.occluded(shifted, o, d, act, TMIN, TMAX, b.stack_depth,
                          b.arity, b.leaf_size)


# ---------------------------------------------------------------------------
# K3 (masked warp-packet walk of the legacy table) at the same edges, and
# what depends on its packets: the shared stack, determinism, K2's answer
# ---------------------------------------------------------------------------


def _k3_against_plain(scene, o, d, act, depth):
    """Launch K3 once and hold it to its plain version; returns its answer
    and the counts of its own walk."""
    leg = scene.legacy
    args = (leg.table, o, d, act, TMIN, TMAX, depth, leg.leaf_size)
    kernel_build.reset_launches()
    fetched = {}
    occ = packet_traverse.occluded_packets(*args, fetched=fetched)
    torch.cuda.synchronize()
    launched = int(o.shape[0] > 0)
    assert kernel_build.LAUNCHES["occluded_packets"] == launched
    assert torch.equal(occ, packet_traverse.occluded_packets_plain(*args))
    assert not occ[~act].any()
    # one packet per 32 queried rays at least, one row per packet step
    queried = int(act.sum())
    if launched:
        assert fetched["packets"] >= -(-queried // 32)
        assert fetched["node_rows"] >= fetched["packets"]
    return occ, fetched


@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.0, 0.01, 0.35, 1.0])
def test_k3_matches_plain_and_k2_at_active_share(city, share):
    n = 70_001
    o, d, _ = _rays(n, 7, city.device)
    rng = np.random.default_rng(11)
    act = torch.tensor(rng.random(n) < share, device=city.device)
    occ, fetched = _k3_against_plain(city, o, d, act,
                                     city.legacy.stack_depth)
    b = city.bvh
    assert torch.equal(occ, traverse.occluded(
        b.table, o, d, act, TMIN, TMAX, b.stack_depth, b.arity, b.leaf_size))
    if share > 0:
        assert occ.any()
    else:
        assert fetched["packets"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 31, 33, 70_001])
def test_k3_matches_plain_and_k2_at_ragged_n(city, n):
    o, d, act = _rays(n, 3, city.device)
    occ, _ = _k3_against_plain(city, o, d, act, city.legacy.stack_depth)
    assert occ.shape == (n,)
    b = city.bvh
    assert torch.equal(occ, traverse.occluded(
        b.table, o, d, act, TMIN, TMAX, b.stack_depth, b.arity, b.leaf_size))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2, 3])
def test_k3_keeps_the_overflow_rule(city, depth):
    # each lane drops its own pushes once its entries fill stack_depth, as
    # the per-ray walk does; the shared stack (32 x depth) cannot fill
    o, d, act = _rays(20_000, 5, city.device)
    occ, _ = _k3_against_plain(city, o, d, act, depth)
    full, _ = _k3_against_plain(city, o, d, act, city.legacy.stack_depth)
    assert not torch.equal(occ, full)  # the small stack changed answers


def _tall_table(levels=24):
    """A legacy table whose packet stacks grow by 7 entries a level: node i
    holds 7 leaves (slot c covers x in [c, c + 1]) and node i + 1 in slot 7
    (x in [0, 7]). Rays along +z at x in slot c's strip push one leaf a
    level each, a packet of all 7 strips 7: past level 18 its stack leaves
    shared memory (128 entries) for the global buffer. Two leaves hold a
    triangle: slot 3 under the root, and slot 5 at level 20, which only a
    ray with 21 or more stack entries reaches."""
    rows = 8 * levels
    t = np.zeros((rows, 64), np.float32)
    meta = np.zeros((rows, 16), np.int32)
    for i in range(levels):
        for c in range(7):
            t[i, 6 * c: 6 * c + 6] = (c, -1, -1, c + 1, 1, 1)
            meta[i, 2 * c: 2 * c + 2] = (levels + 7 * i + c, 1)
        t[i, 42:48] = (0, -1, -1, 7, 1, 1)
        meta[i, 14:16] = (i + 1, 0) if i + 1 < levels else (0, -1)
    t[:, 48:] = meta.view(np.float32)
    tri = np.array([3, -1, 0, 0, 2, 0, 1, 0, 0], np.float32)  # v0, e1, e2
    t[levels + 3, :9] = tri
    tri[0] = 5
    t[levels + 7 * 20 + 5, :9] = tri
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [10, 64])
def test_k3_stack_spills_past_shared_memory_exactly(cuda_device, depth):
    n = 7 * 64
    rng = np.random.default_rng(2)
    strip = np.arange(n) % 7  # every packet holds rays of all 7 strips
    o = np.stack([strip + rng.uniform(0.1, 0.9, n),
                  rng.uniform(-0.5, 0.5, n), np.full(n, -10.0)], 1)
    d = np.tile([0.0, 0.0, 1.0], (n, 1))
    table = torch.tensor(_tall_table(), device=cuda_device)
    args = (table, torch.tensor(o, dtype=torch.float32, device=cuda_device),
            torch.tensor(d, dtype=torch.float32, device=cuda_device),
            torch.ones(n, dtype=torch.bool, device=cuda_device), TMIN, TMAX,
            depth, 4)
    occ = packet_traverse.occluded_packets(*args)
    assert torch.equal(occ, packet_traverse.occluded_packets_plain(*args))
    hit = occ.cpu().numpy()
    assert hit[strip == 3].any() and not hit[(strip != 3) & (strip != 5)].any()
    # slot 5's triangle at level 20 is reached only with room for 21 entries
    assert hit[strip == 5].any() == (depth > 20)


@pytest.mark.cuda
def test_k3_answers_alike_in_two_launches(city):
    o, d, act = _rays(200_000, 13, city.device)
    leg = city.legacy
    args = (leg.table, o, d, act, TMIN, TMAX, leg.stack_depth, leg.leaf_size)
    first = packet_traverse.occluded_packets(*args)
    second = packet_traverse.occluded_packets(*args)
    assert torch.equal(first, second)
    assert 0 < int(first.sum()) < int(act.sum())


@pytest.mark.cuda
def test_k3_refuses_other_layouts(city):
    o, d, act = _rays(64, 0, city.device)
    leg = city.legacy
    for leaf_size in (2, 6):
        with pytest.raises(ValueError, match="layout"):
            packet_traverse.occluded_packets(leg.table, o, d, act, TMIN, TMAX,
                                             leg.stack_depth, leaf_size)
    wide = torch.zeros((leg.table.shape[0], 72), device=city.device)
    wide[:, :64] = leg.table
    with pytest.raises(ValueError, match="columns"):
        packet_traverse.occluded_packets(wide, o, d, act, TMIN, TMAX,
                                         leg.stack_depth, leg.leaf_size)
    shifted = torch.empty(leg.table.numel() + 1, dtype=torch.float32,
                          device=city.device)[1:].view(leg.table.shape)
    shifted.copy_(leg.table)
    with pytest.raises(ValueError, match="aligned"):
        packet_traverse.occluded_packets(shifted, o, d, act, TMIN, TMAX,
                                         leg.stack_depth, leg.leaf_size)


# ---------------------------------------------------------------------------
# the instanced K1/K2 (two-level tables)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def grid():
    """The JAX package's rotated grid of boxes and balls (5 x 5, every third
    instance turned 35 degrees), with a mirrored box beside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    box = make_box((-0.4, 0.0, -0.4), (0.4, 0.8, 0.4),
                   Material(color=(0.8, 0.6, 0.4), roughness=0.8))
    ball = make_icosphere((0.0, 1.1, 0.0), 0.25, 1,
                          Material(color=(0.3, 0.5, 0.9), roughness=0.4))
    placements = []
    for k in range(25):
        m = _translate((k // 5) * 1.5, 0.0, (k % 5) * 1.5)
        if k % 3 == 1:
            m = m @ _rot_y(35.0)
        placements.append((k % 2, m))
    placements.append((0, _translate(3.0, 0.0, 8.0) @ np.diag([-1, 1, 1, 1])))
    return build_scene_instanced(instanced([box, ball], placements),
                                 device="cuda")


def _grid_rays(n, seed, dev, extent=9.0):
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-1.0, extent, n), np.full(n, 5.0),
                  rng.uniform(-1.0, extent, n)], 1)
    d = rng.normal(size=(n, 3))
    d[:, 1] = -np.abs(d[:, 1]) - 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32, device=dev),
            torch.tensor(d, dtype=torch.float32, device=dev))


def _instanced_against_plain(scene, o, d, act, depth):
    """Launch the instanced K1 and K2 once each and hold them to the plain
    versions; returns (K1 answer, K2 answer)."""
    b = scene.bvh
    return _instanced_table_against_plain(b.table, b.instance_kwargs, o, d,
                                          act, depth)


def _instanced_table_against_plain(table, kw, o, d, act, depth):
    """``_instanced_against_plain`` on ``table``, a (16, 6) two-level table
    whose instance rows ``kw`` places (``instance_kwargs``)."""
    args = (table, o, d, act, TMIN, TMAX, depth, 16, 6)
    kernel_build.reset_launches()
    k = traverse.closest_hit(*args, **kw)
    occ = traverse.occluded(*args, **kw)
    torch.cuda.synchronize()
    launched = int(o.shape[0] > 0)
    assert kernel_build.LAUNCHES == _launched(
        closest_hit_instanced=launched, occluded_instanced=launched)
    p = traverse.closest_hit_plain(*args, **kw)
    for c in ("t", "u", "v", "tri_id", "hit", "inst"):
        assert torch.equal(k[c], p[c]), c
    assert torch.equal(occ, traverse.occluded_plain(*args, **kw))
    assert not occ[~act].any() and not k["hit"][~act].any()
    assert bool(((k["inst"] >= 0) == k["hit"]).all())
    return k, occ


@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.01, 0.35, 1.0])
def test_instanced_kernels_match_plain_at_active_share(grid, share):
    n = 8192
    o, d = _grid_rays(n, 3, grid.device)
    rng = np.random.default_rng(5)
    act = torch.tensor(rng.random(n) < share, device=grid.device)
    k, occ = _instanced_against_plain(grid, o, d, act, grid.bvh.stack_depth)
    assert k["hit"].any() and occ.any()
    # every instance of the grid is hit somewhere when every lane walks
    if share == 1.0:
        assert len(torch.unique(k["inst"][k["hit"]])) == 26


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 70_001])
def test_instanced_kernels_match_plain_at_ragged_n(grid, n):
    o, d = _grid_rays(n, 7, grid.device)
    act = torch.ones(n, dtype=torch.bool, device=grid.device)
    k, occ = _instanced_against_plain(grid, o, d, act, grid.bvh.stack_depth)
    assert k["t"].shape == occ.shape == (n,)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", ["bound", 3])
def test_instanced_kernels_at_the_stack_bound(grid, depth):
    o, d = _grid_rays(20_000, 9, grid.device)
    act = torch.ones(o.shape[0], dtype=torch.bool, device=grid.device)
    b = grid.bvh
    full = _instanced_against_plain(grid, o, d, act, b.stack_depth)
    if depth == "bound":
        # the exact TLAS+BLAS bound, without the safety entry, overflows for
        # no ray: the answers equal the full stack's
        k, occ = _instanced_against_plain(grid, o, d, act,
                                          b.stack_depth - 1)
        for c in ("t", "tri_id", "inst"):
            assert torch.equal(k[c], full[0][c]), c
        assert torch.equal(occ, full[1])
    else:
        k, _ = _instanced_against_plain(grid, o, d, act, depth)
        assert not torch.equal(k["tri_id"], full[0]["tri_id"])


@pytest.mark.cuda
def test_instanced_occlusion_culls_by_object_space_winding(cuda_device):
    # one one-sided quad, placed as is and mirrored in y: in object space
    # the mirrored copy is seen from its other side, so exactly one of the
    # two occludes rays from above (the reference's documented caveat)
    quad = make_quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1),
                     Material(color=(1, 1, 1), roughness=1.0))
    mirror = _translate(5.0, 0.0, 0.0) @ np.diag([1.0, -1.0, 1.0, 1.0])
    scene = build_scene_instanced(
        instanced([quad], [(0, np.eye(4)), (0, mirror)]), device=cuda_device)
    n = 256
    rng = np.random.default_rng(1)
    x = np.where(np.arange(n) < n // 2, 0.0, 5.0) + rng.uniform(-0.5, 0.5, n)
    o = torch.tensor(np.stack([x, np.full(n, 3.0), rng.uniform(-0.5, 0.5, n)],
                              1), dtype=torch.float32, device=cuda_device)
    d = torch.tensor(np.tile([0.0, -1.0, 0.0], (n, 1)), dtype=torch.float32,
                     device=cuda_device)
    act = torch.ones(n, dtype=torch.bool, device=cuda_device)
    k, occ = _instanced_against_plain(scene, o, d, act,
                                      scene.bvh.stack_depth)
    assert bool(k["hit"].all())
    first, second = occ[: n // 2], occ[n // 2:]
    assert bool((first != second[0]).all()) and bool((second == second[0]).all())
    assert bool((first == first[0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(8, 4), (16, 4)])
def test_instanced_kernels_refuse_other_layouts(grid, layout):
    o, d = _grid_rays(64, 0, grid.device)
    act = torch.ones(64, dtype=torch.bool, device=grid.device)
    b = grid.bvh
    for fn in (traverse.closest_hit, traverse.occluded):
        with pytest.raises(ValueError, match="layout"):
            fn(b.table, o, d, act, TMIN, TMAX, b.stack_depth, *layout,
               **b.instance_kwargs)


# instances whose BLAS root is a leaf row (tests/torch_blas_fields.py)


@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.35, 1.0])
def test_instanced_kernels_on_a_leaf_root_blas(cuda_device, share):
    b = tlas.build_instanced(*small_blas_field())
    kw = {"num_instances": b.num_instances, "inst_base": b.inst_base,
          "blas_base": b.blas_base}
    node = torch.tensor(b.table, device=cuda_device)
    leaf = torch.tensor(leaf_root(b.table, b.inst_base, b.blas_base,
                                  b.arity), device=cuda_device)
    assert not torch.equal(node, leaf)
    n = 8192
    o, d = _grid_rays(n, 11, cuda_device, extent=7.0)
    rng = np.random.default_rng(12)
    act = torch.tensor(rng.random(n) < share, device=cuda_device)
    k, occ = _instanced_table_against_plain(leaf, kw, o, d, act,
                                            b.stack_depth)
    # the same geometry entered one row lower: the same answers
    k_node, occ_node = _instanced_table_against_plain(node, kw, o, d, act,
                                                      b.stack_depth)
    for c in ("t", "u", "v", "tri_id", "inst"):
        assert torch.equal(k[c], k_node[c]), c
    assert torch.equal(occ, occ_node)
    # both meshes and the mirrored instance are hit
    hit_tris = torch.unique(k["tri_id"][k["hit"]]).cpu().numpy()
    assert hit_tris.min() < 6 <= hit_tris.max()
    assert int(k["inst"].max()) == len(small_blas_field()[1]) - 1
    assert occ.any()


@pytest.mark.cuda
def test_kernel_resources(cuda_device):
    # at the bench scene's stack depth (50): no kernel keeps local memory,
    # and the single-level kernels' registers and blocks per SM stay
    res = kernel_build.resources(50)
    assert all(r["local_bytes"] == 0 for r in res.values()), res
    single = ("closest_hit", "occluded", "occluded_nocull")
    assert [res[k]["registers"] for k in single] == [69, 96, 96]
    assert [res[k]["blocks_per_sm"] for k in single] == [7, 5, 5]
    assert res["occluded_instanced"]["local_bytes"] == 0


# ---------------------------------------------------------------------------
# K2 without back-face culling (the 04 raycast's shadow rays)
# ---------------------------------------------------------------------------


def _nocull_against_plain(scene, o, d, act, depth):
    """Launch the non-culling K2 once and hold it to its plain version;
    returns its answer."""
    b = scene.bvh
    args = (b.table, o, d, act, TMIN, TMAX, depth, b.arity, b.leaf_size)
    kernel_build.reset_launches()
    occ = traverse.occluded(*args, cull_backface=False)
    torch.cuda.synchronize()
    assert kernel_build.LAUNCHES == _launched(
        occluded_nocull=int(o.shape[0] > 0))
    assert torch.equal(occ, traverse.occluded_plain(*args,
                                                    cull_backface=False))
    assert not occ[~act].any()
    return occ


@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.0, 0.01, 0.35, 1.0])
def test_nocull_k2_matches_plain_at_active_share(city, share):
    n = 70_001
    o, d, _ = _rays(n, 7, city.device)
    rng = np.random.default_rng(11)
    act = torch.tensor(rng.random(n) < share, device=city.device)
    occ = _nocull_against_plain(city, o, d, act, city.bvh.stack_depth)
    b = city.bvh
    culled = traverse.occluded(b.table, o, d, act, TMIN, TMAX,
                               *b.walk_args)
    # a culled answer is also an answer without culling; back faces add more
    assert not (culled & ~occ).any()
    if share >= 0.35:
        assert (occ & ~culled).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 31, 33, 70_001])
def test_nocull_k2_matches_plain_at_ragged_n(city, n):
    o, d, act = _rays(n, 3, city.device)
    assert _nocull_against_plain(city, o, d, act,
                                 city.bvh.stack_depth).shape == (n,)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2, 3])
def test_nocull_k2_keeps_the_overflow_rule(city, depth):
    o, d, act = _rays(20_000, 5, city.device)
    occ = _nocull_against_plain(city, o, d, act, depth)
    full = _nocull_against_plain(city, o, d, act, city.bvh.stack_depth)
    assert not torch.equal(occ, full)  # the small stack changed answers


@pytest.mark.cuda
def test_nocull_k2_refuses_two_level_tables_and_other_layouts(city, grid):
    o, d, act = _rays(64, 0, city.device)
    b = city.bvh
    with pytest.raises(ValueError, match="layout"):
        traverse.occluded(b.table, o, d, act, TMIN, TMAX, b.stack_depth,
                          8, 4, cull_backface=False)
    gb = grid.bvh
    with pytest.raises(ValueError, match="single-level"):
        traverse.occluded(gb.table, o, d, act, TMIN, TMAX, *gb.walk_args,
                          cull_backface=False, **gb.instance_kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["samples", "scene"])
def test_two_rank_frame_equals_the_single_device_frame(city, split):
    import dataclasses

    from fovpathtracing_optixcodelatest_tpu_torch.config import (
        FoveationPass,
        FoveationSchedule,
        RenderConfig,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import (
        fold_in,
        prng_key,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.parallel import (
        scene_shard,
        tiles,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render import film
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        render_frame,
    )

    w, h = 64, 48
    sched = FoveationSchedule(passes=(
        FoveationPass(factor=4, spp=3, r_inner=8.0, r_outer=1e9,
                      redraw=False),
        FoveationPass(factor=1, spp=5, r_inner=0.0, r_outer=9.0, redraw=True,
                      launch_w=18, launch_h=18, centered=True,
                      center_offset=9),
    ))
    cfg = RenderConfig(width=w, height=h)
    cam = dataclasses.replace(scenes.box_city(n=4, seed=0)[1], aspect=w / h)
    camp = cam.device_params("cuda")
    mesh = tiles.make_mesh(["cuda:0", "cuda:0"])
    scene = city
    if split == "scene":
        scene = scene_shard.pad_scene_rows(city, 2)
        ranks = scene_shard.shard_scene(scene, mesh)
        assert ranks[0].tri_pack.shape[0] * 2 == scene.tri_pack.shape[0]
    else:
        ranks = tiles.replicate(scene, mesh)
    canvas = film.new_canvas(w, h, film.schedule_padding(sched, w, h),
                             "cuda")
    c1, c2 = canvas.clone(), canvas.clone()
    for i in range(2):
        key = fold_in(prng_key(5), i)
        c1, f1, s1 = render_frame(city, camp, 30, 20, i, c1, key, cfg, sched)
        kernel_build.reset_launches()
        c2, f2, t2 = tiles.render_frame_sharded(
            scene, camp, 30, 20, i, c2, key, cfg, sched, mesh,
            rank_scenes=ranks)
        torch.cuda.synchronize()
        assert kernel_build.LAUNCHES["closest_hit"] > 0
        assert kernel_build.LAUNCHES["occluded"] > 0
        assert torch.equal(f1, f2) and torch.equal(c1, c2)
        assert int(s1["traces"]) == int(t2)
