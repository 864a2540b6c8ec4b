"""The port's CUDA kernels (K1, K2, K3) against their plain PyTorch versions,
and the launches a frame's bounce makes (the shading kernels of
``csrc/shade.cu`` are held to their plain version in
``test_torch_shade_cuda.py``).

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
table entered at its root node. At the wide layouts (32, 12) and (32, 24)
(``tlas.build_instanced(leaf_size=, arity=)``) they are held to the plain
versions on 8 instances of a 1,500-triangle city BLAS and a pyramid, at
ragged lane counts, at the deepest stack (``MAX_STACK``) and entered at a
leaf root of 12 or 24 triangles; on a line of 32 instances whose TLAS root
row's 32 children every ray hits, with the full stack and with 1-33
entries (the full-stack rule: the largest keys kept; at 32 the nearest
instance's entry in the last slot); and on 4 instances of a
``box_city_fast(6)`` BLAS on a frame's lanes (``kernel_times.deep_field``);
(8, 4) and (16, 4) raise. Their K2 steps in lockstep, reads a node's
codes a group of four at a time and leaves a leaf at the first third of
its triangles that occludes, so it is also held to its plain version on
one BLAS leaf whose occluder sits at slots 0, 2, 3, 11 (and 23 at L24)
behind back faces and before farther triangles, under an instance as is
and a mirrored one, and on the field with its node rows' children spread
over the row, empty groups of four between used ones (both answering as
the tables as built).

K1, K2 and the non-culling K2 on the JAX package's deep-scene row orders
(``bvh8.build(dfs=True)`` and ``treelet_budget > 0``, with group rows)
equal their plain versions exactly and answer as on the plain table of
the same tree (hit and t equal).

The kernels' resources as the CUDA runtime reports them: no kernel keeps
local memory (no spill) but the (32, 24) and the wide two-level ones,
which keep their ``MAX_STACK``-entry stack there; the (16, 6), two-level
and K3 kernels keep their registers and resident blocks; the wide
two-level ones and the (32, 24) K2s spill nothing besides, the (32, 24) K1
14 bytes; the (32, 12) group-per-ray walks
report their lanes a ray, stack home, registers, blocks/SM and shared
memory.

K2's non-culling instantiation (``occluded(..., cull_backface=False)``, the
04 raycast's shadow ray) is held to its plain version at the same sparse
masks, ragged lane counts and small stacks; it must find the back faces
the culling K2 skips, and refuse other layouts. On a two-level table the
same call launches the two-level K2's non-culling instantiation
(``occluded_nocull_instanced``, the 04 raycast of an instanced scene),
held to its plain version at every compiled layout on a grid with a
mirrored box and a quad mirrored in y (negative determinants), at active
shares of 0 and 100% and 0, 1 and 33 lanes; it sees both sides of the
mirrored quad, where the culling kernel sees one.

K1, K2 and the non-culling K2 at the wide layouts (32, 12) and (32, 24)
(``build_scene(leaf_size=, arity=)``) are held to their plain versions the
same way, at sparse masks, ragged lane counts (also counts that leave a
warp's last groups of lanes without a ray: (32, 12) walks a ray with a
group of lanes), overflowing stacks and the deepest stack the wrappers
take (``MAX_STACK``: K1's global stack buffer, K2's shared stack), each
launch counted under its layout too; with the full stack they answer as
the (16, 6) table of the same triangles (hit and t equal). A leaf holding
each triangle twice pins K1's tie rule: the lower slot, as the plain
version's serial loop keeps it, where a group's lanes hit both copies.
Layouts that are not compiled, and rows of another compiled layout's
width, raise. The (32, 24) kernels step in lockstep and K1 inserts each
hit key by rank, so they are also held to their plain versions on the
city's table with every leaf cut to each fill from 1 to 24 triangles
(padding as the packers write it), on one leaf whose real degenerate
triangle at the origin (nine zero words) sits at the first slot of a
third before every triangle the rays hit, and on a root row whose 32
leaves every ray hits, with 1-33 stack entries (the full-stack rule: K1
keeps the farthest leaves' keys).

The two-rank frames of ``parallel/`` on the card (mesh [cuda:0, cuda:0]:
the sample slicing and the cross-rank assembly really run), sample-split
and with ``tri_pack`` cut in two row blocks, equal the single-device
frame and canvas bit for bit over two subframes, and launch K1 and K2.

K1, K2 and K3 on the tables of the pure-Python builder (``bvh8.build``,
``bvh8.build_legacy8``: the JAX package's trees) equal their plain
versions exactly and answer as on the native tree (hit and occlusion
equal, the triangle on 99.9% of the hits). The legacy oracles on the card
(the threaded BVH's per-ray and packet walks) equal their CPU runs (hit,
tri_id, occlusion and steps exact, t within 1e-6 relative) and K1/K2's
hit and occlusion; ``torch.argmin`` takes the first of equal minima there
too, and ``probe_sample_cdf`` on the card picks the CPU's texels
(directions within 1e-6, pdfs within 1e-6 relative).
"""

import collections

import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu_torch.config import (
    FoveationSchedule,
    RenderConfig,
)
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
    bvh_native,
    kernel_build,
    packet_traverse,
    tlas,
    traverse,
)
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import Renderer
from fovpathtracing_optixcodelatest_tpu_torch.tools import kernel_times
from fovpathtracing_optixcodelatest_tpu_torch.utils import tracing
from torch_blas_fields import (
    _rot_y,
    _translate,
    gap_rows,
    leaf_root,
    leaf_slots,
    occluder_field,
    occluder_order,
    occluder_rays,
    place_leaf_slots,
    pyramid_tris,
    small_blas_field,
    spread_children,
    twin_tris,
)

TMIN, TMAX = 0.01, 1e16


def _launched(**counts):
    """The launch counters with ``counts`` and every other kernel at 0 (a
    Counter compares equal where the only difference is zero counts)."""
    return collections.Counter(counts)


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


@pytest.mark.cuda
def test_a_frame_shades_each_bounce_in_two_launches(city):
    """On the card each bounce of a frame launches K1, the shading kernels
    ``shade`` and ``resolve`` (``csrc/shade.cu``) and K2 once each, and
    counts under ``shade`` / ``"kernel"`` (no catcher, so no re-trace); the
    frame's ray generation and film are one launch each
    (``csrc/frame.cu``), and its lane lists one compaction a bounce
    (``csrc/lanes.cu``: ray generation's mask, then every bounce but the
    last)."""
    config = RenderConfig(width=96, height=54, max_depth=4)
    r = Renderer(city, config, FoveationSchedule.uniform(2), seed=0,
                 device="cuda")
    r.set_camera(scenes.box_city(n=4, seed=0)[1])
    kernel_build.reset_launches()
    before = tracing.snapshot()
    r.render()
    torch.cuda.synchronize()
    got = tracing.diff(before, tracing.snapshot())
    assert got["shade"] == {"kernel": config.max_depth}
    b = config.max_depth
    assert kernel_build.LAUNCHES == _launched(closest_hit=b, occluded=b,
                                              shade=b, resolve=b, raygen=1,
                                              film=1, compact=b)


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


def _instanced_table_against_plain(table, kw, o, d, act, depth,
                                   layout=(16, 6)):
    """``_instanced_against_plain`` on ``table``, a two-level table of the
    (arity, leaf_size) ``layout`` whose instance rows ``kw`` places
    (``instance_kwargs``); a wide layout's launches are also counted under
    its name."""
    args = (table, o, d, act, TMIN, TMAX, depth, *layout)
    kernel_build.reset_launches()
    k = traverse.closest_hit(*args, **kw)
    occ = traverse.occluded(*args, **kw)
    torch.cuda.synchronize()
    launched = int(o.shape[0] > 0)
    assert kernel_build.LAUNCHES == _launched(**{
        traverse.layout_name(n, *lay): launched
        for n in traverse.INSTANCED_KERNELS
        for lay in {(16, 6), tuple(layout)}})
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


# the instanced K1/K2 at the wide layouts, (32, 12) and (32, 24)


@pytest.fixture(scope="module")
def wide_fields():
    """{layout: (table on the card, instance kwargs, stack depth)} of 8
    instances, 40 apart in x, of a 1,500-triangle box_city BLAS (more than
    one wide leaf row) and a 6-triangle pyramid, at each wide layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
        host_triangles,
    )

    city = host_triangles(scenes.box_city(n=16, seed=0)[0])[:1500]
    out = {}
    for lay in traverse.WIDE_LAYOUTS:
        b = tlas.build_instanced(
            [city, pyramid_tris()], [0, 1] * 4,
            [_translate(40.0 * k, 0.0, 0.0) for k in range(8)],
            leaf_size=lay[1], arity=lay[0])
        out[lay] = (torch.tensor(b.table, device="cuda"),
                    {"num_instances": b.num_instances,
                     "inst_base": b.inst_base, "blas_base": b.blas_base},
                    b.stack_depth)
    return out


def _field_rays(n, seed, dev):
    """Rays from above the field, down onto its instances."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-35.0, 315.0, n), rng.uniform(5.0, 25.0, n),
                  rng.uniform(-35.0, 35.0, n)], 1)
    d = rng.normal(size=(n, 3))
    d[:, 1] = -np.abs(d[:, 1]) - 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32, device=dev),
            torch.tensor(d, dtype=torch.float32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [7, 9, 29, 4101])
@pytest.mark.parametrize("layout", [(32, 12), (32, 24)])
def test_wide_instanced_kernels_match_plain_at_ragged_n(wide_fields, layout,
                                                        n):
    table, kw, depth = wide_fields[layout]
    o, d = _field_rays(n, 21 + n, table.device)
    act = torch.ones(n, dtype=torch.bool, device=table.device)
    act[::5] = False
    k, occ = _instanced_table_against_plain(table, kw, o, d, act, depth,
                                            layout)
    assert k["t"].shape == occ.shape == (n,)
    if n > 1000:
        assert k["hit"].any() and occ.any()
        # the eight cities (the pyramids lie inside them)
        assert len(torch.unique(k["inst"][k["hit"]])) >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(32, 12), (32, 24)])
def test_wide_instanced_kernels_at_the_deepest_stack(wide_fields, layout):
    # at MAX_STACK the one-thread walks' local stacks still hold a ray's
    # whole stack, and the answers equal those at the table's own depth
    table, kw, depth = wide_fields[layout]
    o, d = _field_rays(20_000, 23, table.device)
    act = torch.ones(o.shape[0], dtype=torch.bool, device=table.device)
    full = _instanced_table_against_plain(table, kw, o, d, act,
                                          traverse.MAX_STACK, layout)
    own = _instanced_table_against_plain(table, kw, o, d, act, depth, layout)
    for c in ("t", "tri_id", "inst"):
        assert torch.equal(full[0][c], own[0][c]), c
    assert torch.equal(full[1], own[1])
    res = traverse.resources(traverse.MAX_STACK)
    for name in traverse.INSTANCED_KERNELS:
        r = res[traverse.layout_name(name, *layout)]
        assert (r["group_lanes"], r["stack"]) == (1, "local"), r
        assert r["local_bytes"] >= 4 * traverse.MAX_STACK, r
        assert r["blocks_per_sm"] >= 1, r


# 32 instances of a pyramid in a line along x: the TLAS root row's 32
# children are instances, and a ray along the line hits every one's box


@pytest.fixture(scope="module")
def line_fields():
    """{layout: (table on the card, instance kwargs, stack depth)} of the
    line of 32 pyramids at each wide layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    out = {}
    for arity, leaf in traverse.WIDE_LAYOUTS:
        b = tlas.build_instanced([pyramid_tris()], [0] * 32,
                                 [_translate(1.0 * k, 0.0, 0.0)
                                  for k in range(32)],
                                 leaf_size=leaf, arity=arity)
        codes = b.table[0, 3 * arity:4 * arity].view(np.int32)
        assert bool((codes & 3 == 2).all()), "the root's 32 instances"
        out[(arity, leaf)] = (torch.tensor(b.table, device="cuda"),
                              {"num_instances": b.num_instances,
                               "inst_base": b.inst_base,
                               "blas_base": b.blas_base}, b.stack_depth)
    return out


def _line_rays(n, seed, dev):
    """Rays along the line of pyramids, from before its first one."""
    rng = np.random.default_rng(seed)
    o = np.stack([np.full(n, -3.0), rng.uniform(0.05, 0.3, n),
                  rng.uniform(-0.1, 0.1, n)], 1)
    d = np.tile([1.0, 0.0, 0.0], (n, 1)) + rng.normal(0.0, 1e-3, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32, device=dev),
            torch.tensor(d, dtype=torch.float32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(32, 12), (32, 24)])
def test_wide_instanced_kernels_with_every_tlas_child_hit(line_fields,
                                                          layout):
    table, kw, depth = line_fields[layout]
    o, d = _line_rays(4101, 41, table.device)
    act = torch.ones(o.shape[0], dtype=torch.bool, device=table.device)
    k, occ = _instanced_table_against_plain(table, kw, o, d, act, depth,
                                            layout)
    # the nearest pyramid, first on the line
    assert bool(k["hit"].all()) and bool((k["inst"] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 5, 16, 31, 32, 33])
@pytest.mark.parametrize("layout", [(32, 12), (32, 24)])
def test_wide_instanced_kernels_keep_the_full_stack_rule(line_fields, layout,
                                                         depth):
    # the root's 32 hit instances against a stack of 1-31 free slots: the
    # largest keys are kept, the farthest instances, as the plain versions
    # keep them; at 32 the nearest instance's entry takes the last slot and
    # its BLAS root's children then have one slot
    table, kw, _ = line_fields[layout]
    o, d = _line_rays(4101, 43, table.device)
    act = torch.ones(o.shape[0], dtype=torch.bool, device=table.device)
    k, _ = _instanced_table_against_plain(table, kw, o, d, act, depth,
                                          layout)
    # (at depth 1 a ray may miss its farthest pyramid and end)
    assert float(k["hit"].float().mean()) > 0.99
    assert bool((k["inst"] == 0).all()) == (depth >= 32)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(32, 12), (32, 24)])
def test_wide_instanced_kernels_on_a_box_city_blas(cuda_device, layout):
    # kernel_times' deep field at n=6: 4 instances of a 444-triangle
    # box_city_fast BLAS, on a frame's primary and bounce-0 shadow lanes
    sched = FoveationSchedule.reference_32_16_8().scaled(4)
    rays = kernel_times.field_rays("cuda", width=240, height=136,
                                   schedule=sched, layouts=[layout],
                                   field=kernel_times.deep_field(6),
                                   flat=False)
    calls = kernel_times.field_calls(rays)
    kernel_build.reset_launches()
    mism = kernel_times.field_mismatches(rays, calls, layout=layout)
    assert not any(mism.values()), mism
    for k in traverse.INSTANCED_KERNELS:
        assert kernel_build.LAUNCHES[traverse.layout_name(k, *layout)] \
            == 1
    got = calls[traverse.layout_name("ik1_primary", *layout)]()
    assert got["hit"].any() and len(torch.unique(got["inst"][got["hit"]])) \
        == 4


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(32, 12), (32, 24)])
def test_wide_instanced_kernels_on_a_leaf_root_blas(cuda_device, layout):
    # BLASes of a pyramid and of a leaf's worth of pyramids (12 or 24
    # triangles): each root node has one leaf child, which ``leaf_root``
    # makes the instances enter directly
    arity, leaf = layout
    big = np.concatenate([pyramid_tris() + np.float32([1.0 * j, 0.0, 0.0])
                          for j in range(leaf // 6)])
    b = tlas.build_instanced(
        [pyramid_tris(), big], [0, 1] * 4,
        [_translate(3.0 * (k % 4), 0.0, 3.0 * (k // 4)) for k in range(8)],
        leaf_size=leaf, arity=arity)
    kw = {"num_instances": b.num_instances, "inst_base": b.inst_base,
          "blas_base": b.blas_base}
    node = torch.tensor(b.table, device=cuda_device)
    leafy = torch.tensor(leaf_root(b.table, b.inst_base, b.blas_base,
                                   arity), device=cuda_device)
    assert not torch.equal(node, leafy)
    o, d = _grid_rays(8192, 31, cuda_device, extent=12.0)
    act = torch.ones(o.shape[0], dtype=torch.bool, device=cuda_device)
    k, occ = _instanced_table_against_plain(leafy, kw, o, d, act,
                                            b.stack_depth, layout)
    k_node, occ_node = _instanced_table_against_plain(
        node, kw, o, d, act, b.stack_depth, layout)
    for c in ("t", "u", "v", "tri_id", "inst"):
        assert torch.equal(k[c], k_node[c]), c
    assert torch.equal(occ, occ_node)
    hit_tris = torch.unique(k["tri_id"][k["hit"]]).cpu().numpy()
    assert hit_tris.min() < 6 <= hit_tris.max()
    assert occ.any()


# the two-level K2's exit inside a leaf: the occluder at each slot, back
# faces and farther triangles around it (tests/torch_blas_fields.py)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,slot", [
    *[((32, 12), s) for s in (0, 2, 3, 11)],
    *[((32, 24), s) for s in (0, 2, 3, 11, 23)]])
def test_wide_instanced_k2_leaves_a_leaf_at_its_occluder(cuda_device, layout,
                                                         slot):
    # one BLAS leaf under two instances, the second mirrored in y: the
    # first's rays meet back faces, then the occluder at ``slot``, then
    # farther triangles; the second's meet the occluders the back faces
    # become in its object-space winding, in slots on both sides
    arity, leaf = layout
    b = tlas.build_instanced(*occluder_field(leaf), leaf_size=leaf,
                             arity=arity)
    table = place_leaf_slots(b.table, b.inst_base, b.blas_base, arity, leaf,
                             occluder_order(leaf, slot))
    kw = {"num_instances": b.num_instances, "inst_base": b.inst_base,
          "blas_base": b.blas_base}
    o, d = (torch.tensor(a, device=cuda_device)
            for a in occluder_rays(8192, 51 + slot))
    act = torch.ones(o.shape[0], dtype=torch.bool, device=cuda_device)
    got = torch.tensor(table, device=cuda_device)
    _, occ = _instanced_table_against_plain(got, kw, o, d, act,
                                            b.stack_depth, layout)
    # the answer does not depend on the slots
    _, occ_built = _instanced_table_against_plain(
        torch.tensor(b.table, device=cuda_device), kw, o, d, act,
        b.stack_depth, layout)
    assert torch.equal(occ, occ_built)
    for half in (occ[0::2], occ[1::2]):  # each instance's rays
        assert half.any() and not half.all()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(32, 12), (32, 24)])
def test_wide_instanced_kernels_with_empty_groups_between_children(
        wide_fields, layout):
    # the field's node rows with their children spread over the row, empty
    # groups of four between used ones: the same answers as the table as
    # built (K1's t and hit, K2's occlusion), each exact against its plain
    # version
    table, kw, depth = wide_fields[layout]
    arity = layout[0]
    host = table.cpu().numpy()
    spread = spread_children(host, kw["inst_base"], kw["blas_base"], arity)
    assert gap_rows(host, kw["inst_base"], kw["blas_base"], arity) == 0
    assert gap_rows(spread, kw["inst_base"], kw["blas_base"], arity) > 10
    o, d = _field_rays(4101, 61, table.device)
    act = torch.ones(o.shape[0], dtype=torch.bool, device=table.device)
    k, occ = _instanced_table_against_plain(
        torch.tensor(spread, device=table.device), kw, o, d, act, depth,
        layout)
    k_built, occ_built = _instanced_table_against_plain(table, kw, o, d, act,
                                                        depth, layout)
    assert torch.equal(k["hit"], k_built["hit"])
    assert torch.equal(k["t"], k_built["t"])
    assert torch.equal(occ, occ_built) and occ.any()


# K1, K2 and the non-culling K2 on the deep-scene row orders


@pytest.mark.cuda
@pytest.mark.parametrize("layout,dfs,budget", [
    ((16, 6), True, 0), ((16, 6), False, 64), ((32, 12), False, 48),
    ((32, 24), False, 32)])
def test_kernels_on_dfs_and_treelet_tables(cuda_device, layout, dfs,
                                           budget):
    from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
        host_triangles,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops import bvh8

    tris = host_triangles(scenes.box_city(n=8, seed=0)[0])
    arity, leaf = layout
    deep = bvh8.build(tris, leaf, arity, dfs=dfs, treelet_budget=budget)
    plain = bvh8.build(tris, leaf, arity)
    assert deep.dfs and bool(deep.top_rows) == bool(budget)
    if budget:
        assert deep.num_rows > plain.num_rows  # group rows were added
    o, d, act = _rays(20_000, 41, cuda_device)
    got = []
    for b in (deep, plain):
        table = torch.tensor(b.table, device=cuda_device)
        args = (table, o, d, act, TMIN, TMAX, b.stack_depth, arity, leaf)
        k = traverse.closest_hit(*args)
        occ = traverse.occluded(*args)
        occ_n = traverse.occluded(*args, cull_backface=False)
        p = traverse.closest_hit_plain(*args)
        for c in ("t", "u", "v", "tri_id", "hit"):
            assert torch.equal(k[c], p[c]), c
        assert torch.equal(occ, traverse.occluded_plain(*args))
        assert torch.equal(occ_n, traverse.occluded_plain(
            *args, cull_backface=False))
        got.append((k, occ, occ_n))
    (kd, od, ond), (kp, op, onp) = got
    assert torch.equal(kd["hit"], kp["hit"]) and torch.equal(kd["t"], kp["t"])
    assert torch.equal(od, op) and torch.equal(ond, onp)
    assert kd["hit"].any() and od.any()


@pytest.mark.cuda
def test_kernel_resources(cuda_device):
    # at the bench scene's stack depth (50): no kernel keeps local memory;
    # the (16, 6), two-level and K3 kernels keep their registers and
    # resident blocks, one lane a ray, rows read by 16-byte loads
    res = traverse.resources(50)
    wide24 = [traverse.layout_name(k, 32, 24)
              for k in traverse.LAYOUT_KERNELS]
    wide_inst = [traverse.layout_name(k, *lay)
                 for lay in traverse.WIDE_LAYOUTS
                 for k in traverse.INSTANCED_KERNELS]
    wide_nocull = [traverse.layout_name(traverse.NOCULL_INSTANCED,
                                            *lay)
                   for lay in traverse.WIDE_LAYOUTS]
    assert all(r["local_bytes"] == 0 for k, r in res.items()
               if k not in wide24 + wide_inst + wide_nocull), res
    single = ("closest_hit", "occluded", "occluded_nocull",
              "closest_hit_instanced", "occluded_instanced",
              traverse.NOCULL_INSTANCED)
    assert [res[k]["registers"] for k in single] == [69, 96, 96, 80, 96, 96]
    assert [res[k]["blocks_per_sm"] for k in single] == [7, 5, 5, 6, 5, 5]
    assert all(res[k]["group_lanes"] == 1 and res[k]["row_copy"] == "ldg"
               for k in single)
    assert (res["occluded_packets"]["registers"],
            res["occluded_packets"]["blocks_per_sm"]) == (64, 8)
    # (32, 12): the group-per-ray walks, rows copied into shared memory; K1
    # 4 lanes a ray with its stack in global memory, K2 and the non-culling
    # K2 8 lanes a ray with the stack in shared memory
    names = [traverse.layout_name(k, 32, 12)
             for k in traverse.LAYOUT_KERNELS]
    got = [(res[k]["group_lanes"], res[k]["stack"], res[k]["registers"],
            res[k]["blocks_per_sm"], res[k]["shared_bytes"]) for k in names]
    assert got == [(4, "global", 64, 8, 22528), (8, "shared", 48, 10, 12928),
                   (8, "shared", 48, 10, 12928)], got
    assert all(res[k]["row_copy"] == "cp.async" for k in names)
    # (32, 24): one thread a ray (the group walks were slower there), the
    # MAX_STACK-entry stack in local memory; K1 asks 9 blocks/SM and
    # spills 14 B (24 B more local memory), K2 and the non-culling K2 ask 8
    # and spill nothing
    names = [traverse.layout_name(k, 32, 24)
             for k in traverse.LAYOUT_KERNELS]
    got = [(res[k]["group_lanes"], res[k]["stack"], res[k]["registers"],
            res[k]["blocks_per_sm"], res[k]["local_bytes"]) for k in names]
    assert got == [(1, "local", 56, 9, 1048), (1, "local", 63, 8, 1024),
                   (1, "local", 63, 8, 1024)], got
    # the two-level kernels at (32, 12) and (32, 24): the one-thread walk
    # with the MAX_STACK-entry stack in local memory
    # (32, 12) then (32, 24), K1 then K2: K1 without a sorting network and
    # K2 reading a node's codes a group of four at a time, both at 75
    # registers, 6 blocks/SM, nothing spilled beside the stack
    got = [(res[k]["group_lanes"], res[k]["stack"], res[k]["row_copy"],
            res[k]["registers"], res[k]["blocks_per_sm"],
            res[k]["local_bytes"]) for k in wide_inst]
    assert got == [(1, "local", "ldg", 75, 6, 1024),
                   (1, "local", "ldg", 75, 6, 1024),
                   (1, "local", "ldg", 75, 6, 1024),
                   (1, "local", "ldg", 75, 6, 1024)], got
    # the two-level K2's non-culling instantiation: the culling one's design
    got = [(res[k]["group_lanes"], res[k]["stack"], res[k]["row_copy"],
            res[k]["blocks_per_sm"], res[k]["local_bytes"])
           for k in wide_nocull]
    assert got == [(1, "local", "ldg", 6, 1024)] * 2, got


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
    # (the wide layouts: test_wide_kernels_refuse_layouts_not_compiled)
    o, d, act = _rays(64, 0, city.device)
    b = city.bvh
    with pytest.raises(ValueError, match="layout"):
        traverse.occluded(b.table, o, d, act, TMIN, TMAX, b.stack_depth,
                          8, 4, cull_backface=False)
    # a two-level table is no longer refused: it launches the two-level
    # K2's non-culling instantiation, not the single-level one
    gb = grid.bvh
    kernel_build.reset_launches()
    occ = traverse.occluded(gb.table, o, d, act, TMIN, TMAX, *gb.walk_args,
                            cull_backface=False, **gb.instance_kwargs)
    torch.cuda.synchronize()
    assert kernel_build.LAUNCHES == _launched(occluded_nocull_instanced=1)
    assert torch.equal(occ, traverse.occluded_plain(
        gb.table, o, d, act, TMIN, TMAX, *gb.walk_args, cull_backface=False,
        **gb.instance_kwargs))


# the two-level K2 without back-face culling (the 04 raycast of an
# instanced scene), at every compiled layout


@pytest.fixture(scope="module")
def nocull_grids():
    """{layout: (table on the card, instance kwargs, stack depth)}: the
    rotated grid of boxes and balls with a mirrored box (negative
    determinant) beside it, and a one-sided quad placed as is and mirrored
    in y, as two-level tables at every compiled layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    box = make_box((-0.4, 0.0, -0.4), (0.4, 0.8, 0.4),
                   Material(color=(0.8, 0.6, 0.4), roughness=0.8))
    ball = make_icosphere((0.0, 1.1, 0.0), 0.25, 1,
                          Material(color=(0.3, 0.5, 0.9), roughness=0.4))
    quad = make_quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1),
                     Material(color=(1, 1, 1), roughness=1.0))
    placements = []
    for k in range(25):
        m = _translate((k // 5) * 1.5, 0.0, (k % 5) * 1.5)
        if k % 3 == 1:
            m = m @ _rot_y(35.0)
        placements.append((k % 2, m))
    placements += [(0, _translate(3.0, 0.0, 8.0) @ np.diag([-1, 1, 1, 1])),
                   (2, _translate(-3.0, 0.5, 3.0)),
                   (2, _translate(-3.0, 0.5, 6.0) @ np.diag([1, -1, 1, 1]))]
    tables = tlas.scene_tables_from_instanced(
        instanced([box, ball, quad], placements))
    out = {}
    for lay in traverse.KERNEL_LAYOUTS:
        b = tlas.build_instanced(*tables, leaf_size=lay[1], arity=lay[0])
        out[lay] = (torch.tensor(b.table, device="cuda"),
                    {"num_instances": b.num_instances,
                     "inst_base": b.inst_base, "blas_base": b.blas_base},
                    b.stack_depth)
    return out


def _nocull_grid_rays(n, seed, dev):
    """Rays from inside and around the grid's boxes in every direction
    (many meet back faces), and down onto the two quads."""
    rng = np.random.default_rng(seed)
    o = rng.uniform((-4.0, 0.05, -1.0), (7.0, 1.5, 9.0), (n, 3))
    d = rng.normal(size=(n, 3))
    down = rng.random(n) < 0.25
    o[down] = np.stack([rng.uniform(-4.0, -2.0, int(down.sum())),
                        np.full(int(down.sum()), 3.0),
                        rng.uniform(2.0, 7.0, int(down.sum()))], 1)
    d[down] = (0.0, -1.0, 0.0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32, device=dev),
            torch.tensor(d, dtype=torch.float32, device=dev))


def _nocull_instanced_against_plain(grids, layout, n, share, seed=3):
    """Launch the two-level K2's non-culling instantiation once on ``n``
    rays (``share`` of them active) at ``layout`` and hold it to its plain
    version; returns (its answer, the culling kernel's)."""
    table, kw, depth = grids[layout]
    o, d = _nocull_grid_rays(n, seed, "cuda")
    rng = np.random.default_rng(seed + 1)
    act = torch.tensor(rng.random(n) < share, device="cuda")
    args = (table, o, d, act, TMIN, 30.0, depth, *layout)
    kernel_build.reset_launches()
    occ = traverse.occluded(*args, cull_backface=False, **kw)
    torch.cuda.synchronize()
    launched = int(n > 0)
    assert kernel_build.LAUNCHES == _launched(**{
        traverse.layout_name(traverse.NOCULL_INSTANCED, *lay):
        launched for lay in {(16, 6), tuple(layout)}})
    assert torch.equal(occ, traverse.occluded_plain(
        *args, cull_backface=False, **kw))
    assert not occ[~act].any()
    return occ, traverse.occluded(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.0, 1.0])
@pytest.mark.parametrize("layout", sorted(traverse.KERNEL_LAYOUTS))
def test_nocull_instanced_k2_matches_plain_at_active_share(nocull_grids,
                                                           layout, share):
    occ, culled = _nocull_instanced_against_plain(nocull_grids, layout, 8192,
                                                  share)
    # a culled answer is also an answer without culling; back faces (inside
    # the boxes, under the mirrored quad) add more
    assert not (culled & ~occ).any()
    assert bool((occ & ~culled).any()) == (share > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 33])
@pytest.mark.parametrize("layout", sorted(traverse.KERNEL_LAYOUTS))
def test_nocull_instanced_k2_matches_plain_at_ragged_n(nocull_grids, layout,
                                                       n):
    occ, _ = _nocull_instanced_against_plain(nocull_grids, layout, n, 1.0,
                                             seed=n)
    assert occ.shape == (n,)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(traverse.KERNEL_LAYOUTS))
def test_nocull_instanced_k2_sees_both_sides_of_a_mirrored_quad(
        nocull_grids, layout):
    # straight down onto the quad and its copy mirrored in y: the culling
    # kernel sees exactly one of them from its front, this one both
    table, kw, depth = nocull_grids[layout]
    n = 256
    rng = np.random.default_rng(2)
    z = np.where(np.arange(n) < n // 2, 3.0, 6.0) + rng.uniform(-0.5, 0.5, n)
    o = torch.tensor(np.stack([rng.uniform(-3.5, -2.5, n), np.full(n, 3.0),
                               z], 1), dtype=torch.float32, device="cuda")
    d = torch.tensor(np.tile([0.0, -1.0, 0.0], (n, 1)), dtype=torch.float32,
                     device="cuda")
    act = torch.ones(n, dtype=torch.bool, device="cuda")
    args = (table, o, d, act, TMIN, 30.0, depth, *layout)
    occ = traverse.occluded(*args, cull_backface=False, **kw)
    culled = traverse.occluded(*args, **kw)
    assert torch.equal(occ, traverse.occluded_plain(
        *args, cull_backface=False, **kw))
    assert bool(occ.all())
    first, second = culled[: n // 2], culled[n // 2:]
    assert bool((first != second[0]).all()) and bool(
        (second == second[0]).all())


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


# ---------------------------------------------------------------------------
# The pure-Python builder's tables (the JAX package's trees) under K1/K2/K3,
# and the legacy oracles (threaded BVH, per-ray and packet walks) on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def python_tables():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
        host_triangles,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops import bvh, bvh8

    tris = host_triangles(scenes.box_city(n=4, seed=0)[0])
    return (tris, bvh8.build(tris), bvh8.build_legacy8(tris),
            bvh.build(tris))


@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.35, 1.0])
def test_kernels_on_the_python_tables(city, python_tables, share):
    _, wide, leg8 = python_tables[:3]
    n = 70_001
    o, d, _ = _rays(n, 13, city.device)
    act = torch.tensor(np.random.default_rng(2).random(n) < share,
                       device=city.device)
    pt = torch.tensor(wide.table, device=city.device)
    args = (pt, o, d, act, TMIN, TMAX, wide.stack_depth, wide.arity,
            wide.leaf_size)
    lt = torch.tensor(leg8.table, device=city.device)
    largs = (lt, o, d, act, TMIN, TMAX, leg8.stack_depth, leg8.leaf_size)
    kernel_build.reset_launches()
    k = traverse.closest_hit(*args)
    occ = traverse.occluded(*args)
    occ3 = packet_traverse.occluded_packets(*largs)
    torch.cuda.synchronize()
    assert kernel_build.LAUNCHES == _launched(closest_hit=1, occluded=1,
                                              occluded_packets=1)
    p = traverse.closest_hit_plain(*args)
    for c in ("t", "u", "v", "tri_id", "hit"):
        assert torch.equal(k[c], p[c]), c
    assert torch.equal(occ, traverse.occluded_plain(*args))
    assert torch.equal(occ3, packet_traverse.occluded_packets_plain(*largs))
    # another tree of the same triangles: the same answers
    b = city.bvh
    nargs = (b.table, o, d, act, TMIN, TMAX, b.stack_depth, b.arity,
             b.leaf_size)
    kn = traverse.closest_hit(*nargs)
    assert torch.equal(k["hit"], kn["hit"]) and k["hit"].any()
    assert (k["tri_id"] == kn["tri_id"])[k["hit"]].float().mean() >= 0.999
    occ_n = traverse.occluded(*nargs)
    assert torch.equal(occ, occ_n) and torch.equal(occ3, occ_n)


@pytest.mark.cuda
def test_legacy_walks_on_the_card_equal_the_cpu(city, python_tables):
    from fovpathtracing_optixcodelatest_tpu_torch.ops import (
        traverse_packet,
        traverse_threaded,
    )

    threaded = python_tables[3]
    o, d, act = _rays(20_000, 17, "cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        tb = threaded.to(dev)
        args = (o.to(dev), d.to(dev), TMIN, TMAX)
        runs[dev] = (
            traverse_threaded.closest_hit(tb, *args, active=act.to(dev)),
            traverse_packet.closest_hit(tb, *args, active=act.to(dev),
                                        packet_size=64),
            traverse_threaded.occluded(tb, *args, active=act.to(dev)),
            traverse_packet.occluded(tb, *args, active=act.to(dev),
                                     packet_size=64))
    for want, got in zip(runs["cpu"][:2], runs["cuda"][:2]):
        assert got["steps"] == want["steps"]
        for c in ("hit", "tri_id"):
            assert torch.equal(got[c].cpu(), want[c]), c
        h = want["hit"]
        assert torch.allclose(got["t"].cpu()[h], want["t"][h], rtol=1e-6)
    for want, got in zip(runs["cpu"][2:], runs["cuda"][2:]):
        assert torch.equal(got.cpu(), want)
    # the threaded walk on the card answers as K1/K2 on the native tree
    b = city.bvh
    dargs = (o.cuda(), d.cuda(), act.cuda(), TMIN, TMAX, b.stack_depth,
             b.arity, b.leaf_size)
    assert torch.equal(runs["cuda"][0]["hit"],
                       traverse.closest_hit(b.table, *dargs)["hit"])
    assert torch.equal(runs["cuda"][2], traverse.occluded(b.table, *dargs))
    with pytest.raises(ValueError, match="bvh.to"):
        traverse_threaded.closest_hit(threaded.to("cpu"), o.cuda(), d.cuda(),
                                      TMIN, TMAX)


@pytest.mark.cuda
def test_argmin_and_probe_sample_cdf_on_the_card(cuda_device):
    from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
        gradient_sky_probe,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops import probe_sampling

    inf = float("inf")
    tie = torch.tensor([[2.0, 1.0, 1.0, 3.0], [inf, inf, inf, inf],
                        [0.5, 0.5, 0.5, 0.5], [inf, 4.0, inf, 4.0]])
    assert torch.argmin(tie.cuda(), dim=1).tolist() == [1, 0, 0, 1]
    probe = gradient_sky_probe(64, 32)
    r = torch.rand((2, 100_000), generator=torch.Generator().manual_seed(1))
    r[:, :32] = torch.as_tensor(probe.cdf_y)  # uniforms at the CDF's steps
    cpu = probe_sampling.probe_sample_cdf(probe, r[0], r[1])
    got = probe_sampling.probe_sample_cdf(probe, r[0].cuda(), r[1].cuda())
    texel = probe_sampling.cdf_texel(probe, r[0], r[1])
    for a, b in zip(texel, probe_sampling.cdf_texel(probe, r[0].cuda(),
                                                    r[1].cuda())):
        assert torch.equal(b.cpu(), a)
    assert torch.equal(got[1].cpu(), cpu[1])
    assert torch.allclose(got[0].cpu(), cpu[0], rtol=0, atol=1e-6)
    assert torch.allclose(got[2].cpu(), cpu[2], rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# K1, K2 and the non-culling K2 at the wide layouts, (32, 12) and (32, 24):
# the JAX package's deep-scene packings
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wide_cities():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    meshes = scenes.box_city(n=8, seed=0)[0]
    return {lay: build_scene(meshes, device="cuda", arity=lay[0],
                             leaf_size=lay[1])
            for lay in traverse.KERNEL_LAYOUTS}


def _wide_against_plain(scene, o, d, act, depth):
    """Launch K1, K2 and the non-culling K2 once each on a wide table, count
    them under their layout, and hold them to the plain versions; returns
    (K1, K2, non-culling K2 answers)."""
    b = scene.bvh
    args = (b.table, o, d, act, TMIN, TMAX, depth, b.arity, b.leaf_size)
    kernel_build.reset_launches()
    k = traverse.closest_hit(*args)
    occ = traverse.occluded(*args)
    occ_n = traverse.occluded(*args, cull_backface=False)
    torch.cuda.synchronize()
    launched = int(o.shape[0] > 0)
    lay = (b.arity, b.leaf_size)
    assert kernel_build.LAUNCHES == _launched(
        closest_hit=launched, occluded=launched, occluded_nocull=launched,
        **{traverse.layout_name(n, *lay): launched
           for n in traverse.LAYOUT_KERNELS})
    p = traverse.closest_hit_plain(*args)
    for c in ("t", "u", "v", "tri_id", "hit"):
        assert torch.equal(k[c], p[c]), c
    assert torch.equal(occ, traverse.occluded_plain(*args))
    assert torch.equal(occ_n, traverse.occluded_plain(*args,
                                                      cull_backface=False))
    assert not (occ | occ_n)[~act].any() and not k["hit"][~act].any()
    return k, occ, occ_n


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(32, 12), (32, 24)])
@pytest.mark.parametrize("share", [0.0, 0.01, 0.35, 1.0])
def test_wide_kernels_match_plain_at_active_share(wide_cities, layout,
                                                  share):
    scene = wide_cities[layout]
    n = 70_001
    o, d, _ = _rays(n, 7, scene.device)
    act = torch.tensor(np.random.default_rng(11).random(n) < share,
                       device=scene.device)
    k, occ, occ_n = _wide_against_plain(scene, o, d, act,
                                        scene.bvh.stack_depth)
    assert not (occ & ~occ_n).any()
    if share > 0:
        assert k["hit"].any() and occ.any()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(32, 12), (32, 24)])
# 7, 9, 29, 4101: counts that leave a warp's last groups of lanes (4 or 8
# lanes a ray at (32, 12)) without a ray
@pytest.mark.parametrize("n", [0, 1, 7, 9, 29, 31, 33, 4101, 70_001])
def test_wide_kernels_match_plain_at_ragged_n(wide_cities, layout, n):
    scene = wide_cities[layout]
    o, d, act = _rays(n, 3, scene.device)
    k, occ, _ = _wide_against_plain(scene, o, d, act, scene.bvh.stack_depth)
    assert k["t"].shape == occ.shape == (n,)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(32, 12), (32, 24)])
@pytest.mark.parametrize("depth", [2, 3])
def test_wide_kernels_keep_the_overflow_rule(wide_cities, layout, depth):
    scene = wide_cities[layout]
    o, d, act = _rays(20_000, 5, scene.device)
    k, occ, _ = _wide_against_plain(scene, o, d, act, depth)
    full = _wide_against_plain(scene, o, d, act, scene.bvh.stack_depth)
    assert not torch.equal(k["tri_id"], full[0]["tri_id"])
    assert not torch.equal(occ, full[1])
    # the full stack answers as the (16, 6) table of the same triangles
    b = wide_cities[(16, 6)].bvh
    nk = traverse.closest_hit(b.table, o, d, act, TMIN, TMAX, *b.walk_args)
    assert torch.equal(full[0]["hit"], nk["hit"])
    assert torch.equal(full[0]["t"], nk["t"])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(32, 8), (32, 6), (64, 12), (16, 12),
                                    (16, 24)])
def test_wide_kernels_refuse_layouts_not_compiled(wide_cities, layout):
    scene = wide_cities[(32, 12)]
    o, d, act = _rays(64, 0, scene.device)
    b = scene.bvh
    for kw in ({}, {"cull_backface": False}):
        with pytest.raises(ValueError, match="layout"):
            traverse.occluded(b.table, o, d, act, TMIN, TMAX, b.stack_depth,
                              *layout, **kw)
    with pytest.raises(ValueError, match="layout"):
        traverse.closest_hit(b.table, o, d, act, TMIN, TMAX, b.stack_depth,
                             *layout)
    # a compiled layout with rows of another layout's width
    with pytest.raises(ValueError, match="columns"):
        traverse.closest_hit(b.table, o, d, act, TMIN, TMAX, b.stack_depth,
                             32, 24)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(32, 12), (32, 24)])
def test_wide_kernels_at_the_deepest_stack(wide_cities, layout):
    # at MAX_STACK, the deepest stack the wrappers take, every stack home
    # still holds a ray's whole stack: (32, 12)'s K1 in the global buffer
    # its wrapper allocates, its K2s in shared memory (1 KB a ray, the
    # most a block asks for), (32, 24)'s in local memory; the walks launch,
    # keep no spills and answer as their plain versions
    scene = wide_cities[layout]
    o, d, act = _rays(20_000, 17, scene.device)
    _wide_against_plain(scene, o, d, act, traverse.MAX_STACK)
    res = traverse.resources(traverse.MAX_STACK)
    for k in traverse.LAYOUT_KERNELS:
        r = res[traverse.layout_name(k, *layout)]
        assert r["blocks_per_sm"] >= 1, r
        rays = 128 // r["group_lanes"]
        if r["stack"] == "shared":
            assert r["shared_bytes"] > 4 * traverse.MAX_STACK * rays, r
        if r["stack"] == "local":
            assert r["local_bytes"] >= 4 * traverse.MAX_STACK, r
        else:
            assert r["local_bytes"] == 0, r


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(32, 12), (32, 24)])
def test_wide_k1_keeps_the_lower_slot_of_a_tie(cuda_device, layout):
    # a leaf holding each triangle twice: both copies are hit at the same
    # t on different lanes of a group, and K1 must keep the lower slot, as
    # the plain version's serial t < best loop does
    tris = twin_tris()
    half = len(tris) // 2
    b = bvh_native.build(tris, leaf_size=layout[1], arity=layout[0])
    table = torch.tensor(b.table, device=cuda_device)
    rng = np.random.default_rng(4)
    n = 4096
    o = np.concatenate([rng.uniform(-4.9, 4.9, (n, 1)), np.full((n, 1), 5.0),
                        rng.uniform(-4.9, 4.9, (n, 1))], 1)
    d = np.concatenate([rng.normal(0, 0.05, (n, 1)), -np.ones((n, 1)),
                        rng.normal(0, 0.05, (n, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.tensor(x, dtype=torch.float32, device=cuda_device)
            for x in (o, d))
    act = torch.ones(n, dtype=torch.bool, device=cuda_device)
    args = (table, o, d, act, TMIN, TMAX, b.stack_depth, *layout)
    k = traverse.closest_hit(*args)
    p = traverse.closest_hit_plain(*args)
    for c in ("t", "u", "v", "tri_id", "hit"):
        assert torch.equal(k[c], p[c]), c
    hit = k["hit"]
    assert hit.float().mean() > 0.95
    slots = leaf_slots(b.table, *layout)
    for tid in k["tri_id"][hit].tolist():
        other = tid + half if tid < half else tid - half
        assert slots[tid][0] == slots[other][0]
        assert slots[tid][1] < slots[other][1]


# ---------------------------------------------------------------------------
# The (32, 24) single-level kernels skip a leaf's thirds from the first whose
# first slot is padding (id -1), and K1 inserts each hit key by rank
# ---------------------------------------------------------------------------


def _single_against_plain(table, o, d, act, depth, layout=(32, 24)):
    """K1, K2 and the non-culling K2 on a single-level numpy ``table`` at
    ``layout``, each held to its plain version bit for bit; returns their
    answers."""
    t = torch.tensor(table, device=o.device)
    args = (t, o, d, act, TMIN, TMAX, depth, *layout)
    kernel_build.reset_launches()
    k = traverse.closest_hit(*args)
    occ = traverse.occluded(*args)
    occ_n = traverse.occluded(*args, cull_backface=False)
    torch.cuda.synchronize()
    assert kernel_build.LAUNCHES[traverse.layout_name(
        "closest_hit", *layout)] == 1
    p = traverse.closest_hit_plain(*args)
    for c in ("t", "u", "v"):
        assert torch.equal(k[c].view(torch.int32), p[c].view(torch.int32)), c
    assert torch.equal(k["tri_id"], p["tri_id"])
    assert torch.equal(occ, traverse.occluded_plain(*args))
    assert torch.equal(occ_n, traverse.occluded_plain(*args,
                                                      cull_backface=False))
    return k, occ, occ_n


def _cut_leaves(table, leaf, fill):
    """A copy of the single-level ``table`` (numpy) whose leaf rows hold at
    most ``fill`` triangles: the rest become padding (id -1, nine zero
    words), as the packers write it. Returns (copy, the fills it holds)."""
    out = np.array(table, dtype=np.float32, copy=True)
    words = out.view(np.uint32)
    ids = words[:, 9 * leaf: 10 * leaf].view(np.int32)
    fills = set()
    for row in np.nonzero((ids >= 0).any(axis=1))[0]:
        n = int((ids[row] >= 0).sum())
        if n > fill:
            words[row, 9 * fill: 9 * n] = 0
            ids[row, fill:n] = -1
        fills.add(min(n, fill))
    return out, fills


@pytest.mark.cuda
@pytest.mark.parametrize("fill", range(1, 25))
def test_wide24_kernels_on_leaves_of_every_fill(wide_cities, fill):
    # every leaf row of the (32, 24) city cut to at most ``fill`` triangles
    # (its box left as built, so larger than its triangles): leaves of 1 to
    # 24 triangles, the skip stopping at every third
    b = wide_cities[(32, 24)].bvh
    table, fills = _cut_leaves(b.table.cpu().numpy(), 24, fill)
    assert fill in fills
    o, d, act = _rays(8192, 60 + fill, b.table.device)
    k, occ, _ = _single_against_plain(table, o, d, act, b.stack_depth)
    assert k["hit"].any() and occ.any()


def _degenerate_leaf(slot: int, fill: int):
    """One (32, 24) leaf under the root: slots 0 .. slot - 1 hold vertical
    triangles a ray going straight down never hits (det = 0), slot ``slot``
    a real degenerate triangle at the origin (nine zero words, id 0), the
    slots after it up to ``fill`` horizontal triangles stacked in y, facing
    up, and the rest padding. Returns (table, id of the topmost triangle)."""
    horizontal = [np.array([[-1.0, 0.01 * i, -1.0], [0.0, 0.01 * i, 1.0],
                            [1.0, 0.01 * i, -1.0]]) for i in range(fill)]
    vertical = [np.array([[-1.0, 0.05, 0.02 * i], [1.0, 0.05, 0.02 * i],
                          [0.0, 0.2, 0.02 * i]]) for i in range(slot)]
    tris = np.stack([np.zeros((3, 3))] + vertical
                    + horizontal[: fill - slot - 1]).astype(np.float32)
    b = bvh_native.build(tris, leaf_size=24, arity=32)
    words = b.table.view(np.uint32)
    assert (words[0, 96:128] != 0).sum() == 1 and words[0, 96] & 3 == 1
    row = int(words[0, 96]) >> 2
    ids = words[row, 216:240].view(np.int32)
    assert sorted(ids[ids >= 0]) == list(range(fill))
    out = np.array(b.table, copy=True)
    ow = out.view(np.uint32)
    order = list(range(1, slot + 1)) + [0] + list(range(slot + 1, fill))
    for k, tid in enumerate(order):  # slot k holds triangle order[k]
        at = int(np.nonzero(ids == tid)[0][0])
        ow[row, 9 * k: 9 * k + 9] = words[row, 9 * at: 9 * at + 9]
        ow[row, 216 + k] = np.uint32(tid)
    assert not ow[row, 9 * slot: 9 * slot + 9].any()
    return out, fill - 1


@pytest.mark.cuda
@pytest.mark.parametrize("slot,fill", [(0, 24), (3, 24), (12, 24), (21, 24),
                                       (3, 7), (21, 23)])
def test_wide24_kernels_read_padding_from_the_id(cuda_device, slot, fill):
    # a real degenerate triangle at the origin (all nine words 0) at the
    # first slot of a third, before every triangle the rays hit: a walk
    # that took zero words for padding would leave the leaf there
    table, top = _degenerate_leaf(slot, fill)
    rng = np.random.default_rng(slot)
    n = 4096
    o = np.stack([rng.uniform(-0.3, 0.3, n), np.full(n, 5.0),
                  rng.uniform(-0.5, 0.3, n)], 1)
    d = np.tile([0.0, -1.0, 0.0], (n, 1))
    o, d = (torch.tensor(x, dtype=torch.float32, device=cuda_device)
            for x in (o, d))
    act = torch.ones(n, dtype=torch.bool, device=cuda_device)
    k, occ, occ_n = _single_against_plain(table, o, d, act, 2)
    assert bool(k["hit"].all()) and bool((k["tri_id"] == top).all())
    assert bool(occ.all()) and bool(occ_n.all())


@pytest.fixture(scope="module")
def line24():
    """A line of 128 pyramids along x packed at (32, 24): the root row's 32
    children are leaves of four pyramids, and a ray along the line hits
    every one's box."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    tris = np.concatenate([pyramid_tris() + np.float32([1.0 * k, 0.0, 0.0])
                           for k in range(128)])
    b = bvh_native.build(tris, leaf_size=24, arity=32)
    codes = b.table[0, 96:128].view(np.uint32)
    assert bool((codes & 3 == 1).all()), "the root's 32 leaves"
    return b


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 5, 16, 31, 32, 33])
def test_wide24_kernels_keep_the_full_stack_rule(line24, depth):
    # the root's 32 hit leaves against 1-33 free slots: K1 keeps the
    # largest keys (the farthest leaves) as the plain version keeps them,
    # so only at 32 and more does it find the nearest pyramid (at depths
    # 1-5 a ray may miss the few pyramids it keeps and end)
    o, d = _line_rays(4101, 47, "cuda")
    act = torch.ones(o.shape[0], dtype=torch.bool, device="cuda")
    k, occ, _ = _single_against_plain(line24.table, o, d, act, depth)
    assert float(k["hit"].float().mean()) > 0.9 and bool(occ.all())
    assert bool((k["tri_id"] < 6).all()) == (depth >= 32)
