"""The port's CUDA kernels (K1, K2, K3) against their plain PyTorch versions.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels have no CPU
mode) and skip without one. They import nothing of JAX, so they run on a
machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Tolerance: every output exact (hit, tri_id, occlusion, and t/u/v bit for
bit), since the kernels are built with --fmad=false and repeat the plain
versions' operations in the same order. K1 and K2 fetch their lanes from a
counter in chunks of 32 and skip inactive lanes, so they are also held to
the plain versions at sparse active masks, at lane counts around a chunk's
edge, and at stacks small enough to overflow (the plain versions pin the
overflow rule); a layout other than (16, 6) must raise.
"""

import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import build_scene
from fovpathtracing_optixcodelatest_tpu_torch.ops import (
    kernel_build,
    packet_traverse,
    traverse,
)

TMIN, TMAX = 0.01, 1e16


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
    assert kernel_build.LAUNCHES == {"closest_hit": 1, "occluded": 1,
                                     "occluded_packets": 2}


# ---------------------------------------------------------------------------
# K1/K2 (persistent warps fetching their lanes from a counter) at the edges
# of that fetch: sparse masks, ragged lane counts, small stacks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def city():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return build_scene(scenes.box_city(n=4, seed=0)[0], device="cuda")


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
    assert kernel_build.LAUNCHES == {"closest_hit": launched,
                                     "occluded": launched,
                                     "occluded_packets": 0}
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
