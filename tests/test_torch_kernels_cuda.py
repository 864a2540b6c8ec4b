"""The port's CUDA kernels (K1, K2, K3) against their plain PyTorch versions.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels have no CPU
mode) and skip without one. They import nothing of JAX, so they run on a
machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Tolerance: every output exact (hit, tri_id, occlusion, and t/u/v bit for
bit), since the kernels are built with --fmad=false and repeat the plain
versions' operations in the same order.
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
