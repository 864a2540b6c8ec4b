"""The occlusion contract K3 keeps: each ray's own answer, not the Pallas
kernel's union walk.

The JAX package's Pallas kernel (``ops/pallas_traverse.py``) walks packets
of rays with one stack and no lane masks: it descends into every child that
any pending ray of the packet hits and tests every pending ray against each
triangle it reaches. A ray that fails its own slab test on a leaf's box by
rounding, but whose triangle lies just inside it, is then found occluded
whenever another ray of its packet leads the walk into that leaf. The two
rays below are the bench frame's bounce-0 shadow rays 37278 (the grazing
ray) and 36867 (its leader): box_city n=24 seed 0, 960x540
``reference_32_16_8``, on the legacy table the port builds
(``collapse_native`` + ``pack_wide_legacy8``). On the bench frame the union
walk answers differently from the per-ray walk on five of 499,085 queried
rays (ROADMAP.md §3).

- the Pallas kernel (interpret mode) answers occluded for the grazing ray
  with its leader in the packet, and not occluded for it alone;
- a brute-force test of every triangle says occluded;
- ``occluded_packets_plain`` (K3's plain version, the per-ray walk) says
  not occluded, and so does ``traverse8.occluded`` on the packed table (XLA
  on the CPU contracts FMAs, but it answers alike on these two rays).

Exact: the rays are stored as their float32 bit patterns.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu.models import scenes as jscenes
from fovpathtracing_optixcodelatest_tpu.models.mesh import (
    host_triangles as j_host_triangles,
)
from fovpathtracing_optixcodelatest_tpu.models.probe import constant_probe
from fovpathtracing_optixcodelatest_tpu.models.scene import build_scene as j_build
from fovpathtracing_optixcodelatest_tpu.ops import bvh8 as jbvh8
from fovpathtracing_optixcodelatest_tpu.ops import pallas_traverse, traverse8
from fovpathtracing_optixcodelatest_tpu.ops.bvh_native import collapse_native
from fovpathtracing_optixcodelatest_tpu_torch.ops import intersect, packet_traverse

torch.set_num_threads(2)

TMIN, TMAX = 0.01, 1e16
# (grazing ray, its leader): origin and direction as float32 bit patterns
ORIGIN_BITS = [[3241061352, 3208284672, 1109393408],
               [3253739810, 1087335974, 1108931070]]
DIRECTION_BITS = [[1059219353, 3209028612, 862860129],
                  [3166289110, 3200511768, 3211555106]]


@pytest.fixture(scope="module")
def bench():
    meshes = jscenes.box_city(n=24, seed=0)[0]
    tris = j_host_triangles(meshes)
    boxes, meta, perm = collapse_native(tris, 4, 8)
    legacy = jbvh8.pack_wide_legacy8(boxes, meta, tris, perm, 4)
    o = np.array(ORIGIN_BITS, dtype=np.uint32).view(np.float32)
    d = np.array(DIRECTION_BITS, dtype=np.uint32).view(np.float32)
    return meshes, legacy, o, d


def test_union_walk_finds_the_grazing_ray_occluded(bench):
    meshes, legacy, o, d = bench
    act = np.ones(2, dtype=bool)

    def pallas(k):
        return np.asarray(pallas_traverse.occluded_packets(
            legacy, jnp.asarray(o[:k]), jnp.asarray(d[:k]), TMIN, TMAX,
            active=jnp.asarray(act[:k]), interpret=True))

    # with its leader in the packet the grazing ray is tested in a leaf its
    # own slab test misses, and a triangle there occludes it
    assert pallas(2).tolist() == [True, True]
    assert pallas(1).tolist() == [False]
    tris = torch.from_numpy(j_host_triangles(meshes))
    brute = intersect.brute_force_occluded(
        tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0],
        torch.from_numpy(o), torch.from_numpy(d), TMIN, TMAX)
    assert brute.tolist() == [True, True]
    # the per-ray walk never reaches that leaf for the grazing ray
    plain = packet_traverse.occluded_packets_plain(
        torch.tensor(np.asarray(legacy.table)), torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(act), TMIN, TMAX,
        legacy.stack_depth, legacy.leaf_size)
    assert plain.tolist() == [False, True]


def test_per_ray_walk_of_the_packed_table_agrees(bench):
    meshes, _, o, d = bench
    jscene = j_build(meshes, probe=constant_probe((1.0, 1.0, 1.0)))
    got = np.asarray(traverse8.occluded(
        jscene.bvh, jnp.asarray(o), jnp.asarray(d), TMIN, TMAX,
        active=jnp.ones(2, dtype=bool)))
    assert got.tolist() == [False, True]
