"""Frames over several devices with the triangle table cut into row blocks
(counterpart of the JAX package's ``parallel/scene_shard.py``).

``tri_pack`` (48 float32 a triangle: two thirds of a large scene's device
memory) is padded to a multiple of the rank count and cut into equal
blocks, rank ``d`` holding rows [d*R, (d+1)*R) on its device. Samples are
split as in ``parallel/tiles.py``. The integrator's row gathers walk the
blocks rank by rank (``render/integrator.take_tri_pack``), each copied to
the gathering rank's device as it comes, and sum the rows in int32: bit
for bit the whole table's gather, so the frame is the single-device frame.
The BVH table, the materials, textures and probe stay replicated, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from fovpathtracing_optixcodelatest_tpu_torch.parallel import tiles
from fovpathtracing_optixcodelatest_tpu_torch.parallel.tiles import make_mesh

__all__ = ["make_mesh", "pad_scene_rows", "render_frame_scene_sharded",
           "shard_scene"]


def pad_scene_rows(scene, n_dev: int):
    """``scene`` with ``tri_pack`` padded by zero rows to a multiple of
    ``n_dev`` rows. The padding is never reached: traversal gives triangle
    ids below the scene's count."""
    t, cols = scene.tri_pack.shape
    pad = (-t) % n_dev
    if pad == 0:
        return scene
    zeros = torch.zeros((pad, cols), dtype=scene.tri_pack.dtype,
                        device=scene.tri_pack.device)
    return dataclasses.replace(
        scene, tri_pack=torch.cat([scene.tri_pack, zeros], dim=0))


def shard_scene(scene, mesh) -> list:
    """One scene a rank: the replicated arrays copied once a distinct
    device, ``tri_pack`` the rank's own block (a copy of its rows on its
    device), ``pack_blocks`` every rank's block. Pad with
    ``pad_scene_rows`` first."""
    n = len(mesh)
    t = scene.tri_pack.shape[0]
    if t % n:
        raise ValueError(f"{t} rows do not split in {n}: pad_scene_rows first")
    r = t // n
    blocks = tuple(scene.tri_pack[i * r:(i + 1) * r].to(dev, copy=True)
                   for i, dev in enumerate(mesh))
    bare = dataclasses.replace(scene, tri_pack=scene.tri_pack[:0])
    return [dataclasses.replace(rep, tri_pack=blocks[i], pack_blocks=blocks,
                                pack_rank=i)
            for i, rep in enumerate(tiles.replicate(bare, mesh))]


def render_frame_scene_sharded(scene, camera, gaze_x: int, gaze_y: int,
                               subframe: int, canvas: torch.Tensor, key,
                               config, schedule, mesh, rank_scenes=None):
    """``tiles.render_frame_sharded`` with ``tri_pack`` row-sharded over
    ``mesh`` (``rank_scenes`` from ``shard_scene``, by default cut from
    ``scene`` for this frame) -> (canvas, frame, traces)."""
    if rank_scenes is None:
        rank_scenes = shard_scene(scene, mesh)
    return tiles.render_frame_sharded(scene, camera, gaze_x, gaze_y,
                                      subframe, canvas, key, config, schedule,
                                      mesh, rank_scenes=rank_scenes)
