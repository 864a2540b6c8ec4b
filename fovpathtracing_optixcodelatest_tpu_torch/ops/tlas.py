"""Two-level table for render-time instancing (counterpart of the JAX
package's ``ops/tlas.py``; host numpy, bit-identical output).

Device memory scales with the unique meshes, not the world triangles: one
table holds

  rows [0, inst_base)         TLAS node rows: bf16 boxes of the instances'
                              world boxes; a child is a TLAS row or an
                              instance code (instance_id << 2) | KIND_INST
  rows [inst_base, blas_base) instance rows, 13 float32 words:
                              [bitcast(BLAS root code), A (3x3 row-major),
                              b (3)], x_object = A @ x_world + b being the
                              inverse of the instance's transform
  rows [blas_base, U)         one BLAS region per unique mesh (node rows,
                              then leaf rows, in the single-level layout;
                              row and triangle offsets applied to every
                              code and id)

A traversal that pops an instance code moves the lane into that instance's
object space (the ray through A and b, the direction left unnormalised so
t stays in world units) and pushes the BLAS root; popping a TLAS node row
moves it back (``ops/traverse.py``). At most one instance's BLAS rows are
on a lane's stack at a time, so one ``cur`` register tracks the space.

Occlusion culls back faces by the object-space winding, so a mirroring
(negative-determinant) transform flips which side is culled: the
reference's documented caveat, kept.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from fovpathtracing_optixcodelatest_tpu_torch.ops.bvh8 import (
    ARITY,
    EMPTY,
    KIND_INST,
    KIND_NODE,
    LEAF_SIZE,
    WideBVH,
    lifo_stack_bound,
    pack_boxes_into,
    pack_region_into,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops.bvh_native import collapse_any


def build_instanced(unique_tris: Sequence[np.ndarray],
                    mesh_of_instance: Sequence[int],
                    transforms: Sequence[np.ndarray],
                    leaf_size: int = LEAF_SIZE,
                    arity: int = ARITY) -> WideBVH:
    """The two-level table of ``unique_tris`` (per unique mesh, (T_i, 3, 3)
    object-space corners; triangle ids offset by the running count, the
    order of ``flatten_meshes(unique)``) placed by each instance's mesh id
    and 4x4 object-to-world matrix."""
    n_inst = len(mesh_of_instance)
    assert n_inst >= 1 and len(unique_tris) >= 1
    assert len(transforms) == n_inst
    tris32 = [np.asarray(t, np.float32) for t in unique_tris]
    blas = [collapse_any(t, leaf_size, arity) for t in tris32]
    obj_lo = [t.reshape(-1, 3).min(0) for t in tris32]
    obj_hi = [t.reshape(-1, 3).max(0) for t in tris32]

    # the instances' world boxes and inverse transforms
    world_boxes = np.zeros((n_inst, 6), dtype=np.float32)
    inv_a = np.zeros((n_inst, 3, 3), dtype=np.float32)
    inv_b = np.zeros((n_inst, 3), dtype=np.float32)
    for i, (mid, mtx) in enumerate(zip(mesh_of_instance, transforms)):
        m4 = np.asarray(mtx, dtype=np.float64)
        lo, hi = obj_lo[mid], obj_hi[mid]
        corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
        wc = corners @ m4[:3, :3].T + m4[:3, 3]
        world_boxes[i, 0:3] = wc.min(0)
        world_boxes[i, 3:6] = wc.max(0)
        a = np.linalg.inv(m4[:3, :3])
        inv_a[i] = a.astype(np.float32)
        inv_b[i] = (-a @ m4[:3, 3]).astype(np.float32)

    # the TLAS: one degenerate triangle per instance whose box and centroid
    # are the instance's (the builder reads only those); one instance a slot
    fake = np.stack([world_boxes[:, 0:3], world_boxes[:, 3:6],
                     0.5 * (world_boxes[:, 0:3] + world_boxes[:, 3:6])],
                    axis=1).astype(np.float32)
    t_boxes, t_meta, t_order = collapse_any(fake, 1, arity)
    mt = t_boxes.shape[0]

    width = max(4 * arity, 10 * leaf_size, 13)
    inst_base, blas_base = mt, mt + n_inst
    regions = []  # (first row, first triangle id) of each BLAS
    row, tri_base = blas_base, 0
    for (boxes, meta, _), t in zip(blas, tris32):
        regions.append((row, tri_base))
        row += boxes.shape[0] + int((meta[..., 1] > 0).sum())
        tri_base += len(t)
    table = np.zeros((row, width), dtype=np.float32)
    leaf_perm = np.full((row, leaf_size), -1, dtype=np.int32)

    # TLAS node rows: an internal child is a TLAS row, a leaf slot an
    # instance code
    t_counts, t_avals = t_meta[..., 1], t_meta[..., 0]
    t_entry = np.full((mt, arity), EMPTY, dtype=np.int32)
    t_entry[t_counts == 0] = (t_avals[t_counts == 0] << 2) | KIND_NODE
    lw, ls = np.nonzero(t_counts > 0)
    inst_ids = t_order[np.clip(t_avals[lw, ls].astype(np.int64), 0,
                               max(len(t_order) - 1, 0))].astype(np.int32)
    t_entry[lw, ls] = (inst_ids << 2) | KIND_INST
    pack_boxes_into(table, 0, t_boxes, t_entry, arity)

    for i, mid in enumerate(mesh_of_instance):
        root_code = (regions[mid][0] << 2) | KIND_NODE
        table[inst_base + i, 0] = np.int32(root_code).view(np.float32)
        table[inst_base + i, 1:10] = inv_a[i].reshape(9)
        table[inst_base + i, 10:13] = inv_b[i]

    max_blas_sd = 2
    for (boxes, meta, order), t, (row0, tb) in zip(blas, tris32, regions):
        _, ent = pack_region_into(table, leaf_perm, row0, tb, boxes, meta, t,
                                  order, leaf_size, arity)
        max_blas_sd = max(max_blas_sd, lifo_stack_bound(ent, row0=row0))

    # inside a BLAS a lane's stack holds at most tlas_sd - 1 TLAS entries
    # (the instance's own entry was popped before its root was pushed) and
    # the BLAS peak on top; + 1 safety entry
    tlas_sd = lifo_stack_bound(t_entry)
    stack_depth = max(tlas_sd, tlas_sd - 1 + max_blas_sd) + 1
    return WideBVH(
        table=table, leaf_perm=leaf_perm, leaf_size=leaf_size, arity=arity,
        packed=True, stack_depth=stack_depth, num_instances=n_inst,
        inst_base=inst_base, blas_base=blas_base,
    )


def scene_tables_from_instanced(instanced_scene) -> tuple:
    """(unique_tris list, mesh ids, transforms) of a ``models/instance.py``
    ``InstancedScene``: an instance of several meshes becomes one instance
    per (mesh, transform) pair."""
    from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
        host_triangles,
    )

    unique_tris = [host_triangles([m]) for m in instanced_scene.unique]
    mesh_ids: List[int] = []
    mats: List[np.ndarray] = []
    for inst in instanced_scene.instances:
        for mid in inst.mesh_ids:
            mesh_ids.append(mid)
            mats.append(np.asarray(inst.transform, dtype=np.float64))
    return unique_tris, mesh_ids, mats
