"""Host triangle meshes and the flattened per-triangle attribute table
(counterpart of the JAX package's ``models/mesh.py``).

``flatten_meshes`` builds the 48-column ``tri_pack`` exactly as the JAX
package does: cols 0:3 geometric normal, 3:9 corner uvs, 9 material id and
10 texture id (int32 bitcast), 12:36 the material's packed row, 36:45 the
Möller-Trumbore inputs [v0, e1, e2] (the same float32 values the BVH leaf
rows pack, so shading re-intersects bit-identically)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from fovpathtracing_optixcodelatest_tpu_torch.models.material import (
    Material,
    packed_rows_numpy,
)


@dataclasses.dataclass
class HostMesh:
    vertex: np.ndarray  # (V, 3) float32
    index: np.ndarray  # (F, 3) int32
    normal: Optional[np.ndarray] = None
    texcoord: Optional[np.ndarray] = None
    material: Material = dataclasses.field(default_factory=Material)
    diffuse_texture_id: int = -1

    @property
    def num_triangles(self) -> int:
        return int(self.index.shape[0])


def make_box(pos, extent, material: Material, texture_id: int = -1) -> HostMesh:
    """Axis-aligned box: 12 triangles over 36 unshared vertices with
    per-face normals."""
    px, py, pz = pos
    ex, ey, ez = extent
    A = (-ex + px, -ey + py, ez + pz)
    B = (ex + px, -ey + py, ez + pz)
    C = (ex + px, ey + py, ez + pz)
    D = (-ex + px, ey + py, ez + pz)
    E = (-ex + px, -ey + py, -ez + pz)
    F = (ex + px, -ey + py, -ez + pz)
    G = (ex + px, ey + py, -ez + pz)
    H = (-ex + px, ey + py, -ez + pz)
    verts = [
        A, B, C, A, C, D,  # front (+z)
        E, H, G, E, G, F,  # back (-z)
        E, A, D, E, D, H,  # left (-x)
        B, F, G, B, G, C,  # right (+x)
        D, C, G, D, G, H,  # top (+y)
        E, A, B, E, B, F,  # bottom (-y)
    ]
    face_normals = [
        (0, 0, 1), (0, 0, -1), (-1, 0, 0), (1, 0, 0), (0, 1, 0), (0, -1, 0)
    ]
    normals = np.repeat(np.asarray(face_normals, dtype=np.float32), 6, axis=0)
    return HostMesh(
        vertex=np.asarray(verts, dtype=np.float32),
        index=np.arange(36, dtype=np.int32).reshape(12, 3),
        normal=normals,
        texcoord=np.zeros((36, 2), dtype=np.float32),
        material=material,
        diffuse_texture_id=texture_id,
    )


def flatten_meshes(meshes: Sequence[HostMesh]):
    """Concatenate meshes -> (tri_pack (T, 48) float32, materials list)."""
    v0s, e1s, e2s = [], [], []
    t0s, t1s, t2s = [], [], []
    mat_ids, tex_ids = [], []
    materials: List[Material] = []
    for mesh in meshes:
        mat_id = len(materials)
        materials.append(mesh.material)
        v = mesh.vertex.astype(np.float32)
        idx = mesh.index.astype(np.int64)
        p0, p1, p2 = v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]
        v0s.append(p0)
        e1s.append(p1 - p0)
        e2s.append(p2 - p0)
        if mesh.texcoord is not None and len(mesh.texcoord):
            tc = mesh.texcoord.astype(np.float32)
            t0s.append(tc[idx[:, 0]])
            t1s.append(tc[idx[:, 1]])
            t2s.append(tc[idx[:, 2]])
        else:
            z2 = np.zeros((len(idx), 2), dtype=np.float32)
            t0s.append(z2)
            t1s.append(z2)
            t2s.append(z2)
        mat_ids.append(np.full(len(idx), mat_id, dtype=np.int32))
        tex_ids.append(np.full(len(idx), mesh.diffuse_texture_id, dtype=np.int32))

    v0_all = np.concatenate(v0s)
    e1_all = np.concatenate(e1s)
    e2_all = np.concatenate(e2s)
    mat_all = np.concatenate(mat_ids)
    tex_all = np.concatenate(tex_ids)
    t_count = len(v0_all)

    gn = np.cross(e1_all, e2_all)
    gn /= np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-20)
    mat_rows = packed_rows_numpy(materials)
    safe_mat = np.clip(mat_all.astype(np.int64), 0, len(mat_rows) - 1)
    tri_pack = np.zeros((t_count, 48), dtype=np.float32)
    tri_pack[:, 0:3] = gn
    tri_pack[:, 3:5] = np.concatenate(t0s)
    tri_pack[:, 5:7] = np.concatenate(t1s)
    tri_pack[:, 7:9] = np.concatenate(t2s)
    tri_pack[:, 9] = mat_all.astype(np.int32).view(np.float32)
    tri_pack[:, 10] = tex_all.astype(np.int32).view(np.float32)
    tri_pack[:, 12:36] = mat_rows[safe_mat]
    tri_pack[:, 36:39] = v0_all
    tri_pack[:, 39:42] = e1_all
    tri_pack[:, 42:45] = e2_all
    return tri_pack, materials


def host_triangles(meshes: Sequence[HostMesh]) -> np.ndarray:
    """(T, 3, 3) float32 triangle corners: the BVH build input."""
    tris = []
    for mesh in meshes:
        v = mesh.vertex.astype(np.float32)
        idx = mesh.index.astype(np.int64)
        tris.append(np.stack([v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]], axis=1))
    return np.concatenate(tris, axis=0)
