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


def make_quad(p0, p1, p2, p3, material: Material,
              texture_id: int = -1) -> HostMesh:
    """Two-triangle quad p0->p1->p2->p3 (counter-clockwise) with unit
    texcoords."""
    vertex = np.asarray([p0, p1, p2, p3], dtype=np.float32)
    index = np.asarray([[0, 1, 2], [0, 2, 3]], dtype=np.int32)
    n = np.cross(vertex[1] - vertex[0], vertex[2] - vertex[0])
    n = n / max(np.linalg.norm(n), 1e-12)
    normal = np.tile(n.astype(np.float32), (4, 1))
    texcoord = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float32)
    return HostMesh(vertex=vertex, index=index, normal=normal,
                    texcoord=texcoord, material=material,
                    diffuse_texture_id=texture_id)


def make_icosphere(center, radius, subdivisions: int,
                   material: Material) -> HostMesh:
    """Subdivided icosahedron with smooth normals: 20 * 4^s triangles."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.asarray(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.asarray(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdivisions):
        edge_mid: dict = {}
        verts_list = list(verts)
        new_faces = []

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m = m / np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)
    center = np.asarray(center, dtype=np.float64)
    vertex = (center + radius * verts).astype(np.float32)
    return HostMesh(
        vertex=vertex,
        index=faces.astype(np.int32),
        normal=verts.astype(np.float32),
        texcoord=np.zeros((len(vertex), 2), dtype=np.float32),
        material=material,
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


def shading_normal_rows(meshes: Sequence[HostMesh]) -> np.ndarray:
    """(T, 10) float32: each triangle's corner shading normals n0, n1, n2
    and 1.0 where its mesh has normals (zeros and 0.0 where it has none),
    as the JAX package's ``tri_n0..2`` and ``has_shading_normals``."""
    rows = []
    for mesh in meshes:
        idx = mesh.index.astype(np.int64)
        r = np.zeros((len(idx), 10), dtype=np.float32)
        if mesh.normal is not None and len(mesh.normal):
            n = mesh.normal.astype(np.float32)
            r[:, 0:9] = np.concatenate(
                [n[idx[:, 0]], n[idx[:, 1]], n[idx[:, 2]]], axis=1)
            r[:, 9] = 1.0
        rows.append(r)
    return np.concatenate(rows, axis=0)


def host_triangles(meshes: Sequence[HostMesh]) -> np.ndarray:
    """(T, 3, 3) float32 triangle corners: the BVH build input."""
    tris = []
    for mesh in meshes:
        v = mesh.vertex.astype(np.float32)
        idx = mesh.index.astype(np.int64)
        tris.append(np.stack([v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]], axis=1))
    return np.concatenate(tris, axis=0)
