"""Wavefront OBJ/MTL loader → HostMesh list (+ texture images); the port's
own copy of the JAX package's ``models/obj_loader.py``.

Behavior twin of PT_sv5_/Model.cpp (which wraps tinyobjloader):
- one HostMesh per (shape × material), like the per-material mesh split
  (Model.cpp:167-206);
- vertex dedup by the (v, n, t) index triple (addVertex, Model.cpp:50-83);
- diffuse color/emission from the MTL (Kd/Ke, Model.cpp:190-191);
- diffuse textures loaded and y-flipped (loadTexture, Model.cpp:87-136),
  deduplicated by filename;
- polygon faces are fan-triangulated (tinyobj's default triangulation).

Pure Python/numpy — the host data path needs no external OBJ dependency.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from fovpathtracing_optixcodelatest_tpu_torch.models.material import Material
from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import HostMesh


def _parse_mtl(path: str) -> Dict[str, dict]:
    """Parse an MTL file into {material name: {kd, ke, ns, d, map_kd, ...}}."""
    mats: Dict[str, dict] = {}
    cur: Optional[dict] = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0].lower()
            if key == "newmtl":
                cur = {
                    "kd": (0.8, 0.8, 0.8),
                    "ke": (0.0, 0.0, 0.0),
                    "ks": (0.0, 0.0, 0.0),
                    "ns": 10.0,
                    "ni": 1.45,
                    "d": 1.0,
                    "map_kd": None,
                }
                mats[" ".join(parts[1:])] = cur
            elif cur is None:
                continue
            elif key == "kd" and len(parts) >= 4:
                cur["kd"] = tuple(float(x) for x in parts[1:4])
            elif key == "ke" and len(parts) >= 4:
                cur["ke"] = tuple(float(x) for x in parts[1:4])
            elif key == "ks" and len(parts) >= 4:
                cur["ks"] = tuple(float(x) for x in parts[1:4])
            elif key == "ns" and len(parts) >= 2:
                cur["ns"] = float(parts[1])
            elif key == "ni" and len(parts) >= 2:
                cur["ni"] = float(parts[1])
            elif key == "d" and len(parts) >= 2:
                cur["d"] = float(parts[1])
            elif key == "map_kd" and len(parts) >= 2:
                cur["map_kd"] = parts[-1]
    return mats


def _material_from_mtl(m: dict) -> Material:
    """Map MTL Phong-ish parameters onto the Disney set the way the reference
    scenes behave: Kd → color, Ke → emission, everything else conservative
    (no transmission unless dissolve < 1)."""
    transmission = max(0.0, 1.0 - float(m.get("d", 1.0)))
    roughness = float(np.clip(1.0 - np.log10(max(m.get("ns", 10.0), 1.0)) / 3.0, 0.05, 1.0))
    return Material(
        color=tuple(m.get("kd", (0.8, 0.8, 0.8))),
        emission=tuple(m.get("ke", (0.0, 0.0, 0.0))),
        eta=float(m.get("ni", 1.45)),
        metallic=0.0,
        specular=0.5,
        specular_tint=0.0,
        roughness=roughness,
        transmission=transmission,
    )


def load_texture(path) -> Optional[np.ndarray]:
    """Load an image (a path or a binary file object) as float32 (h, w, 3)
    in [0,1], y-flipped like the reference's stb path (Model.cpp:87-136).
    Returns None on failure: missing or unreadable textures are
    non-fatal."""
    from PIL import Image

    try:
        with Image.open(path) as img:
            arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    except (OSError, ValueError):
        return None
    return arr[::-1].copy()  # y-flip


def load_obj(path: str) -> Tuple[List[HostMesh], List[np.ndarray]]:
    """Load an OBJ file. Returns (meshes, texture_images); each HostMesh's
    ``diffuse_texture_id`` indexes texture_images (-1 = untextured)."""
    base = os.path.dirname(os.path.abspath(path))
    positions: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    texcoords: List[Tuple[float, float]] = []
    mtl: Dict[str, dict] = {}
    # faces grouped by material: list of triangles of (vi, ti, ni) triples
    groups: Dict[str, list] = {}
    cur_mat = ""

    def _idx(tok: str, count: int) -> int:
        i = int(tok)
        return i - 1 if i > 0 else count + i

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions.append(tuple(float(x) for x in parts[1:4]))
            elif key == "vn":
                normals.append(tuple(float(x) for x in parts[1:4]))
            elif key == "vt":
                texcoords.append(tuple(float(x) for x in parts[1:3]))
            elif key == "mtllib":
                mtl.update(_parse_mtl(os.path.join(base, " ".join(parts[1:]))))
            elif key == "usemtl":
                cur_mat = " ".join(parts[1:])
            elif key == "f":
                corners = []
                for tok in parts[1:]:
                    sub = tok.split("/")
                    vi = _idx(sub[0], len(positions))
                    ti = (
                        _idx(sub[1], len(texcoords))
                        if len(sub) > 1 and sub[1]
                        else -1
                    )
                    ni = (
                        _idx(sub[2], len(normals))
                        if len(sub) > 2 and sub[2]
                        else -1
                    )
                    corners.append((vi, ti, ni))
                tris = groups.setdefault(cur_mat, [])
                for k in range(1, len(corners) - 1):  # fan triangulation
                    tris.append((corners[0], corners[k], corners[k + 1]))

    pos = np.asarray(positions, dtype=np.float32)
    nrm = (
        np.asarray(normals, dtype=np.float32)
        if normals
        else np.zeros((0, 3), np.float32)
    )
    uv = (
        np.asarray(texcoords, dtype=np.float32)
        if texcoords
        else np.zeros((0, 2), np.float32)
    )

    meshes: List[HostMesh] = []
    textures: List[np.ndarray] = []
    tex_id_by_path: Dict[str, int] = {}

    for mat_name, tris in groups.items():
        # vertex dedup by (v, t, n) triple (addVertex twin)
        remap: Dict[Tuple[int, int, int], int] = {}
        verts, vns, vts, index = [], [], [], []
        has_n = False
        for tri in tris:
            ids = []
            for corner in tri:
                if corner not in remap:
                    remap[corner] = len(verts)
                    vi, ti, ni = corner
                    verts.append(pos[vi])
                    vns.append(
                        nrm[ni] if 0 <= ni < len(nrm) else np.zeros(3, np.float32)
                    )
                    if 0 <= ni < len(nrm):
                        has_n = True
                    vts.append(
                        uv[ti] if 0 <= ti < len(uv) else np.zeros(2, np.float32)
                    )
                ids.append(remap[corner])
            index.append(ids)
        m = mtl.get(mat_name, {})
        material = _material_from_mtl(m) if m else Material(
            color=(0.8, 0.8, 0.8), emission=(0.0, 0.0, 0.0), metallic=0.0,
            roughness=1.0, transmission=0.0, specular=0.5, specular_tint=0.0,
        )
        tex_id = -1
        map_kd = m.get("map_kd") if m else None
        if map_kd:
            tp = os.path.join(base, map_kd)
            if tp not in tex_id_by_path:
                img = load_texture(tp)
                tex_id_by_path[tp] = len(textures) if img is not None else -1
                if img is not None:
                    textures.append(img)
            tex_id = tex_id_by_path[tp]
        meshes.append(
            HostMesh(
                vertex=np.asarray(verts, dtype=np.float32),
                index=np.asarray(index, dtype=np.int32),
                normal=np.asarray(vns, dtype=np.float32) if has_n else None,
                texcoord=np.asarray(vts, dtype=np.float32),
                material=material,
                diffuse_texture_id=tex_id,
            )
        )
    return meshes, textures
