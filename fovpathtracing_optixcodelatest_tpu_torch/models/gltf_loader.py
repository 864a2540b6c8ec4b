"""Minimal glTF 2.0 importer (counterpart of the JAX package's
``models/gltf_loader.py``): unique object-space meshes and an instance
table (``models/instance.py``), plus their textures.

Supported: ``.gltf`` (JSON with external or base64 data-URI buffers) and
``.glb`` containers; the node hierarchy with TRS or matrix transforms
(nodes that share a glTF mesh share its geometry); triangle primitives with
POSITION, NORMAL and TEXCOORD_0 accessors, indices of u8/u16/u32 and byte
strides; pbrMetallicRoughness materials (baseColorFactor/-Texture,
metallic and roughness factors, emissiveFactor). Images go through the
port's own loader (``obj_loader.load_texture``), y-flipped.
"""

from __future__ import annotations

import base64
import io
import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from fovpathtracing_optixcodelatest_tpu_torch.models.instance import (
    Instance,
    InstancedScene,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.material import Material
from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import HostMesh
from fovpathtracing_optixcodelatest_tpu_torch.models.obj_loader import (
    load_texture,
)

_COMPONENT_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_buffers(doc: dict, base: str, glb_bin: Optional[bytes]) -> List[bytes]:
    bufs = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            bufs.append(glb_bin or b"")
        elif uri.startswith("data:"):
            bufs.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base, uri), "rb") as fh:
                bufs.append(fh.read())
    return bufs


def _read_accessor(doc: dict, bufs: List[bytes], idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPE[acc["componentType"]]
    ncomp = _TYPE_COUNT[acc["type"]]
    count = acc["count"]
    itemsize = np.dtype(dtype).itemsize * ncomp
    stride = view.get("byteStride", itemsize)
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    raw = bufs[view["buffer"]]
    if stride == itemsize:
        return np.frombuffer(raw, dtype=dtype, count=count * ncomp,
                             offset=start).reshape(count, ncomp).copy()
    return np.stack([np.frombuffer(raw, dtype=dtype, count=ncomp,
                                   offset=start + i * stride)
                     for i in range(count)])


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], dtype=np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m = m @ np.diag([*node["scale"], 1.0])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        m4 = np.eye(4)
        m4[:3, :3] = [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
        m = m4 @ m
    if "translation" in node:
        t = np.eye(4)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _material_from_pbr(doc: dict, idx: Optional[int]
                       ) -> Tuple[Material, Optional[int]]:
    if idx is None or idx >= len(doc.get("materials", [])):
        return Material(color=(0.8, 0.8, 0.8), emission=(0, 0, 0),
                        metallic=0.0, roughness=1.0, transmission=0.0,
                        specular=0.5, specular_tint=0.0), None
    m = doc["materials"][idx]
    pbr = m.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1, 1, 1, 1])
    tex_info = pbr.get("baseColorTexture")
    tex_source = None
    if tex_info is not None and "textures" in doc:
        tex_source = doc["textures"][tex_info["index"]].get("source")
    return Material(
        color=tuple(base[:3]),
        emission=tuple(m.get("emissiveFactor", [0, 0, 0])),
        metallic=float(pbr.get("metallicFactor", 1.0)),
        roughness=float(np.clip(pbr.get("roughnessFactor", 1.0), 0.05, 1.0)),
        transmission=0.0,
        specular=0.5,
        specular_tint=0.0,
        eta=1.45,
    ), tex_source


def _load_images(doc: dict, bufs: List[bytes], base: str
                 ) -> List[Optional[np.ndarray]]:
    """Each image of the document as float32 (h, w, 3), y-flipped, or None
    where it cannot be read."""
    images: List[Optional[np.ndarray]] = []
    for img in doc.get("images", []):
        uri = img.get("uri", "")
        if uri and not uri.startswith("data:"):
            src = os.path.join(base, uri)
        elif "bufferView" in img:
            view = doc["bufferViews"][img["bufferView"]]
            start = view.get("byteOffset", 0)
            src = io.BytesIO(
                bufs[view["buffer"]][start: start + view["byteLength"]])
        elif uri:
            src = io.BytesIO(base64.b64decode(uri.split(",", 1)[1]))
        else:
            src = None
        images.append(None if src is None else load_texture(src))
    return images


def _read_glb(path: str) -> Tuple[dict, Optional[bytes]]:
    doc, glb_bin = None, None
    with open(path, "rb") as fh:
        magic, _version, _length = struct.unpack("<III", fh.read(12))
        if magic != 0x46546C67:
            raise ValueError(f"{path}: not a GLB file")
        while True:
            hdr = fh.read(8)
            if len(hdr) < 8:
                break
            clen, ctype = struct.unpack("<II", hdr)
            payload = fh.read(clen)
            if ctype == 0x4E4F534A:  # 'JSON'
                doc = json.loads(payload)
            elif ctype == 0x004E4942:  # 'BIN\0'
                glb_bin = payload
    if doc is None:
        raise ValueError(f"{path}: GLB without a JSON chunk")
    return doc, glb_bin


def load_gltf(path: str) -> Tuple[List[HostMesh], List[np.ndarray]]:
    """A .gltf/.glb file -> (world-space meshes, texture images): the
    instance table of ``load_gltf_instanced``, flattened."""
    scene = load_gltf_instanced(path)
    return scene.flatten(), scene.textures


def load_gltf_instanced(path: str) -> InstancedScene:
    """A .gltf/.glb file -> unique object-space meshes (one per triangle
    primitive of each glTF mesh, built once) and an instance per mesh node,
    with its world transform."""
    base = os.path.dirname(os.path.abspath(path))
    if path.lower().endswith(".glb"):
        doc, glb_bin = _read_glb(path)
    else:
        with open(path) as fh:
            doc, glb_bin = json.load(fh), None
    bufs = _load_buffers(doc, base, glb_bin)
    images = _load_images(doc, bufs, base)

    unique: List[HostMesh] = []
    instances: List[Instance] = []
    textures: List[np.ndarray] = []
    tex_remap: Dict[int, int] = {}
    mesh_cache: Dict[int, Tuple[int, ...]] = {}  # glTF mesh -> unique ids

    def build_unique(mesh_idx: int) -> Tuple[int, ...]:
        if mesh_idx in mesh_cache:
            return mesh_cache[mesh_idx]
        ids = []
        for prim in doc["meshes"][mesh_idx].get("primitives", []):
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            attrs = prim["attributes"]
            read = lambda k: _read_accessor(  # noqa: E731
                doc, bufs, attrs[k]).astype(np.float32)
            pos = read("POSITION")
            normal = read("NORMAL") if "NORMAL" in attrs else None
            texcoord = read("TEXCOORD_0") if "TEXCOORD_0" in attrs else None
            if "indices" in prim:
                idx = _read_accessor(doc, bufs, prim["indices"]).reshape(-1)
            else:
                idx = np.arange(len(pos))
            material, tex_source = _material_from_pbr(doc,
                                                      prim.get("material"))
            tex_id = -1
            if tex_source is not None and images[tex_source] is not None:
                if tex_source not in tex_remap:
                    tex_remap[tex_source] = len(textures)
                    textures.append(images[tex_source])
                tex_id = tex_remap[tex_source]
            ids.append(len(unique))
            unique.append(HostMesh(
                vertex=pos, index=idx.reshape(-1, 3).astype(np.int32),
                normal=normal, texcoord=texcoord, material=material,
                diffuse_texture_id=tex_id))
        mesh_cache[mesh_idx] = tuple(ids)
        return mesh_cache[mesh_idx]

    def walk(node_idx: int, parent: np.ndarray) -> None:
        node = doc["nodes"][node_idx]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            ids = build_unique(node["mesh"])
            if ids:
                instances.append(Instance(mesh_ids=ids, transform=world))
        for c in node.get("children", []):
            walk(c, world)

    scenes = doc.get("scenes",
                     [{"nodes": list(range(len(doc.get("nodes", []))))}])
    for r in scenes[doc.get("scene", 0)].get("nodes", []):
        walk(r, np.eye(4))
    if not instances:  # no scene graph: every mesh once, untransformed
        for i in range(len(doc.get("meshes", []))):
            ids = build_unique(i)
            if ids:
                instances.append(Instance(mesh_ids=ids, transform=np.eye(4)))
    return InstancedScene(unique=unique, instances=instances,
                          textures=textures)
