"""The PyTorch port's glTF loader against the JAX package's on generated
``.gltf`` and ``.glb`` files: the same unique meshes (vertices, indices,
normals, uvs, materials, texture ids), instance tables (mesh ids and
transforms), textures and flattened meshes, all exact (both loaders run the
same numpy arithmetic and decode images with Pillow); and a loaded scene
renders through the port's two-level table."""

import base64
import dataclasses
import io
import json
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from fovpathtracing_optixcodelatest_tpu.models import gltf_loader as jgltf
from fovpathtracing_optixcodelatest_tpu_torch.models import gltf_loader as pgltf
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
    build_scene,
    build_scene_instanced,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse
from test_gltf import _tri_gltf_doc

torch.set_num_threads(2)


def _png(seed, w=5, h=3):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def _textured_doc(tmp_path, embed: str):
    """The JAX test's triangle document with two textured materials (one
    image embedded as ``embed`` = "uri" or "view", one an external file), a
    two-level node hierarchy (rotation, scale, matrix) and a mesh shared by
    three nodes."""
    doc, blob = _tri_gltf_doc()
    png0, png1 = _png(0), _png(1, 7, 4)
    (tmp_path / "ext.png").write_bytes(png1)
    images = [{"uri": "ext.png"}]
    if embed == "uri":
        images.append({"uri": "data:image/png;base64,"
                              + base64.b64encode(png0).decode()})
    else:
        pad = b"\x00" * ((4 - len(blob) % 4) % 4)
        doc["bufferViews"].append({"buffer": 0,
                                   "byteOffset": len(blob) + len(pad),
                                   "byteLength": len(png0)})
        blob = blob + pad + png0
        images.append({"bufferView": len(doc["bufferViews"]) - 1,
                       "mimeType": "image/png"})
    doc["images"] = images
    doc["textures"] = [{"source": 1}, {"source": 0}]
    doc["materials"].append({"pbrMetallicRoughness": {
        "baseColorFactor": [0.2, 0.4, 0.6, 1.0],
        "baseColorTexture": {"index": 1}, "roughnessFactor": 0.01}})
    doc["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = {
        "index": 0}
    prim = doc["meshes"][0]["primitives"][0]
    doc["meshes"].append({"primitives": [dict(prim, material=1),
                                         dict(prim, material=0)]})
    m = np.eye(4)
    m[:3, 3] = (0.5, -1.0, 2.0)
    m[0, 1] = 0.3
    doc["nodes"] = [
        {"rotation": [0.0, 0.3826834, 0.0, 0.9238795], "children": [1, 2]},
        {"mesh": 0, "translation": [2.0, 0.0, 0.0]},
        {"mesh": 1, "scale": [2.0, 2.0, 2.0], "children": [3]},
        {"mesh": 0, "matrix": m.T.reshape(-1).tolist()},
    ]
    doc["scenes"] = [{"nodes": [0]}]
    doc["buffers"][0]["byteLength"] = len(blob)
    return doc, blob


def _write(tmp_path, doc, blob, kind):
    if kind == "gltf":
        doc = json.loads(json.dumps(doc))
        doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                    + base64.b64encode(blob).decode())
        p = tmp_path / "t.gltf"
        p.write_text(json.dumps(doc))
        return str(p)
    json_bytes = json.dumps(doc).encode()
    json_bytes += b" " * ((4 - len(json_bytes) % 4) % 4)
    bin_bytes = blob + b"\x00" * ((4 - len(blob) % 4) % 4)
    p = tmp_path / "t.glb"
    with open(p, "wb") as fh:
        fh.write(struct.pack("<III", 0x46546C67, 2,
                             28 + len(json_bytes) + len(bin_bytes)))
        fh.write(struct.pack("<II", len(json_bytes), 0x4E4F534A))
        fh.write(json_bytes)
        fh.write(struct.pack("<II", len(bin_bytes), 0x004E4942))
        fh.write(bin_bytes)
    return str(p)


def _same_meshes(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        for f in ("vertex", "index", "normal", "texcoord"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert dataclasses.asdict(a.material) == dataclasses.asdict(
            b.material)
        assert a.diffuse_texture_id == b.diffuse_texture_id


@pytest.mark.parametrize("kind,embed", [("gltf", "uri"), ("glb", "view"),
                                        ("glb", "uri")])
def test_loaders_match_jax(tmp_path, kind, embed):
    doc, blob = _textured_doc(tmp_path, embed)
    path = _write(tmp_path, doc, blob, kind)
    want = jgltf.load_gltf_instanced(path)
    got = pgltf.load_gltf_instanced(path)
    _same_meshes(want.unique, got.unique)
    assert len(got.unique) == 3 and len(got.instances) == 3
    for a, b in zip(want.instances, got.instances):
        assert a.mesh_ids == b.mesh_ids
        assert np.array_equal(a.transform, b.transform)
    assert len(got.textures) == len(want.textures) == 2
    for a, b in zip(want.textures, got.textures):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    assert {m.diffuse_texture_id for m in got.unique} == {0, 1}
    # the flattened scene and textures of load_gltf
    wm, wt = jgltf.load_gltf(path)
    gm, gt = pgltf.load_gltf(path)
    _same_meshes(wm, gm)
    assert all(np.array_equal(a, b) for a, b in zip(wt, gt))


@pytest.mark.parametrize("kind", ["gltf", "glb"])
def test_untextured_documents_match_jax(tmp_path, kind):
    # the JAX tests' own document, and its three-instance variant
    doc, blob = _tri_gltf_doc()
    for nodes in ([{"mesh": 0, "translation": [2.0, 0.0, 0.0]}],
                  [{"mesh": 0}, {"mesh": 0, "translation": [5.0, 0.0, 0.0]},
                   {"mesh": 0, "scale": [2.0, 2.0, 2.0],
                    "translation": [0.0, 7.0, 0.0]}]):
        doc["nodes"] = nodes
        doc["scenes"] = [{"nodes": list(range(len(nodes)))}]
        path = _write(tmp_path, doc, blob, kind)
        want, got = jgltf.load_gltf_instanced(path), \
            pgltf.load_gltf_instanced(path)
        _same_meshes(want.unique, got.unique)
        _same_meshes(want.flatten(), got.flatten())
        assert got.textures == [] and len(got.instances) == len(nodes)
        assert got.num_world_triangles == len(nodes)


def test_loaded_scene_renders_instanced(tmp_path):
    doc, blob = _tri_gltf_doc()
    doc["nodes"] = [{"mesh": 0}, {"mesh": 0, "translation": [3.0, 0.0, 0.0]}]
    doc["scenes"] = [{"nodes": [0, 1]}]
    sc = pgltf.load_gltf_instanced(_write(tmp_path, doc, blob, "gltf"))
    scene = build_scene_instanced(sc, device="cpu")
    flat = build_scene(sc.flatten(), device="cpu")
    assert scene.bvh.num_instances == 2 and scene.num_triangles == 1
    o = torch.tensor([[0.3, 0.3, 2.0], [3.3, 0.3, 2.0], [6.3, 0.3, 2.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]] * 3)
    act = torch.ones(3, dtype=torch.bool)
    b = scene.bvh
    out = traverse.closest_hit(b.table, o, d, act, 1e-3, 1e9, *b.walk_args,
                               **b.instance_kwargs)
    assert out["hit"].tolist() == [True, True, False]
    assert out["inst"].tolist() == [0, 1, -1]
    fo = traverse.closest_hit(flat.bvh.table, o, d, act, 1e-3, 1e9,
                              *flat.bvh.walk_args)
    assert torch.equal(out["t"], fo["t"])
