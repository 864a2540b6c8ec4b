"""Procedural scenes (counterpart of the JAX package's ``models/scenes.py``;
same random draws in the same order, so the same seed gives the same
geometry, texcoords, texture ids and texture images)."""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera
from fovpathtracing_optixcodelatest_tpu_torch.models.material import Material
from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
    HostMesh,
    make_box,
    make_icosphere,
    make_quad,
)


def _matte(color, roughness=1.0) -> Material:
    """Diffuse-ish material with emission and transmission off."""
    return Material(
        color=color, emission=(0.0, 0.0, 0.0), metallic=0.0, specular=0.5,
        specular_tint=0.0, roughness=roughness, transmission=0.0, eta=1.4,
    )


def box_city(
    n: int = 12, seed: int = 0, spread: float = 40.0
) -> Tuple[List[HostMesh], Camera]:
    """An n x n grid of boxes of random height on a ground slab
    (n²·12 + 12 triangles)."""
    rng = np.random.default_rng(seed)
    meshes = [
        make_box((0, -1.0, 0), (spread, 1.0, spread), _matte((0.6, 0.6, 0.6)))
    ]
    cell = 2 * spread / n
    for i in range(n):
        for j in range(n):
            x = -spread + cell * (i + 0.5) + rng.uniform(-0.2, 0.2) * cell
            z = -spread + cell * (j + 0.5) + rng.uniform(-0.2, 0.2) * cell
            height = rng.uniform(1.0, 8.0)
            half = rng.uniform(0.25, 0.45) * cell
            color = tuple(rng.uniform(0.2, 0.9, 3))
            meshes.append(
                make_box((x, height - 1.0, z), (half, height, half),
                         _matte(color, roughness=rng.uniform(0.3, 1.0)))
            )
    cam = Camera(
        eye=(-spread * 1.2, spread * 0.45, spread * 1.2),
        lookat=(0.0, 0.0, 0.0),
        up=(0, 1, 0),
        fov_y=45.0,
        aspect=1.0,
    )
    return meshes, cam


def cornell(sphere_subdiv: int = 2) -> Tuple[List[HostMesh], Camera]:
    """Cornell-style box: white floor/ceiling/back, red/green walls, one
    glossy sphere, one box; lit by the environment through the open front
    (+z)."""
    s = 2.0
    white = (0.73, 0.73, 0.73)
    meshes = [
        make_quad((-s, -s, s), (s, -s, s), (s, -s, -s), (-s, -s, -s), _matte(white)),
        make_quad((-s, s, -s), (s, s, -s), (s, s, s), (-s, s, s), _matte(white)),
        make_quad((-s, -s, -s), (s, -s, -s), (s, s, -s), (-s, s, -s), _matte(white)),
        make_quad((-s, -s, s), (-s, -s, -s), (-s, s, -s), (-s, s, s),
                  _matte((0.65, 0.05, 0.05))),
        make_quad((s, -s, -s), (s, -s, s), (s, s, s), (s, s, -s),
                  _matte((0.12, 0.45, 0.15))),
        make_icosphere((-0.8, -1.2, -0.5), 0.8, sphere_subdiv,
                       Material(color=(0.9, 0.75, 0.4), emission=(0, 0, 0),
                                metallic=0.8, roughness=0.25, specular=1.0,
                                specular_tint=0.0, transmission=0.0, eta=1.5)),
        make_box((1.0, -1.3, 0.6), (0.55, 0.7, 0.55), _matte(white, roughness=0.6)),
    ]
    cam = Camera(eye=(0.0, 0.0, 7.5), lookat=(0.0, 0.0, 0.0), up=(0, 1, 0),
                 fov_y=40.0, aspect=1.0)
    return meshes, cam


def furnace_sphere(subdiv: int = 3) -> Tuple[List[HostMesh], Camera]:
    """One white diffuse sphere in an empty world (the white-furnace
    setup)."""
    mat = Material(
        color=(1.0, 1.0, 1.0), emission=(0, 0, 0), metallic=0.0, specular=0.0,
        specular_tint=0.0, roughness=1.0, transmission=0.0, eta=1.4,
        subsurface=0.0,
    )
    meshes = [make_icosphere((0, 0, 0), 1.0, subdiv, mat)]
    cam = Camera(eye=(0, 0, 4), lookat=(0, 0, 0), fov_y=45.0, aspect=1.0)
    return meshes, cam


def box_city_fast(
    n: int = 400, seed: int = 0, spread: float = 40.0, palette: int = 8
) -> Tuple[List[HostMesh], Camera]:
    """box_city for large triangle counts: the boxes of one palette color
    form one mesh, built with broadcast vertex math."""
    rng = np.random.default_rng(seed)
    cell = 2 * spread / n
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    x = (-spread + cell * (ii + 0.5) + rng.uniform(-0.2, 0.2, (n, n)) * cell).ravel()
    z = (-spread + cell * (jj + 0.5) + rng.uniform(-0.2, 0.2, (n, n)) * cell).ravel()
    height = rng.uniform(1.0, 8.0, n * n)
    half = rng.uniform(0.25, 0.45, n * n) * cell
    color_id = rng.integers(0, palette, n * n)
    colors = rng.uniform(0.2, 0.9, (palette, 3))

    unit = make_box((0, 0, 0), (1, 1, 1), _matte((1, 1, 1)))
    meshes = [
        make_box((0, -1.0, 0), (spread, 1.0, spread), _matte((0.6, 0.6, 0.6)))
    ]
    for c in range(palette):
        sel = np.nonzero(color_id == c)[0]
        if not len(sel):
            continue
        k = len(sel)
        ext = np.stack([half[sel], height[sel], half[sel]], axis=1)
        pos = np.stack([x[sel], height[sel] - 1.0, z[sel]], axis=1)
        verts = unit.vertex[None, :, :] * ext[:, None, :] + pos[:, None, :]
        normals = np.broadcast_to(unit.normal[None], (k, 36, 3))
        index = unit.index[None, :, :] + (np.arange(k) * 36)[:, None, None]
        meshes.append(
            HostMesh(
                vertex=verts.reshape(-1, 3).astype(np.float32),
                index=index.reshape(-1, 3).astype(np.int32),
                normal=normals.reshape(-1, 3).astype(np.float32),
                texcoord=np.zeros((k * 36, 2), dtype=np.float32),
                material=_matte(tuple(colors[c])),
            )
        )
    cam = Camera(
        eye=(-spread * 1.2, spread * 0.45, spread * 1.2),
        lookat=(0.0, 0.0, 0.0), up=(0, 1, 0), fov_y=45.0, aspect=1.0,
    )
    return meshes, cam


def _procedural_texture(hue: np.ndarray, kind: int, res: int = 256) -> np.ndarray:
    """Deterministic (res, res, 3) float32 texture: 0 = brick courses,
    1 = checker, 2 = speckle noise."""
    v = np.linspace(0.0, 1.0, res, endpoint=False)
    uu, vv = np.meshgrid(v, v, indexing="xy")
    if kind == 0:
        row = np.floor(vv * 8.0)
        uo = uu + 0.5 * (row % 2)
        mortar = ((vv * 8.0) % 1.0 < 0.08) | ((uo * 4.0) % 1.0 < 0.05)
        base = np.where(mortar, 0.35, 1.0)
    elif kind == 1:
        base = 0.45 + 0.55 * ((np.floor(uu * 8.0) + np.floor(vv * 8.0)) % 2)
    else:
        g = np.sin((np.floor(uu * 64) * 127.1 + np.floor(vv * 64) * 311.7))
        base = 0.6 + 0.4 * ((g * 43758.5453) % 1.0)
    return (base[:, :, None] * hue[None, None, :]).astype(np.float32)


def box_city_textured(
    n: int = 24, seed: int = 0, spread: float = 40.0, palette: int = 8
) -> Tuple[List[HostMesh], Camera, List[np.ndarray]]:
    """box_city with per-face UV-mapped procedural textures: the same
    geometry as ``box_city(n, seed, spread)``, each face spanning [0, tile]²
    of its mesh's texture (tile 4 on the ground, 2 on the boxes, so the
    bilinear-wrap path wraps). Returns (meshes, camera, images) for
    ``build_scene(texture_images=...)``."""
    meshes, cam = box_city(n=n, seed=seed, spread=spread)
    rng = np.random.default_rng(seed + 7)
    hues = rng.uniform(0.4, 1.0, (palette, 3)).astype(np.float32)
    images = [_procedural_texture(hues[k], kind=k % 3) for k in range(palette)]
    face_uv = np.asarray(
        [[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]], dtype=np.float32
    )
    out = []
    for i, m in enumerate(meshes):
        tile = 4.0 if i == 0 else 2.0
        tc = np.tile(face_uv, (m.vertex.shape[0] // 6, 1)) * tile
        out.append(dataclasses.replace(
            m, texcoord=tc.astype(np.float32),
            diffuse_texture_id=int(rng.integers(0, palette)),
        ))
    return out, cam, images
