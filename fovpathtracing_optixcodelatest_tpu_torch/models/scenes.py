"""Procedural scenes (counterpart of the JAX package's ``models/scenes.py``;
same random draws in the same order, so the same seed gives the same
geometry)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera
from fovpathtracing_optixcodelatest_tpu_torch.models.material import Material
from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import HostMesh, make_box


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
