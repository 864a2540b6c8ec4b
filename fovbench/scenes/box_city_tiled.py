"""``box_city_tiled``: one ``box_city_fast`` block (the same random draws,
textures and palette) placed on a ``tiles`` x ``tiles`` grid of pitch
2 * spread, the blocks' ground slabs edge to edge, each placement a
translation and a turn by a multiple of 90 degrees about the up axis drawn
from the seed. The block's meshes are returned once, in object space, with
an instance table (``fovbench/instances.py``): one instance a tile, naming
every mesh of the block. World triangles: tiles^2 (12 n^2 + 12), from
12 n^2 + 12 unique ones. The camera frames the whole field as
``box_city_fast``'s frames one block; one tile that draws no turn is
``box_city_fast``'s scene.
"""

from __future__ import annotations

import numpy as np

from fovbench.scenes import box_city_fast

TURN_SEED = 11  # the turns' generator is seeded seed + TURN_SEED


def turn_y(quarters: int) -> np.ndarray:
    """4x4 turn by ``quarters`` x 90 degrees about +y, its entries exactly
    0 and +-1."""
    c, s = ((1, 0), (0, 1), (-1, 0), (0, -1))[quarters % 4]
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0],
                     [0, 0, 0, 1]], dtype=np.float64)


def generate(n: int, tiles: int, seed: int = 0, spread: float = 40.0,
             palette: int = 8, texture_size: int | None = None):
    """-> (the block's meshes, camera dict (eye, lookat, up, fov_y), texture
    images, instance table)."""
    meshes, _, images = box_city_fast.generate(n, seed, spread, palette,
                                               texture_size)
    count = tiles * tiles
    quarters = np.random.default_rng(seed + TURN_SEED).integers(0, 4, count)
    offsets = (np.arange(tiles) - 0.5 * (tiles - 1)) * (2.0 * spread)
    instances = []
    for k in range(count):
        m = turn_y(int(quarters[k]))
        m[0, 3], m[2, 3] = offsets[k // tiles], offsets[k % tiles]
        instances.append({"mesh_ids": list(range(len(meshes))),
                          "transform": m})
    half = spread * tiles
    camera = {"eye": (-half * 1.2, half * 0.45, half * 1.2),
              "lookat": (0.0, 0.0, 0.0), "up": (0.0, 1.0, 0.0), "fov_y": 45.0}
    return meshes, camera, images, instances
