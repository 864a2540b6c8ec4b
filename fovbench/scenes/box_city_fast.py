"""``box_city_fast``: an n x n grid of boxes of random height on a ground
slab, the boxes of one palette color in one mesh (12 n^2 + 12 triangles).
A frozen copy of the port's ``models/scenes.py`` ``box_city_fast`` (the same
random draws in the same order), with the per-face texture mapping of its
``box_city_textured`` when ``texture_size`` is given: each face spans
[0, tile]^2 of its mesh's texture, tile 4 on the ground and 2 on the boxes.

Meshes are plain dicts of numpy arrays (``vertex``, ``index``, ``normal``,
``texcoord``, ``material``, ``texture_id``); ``material`` names every field
of the port's Disney material.
"""

from __future__ import annotations

import numpy as np

# the port's Material defaults, overridden by ``matte``
MATERIAL_DEFAULTS = {
    "color": (1.0, 0.0, 0.0), "emission": (1.0, 1.0, 1.0),
    "absorption": (1.0, 1.0, 1.0), "eta": 1.4, "metallic": 0.5,
    "subsurface": 0.0, "specular": 1.0, "roughness": 1.0,
    "specular_tint": 1.0, "anisotropic": 0.0, "sheen": 0.0,
    "sheen_tint": 0.0, "clearcoat": 0.0, "clearcoat_gloss": 1.0,
    "transmission": 0.4, "bump": 0.0, "flags": 0,
}


def matte(color, roughness: float = 1.0) -> dict:
    """Diffuse-ish material with emission and transmission off."""
    return dict(MATERIAL_DEFAULTS, color=tuple(float(c) for c in color),
                emission=(0.0, 0.0, 0.0), metallic=0.0, specular=0.5,
                specular_tint=0.0, roughness=float(roughness),
                transmission=0.0, eta=1.4)


def box(pos, extent, material: dict) -> dict:
    """Axis-aligned box: 12 triangles over 36 unshared vertices, per-face
    normals, six vertices a face."""
    px, py, pz = pos
    ex, ey, ez = extent
    a = (-ex + px, -ey + py, ez + pz)
    b = (ex + px, -ey + py, ez + pz)
    c = (ex + px, ey + py, ez + pz)
    d = (-ex + px, ey + py, ez + pz)
    e = (-ex + px, -ey + py, -ez + pz)
    f = (ex + px, -ey + py, -ez + pz)
    g = (ex + px, ey + py, -ez + pz)
    h = (-ex + px, ey + py, -ez + pz)
    verts = [a, b, c, a, c, d, e, h, g, e, g, f, e, a, d, e, d, h,
             b, f, g, b, g, c, d, c, g, d, g, h, e, a, b, e, b, f]
    face_normals = [(0, 0, 1), (0, 0, -1), (-1, 0, 0), (1, 0, 0), (0, 1, 0),
                    (0, -1, 0)]
    return {
        "vertex": np.asarray(verts, dtype=np.float32),
        "index": np.arange(36, dtype=np.int32).reshape(12, 3),
        "normal": np.repeat(np.asarray(face_normals, dtype=np.float32), 6,
                            axis=0),
        "texcoord": np.zeros((36, 2), dtype=np.float32),
        "material": material,
        "texture_id": -1,
    }


def procedural_texture(hue: np.ndarray, kind: int, res: int) -> np.ndarray:
    """(res, res, 3) float32: 0 = brick courses, 1 = checker, 2 = speckle."""
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


def generate(n: int, seed: int = 0, spread: float = 40.0, palette: int = 8,
             texture_size: int | None = None):
    """-> (meshes, camera dict (eye, lookat, up, fov_y), texture images)."""
    rng = np.random.default_rng(seed)
    cell = 2 * spread / n
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    x = (-spread + cell * (ii + 0.5)
         + rng.uniform(-0.2, 0.2, (n, n)) * cell).ravel()
    z = (-spread + cell * (jj + 0.5)
         + rng.uniform(-0.2, 0.2, (n, n)) * cell).ravel()
    height = rng.uniform(1.0, 8.0, n * n)
    half = rng.uniform(0.25, 0.45, n * n) * cell
    color_id = rng.integers(0, palette, n * n)
    colors = rng.uniform(0.2, 0.9, (palette, 3))

    unit = box((0, 0, 0), (1, 1, 1), matte((1, 1, 1)))
    meshes = [box((0, -1.0, 0), (spread, 1.0, spread), matte((0.6, 0.6, 0.6)))]
    for c in range(palette):
        sel = np.nonzero(color_id == c)[0]
        if not len(sel):
            continue
        k = len(sel)
        ext = np.stack([half[sel], height[sel], half[sel]], axis=1)
        pos = np.stack([x[sel], height[sel] - 1.0, z[sel]], axis=1)
        verts = unit["vertex"][None, :, :] * ext[:, None, :] + pos[:, None, :]
        normals = np.broadcast_to(unit["normal"][None], (k, 36, 3))
        index = unit["index"][None, :, :] + (np.arange(k) * 36)[:, None, None]
        meshes.append({
            "vertex": verts.reshape(-1, 3).astype(np.float32),
            "index": index.reshape(-1, 3).astype(np.int32),
            "normal": normals.reshape(-1, 3).astype(np.float32),
            "texcoord": np.zeros((k * 36, 2), dtype=np.float32),
            "material": matte(tuple(colors[c])),
            "texture_id": -1,
        })
    camera = {"eye": (-spread * 1.2, spread * 0.45, spread * 1.2),
              "lookat": (0.0, 0.0, 0.0), "up": (0.0, 1.0, 0.0), "fov_y": 45.0}
    images = []
    if texture_size:
        trng = np.random.default_rng(seed + 7)
        hues = trng.uniform(0.4, 1.0, (palette, 3)).astype(np.float32)
        images = [procedural_texture(hues[k], k % 3, texture_size)
                  for k in range(palette)]
        face_uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]],
                             dtype=np.float32)
        for i, m in enumerate(meshes):
            tile = 4.0 if i == 0 else 2.0
            m["texcoord"] = (np.tile(face_uv, (m["vertex"].shape[0] // 6, 1))
                             * tile).astype(np.float32)
            m["texture_id"] = int(trng.integers(0, palette))
    return meshes, camera, images
