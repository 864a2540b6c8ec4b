"""Simple renderers, the tutorial-ladder checkpoints (counterpart of the
JAX package's ``render/simple.py``):

- ``solid_color``: 01HelloRaytracing, one colour for every pixel;
- ``test_pattern``: 02/03HelloRaytracing, a pattern from the pixel index;
- ``raycast``: 04HelloRaytracing, one primary ray a pixel (K1), the shading
  normal with a geometric-normal faceforward, the diffuse colour times the
  texture, one shadow ray toward a point light over the [0, 1] extent of
  the light vector, walked by K2 without back-face culling, and the shading
  ``(.1 + (.2 + .8 vis) cosDN) diffuse`` with ``cosDN = .1 + .8
  |dot(dir, Ns)|``; misses are black.

``raycast`` reads the scene's corner shading normals: build its scene with
``build_scene(..., shading_normals=True)``, or a render-time-instanced
one with ``build_scene_instanced(..., shading_normals=True)`` (its walks
then launch the two-level K1 and the two-level K2's non-culling
instantiation). On an instanced scene the normals are the unique meshes'
in object space, the instance's transform not applied, as the JAX
package's raycast shades them.
"""

from __future__ import annotations

import torch

from fovpathtracing_optixcodelatest_tpu_torch.models.material import view_rows
from fovpathtracing_optixcodelatest_tpu_torch.models.texture import (
    hit_uv,
    sample_bilinear_wrap,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse
from fovpathtracing_optixcodelatest_tpu_torch.ops.sampling import (
    cross,
    dot,
    normalize,
)


def _to_u8(frame: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(frame, 0.0, 1.0) * 255.99).to(torch.uint8)


def solid_color(width: int, height: int, color=(0.0, 0.3, 0.8),
                device="cuda") -> torch.Tensor:
    """A (height, width, 3) uint8 frame of one colour."""
    c = torch.tensor(color, dtype=torch.float32, device=device)
    return _to_u8(c.expand(height, width, 3))


def test_pattern(width: int, height: int, device="cuda") -> torch.Tensor:
    """A (height, width, 3) uint8 pattern: an 8-pixel checker in red, x and
    y ramps in green and blue."""
    x = torch.arange(width, device=device)[None, :, None]
    y = torch.arange(height, device=device)[:, None, None]
    r = ((x // 8) % 2) ^ ((y // 8) % 2)
    g = (x % 256) / 255.0
    b = (y % 256) / 255.0
    frame = torch.cat([r.to(torch.float32), g.expand(r.shape).float(),
                       b.expand(r.shape).float()], dim=-1)
    return _to_u8(frame)


def _primary_hits(scene, camera, width: int, height: int):
    """Pixel-centre rays dir = normalize(W + (sx - .5) U + (sy - .5) V),
    screen coordinates in [0, 1]^2, and their closest hits (K1)."""
    dev = scene.device
    x = torch.arange(width, dtype=torch.float32, device=dev)
    y = torch.arange(height, dtype=torch.float32, device=dev)
    gx, gy = torch.meshgrid(x, y, indexing="xy")
    sx = ((gx + 0.5) / width).reshape(-1)
    sy = ((gy + 0.5) / height).reshape(-1)
    direction = normalize(camera.w[None, :] + (sx - 0.5)[:, None]
                          * camera.u[None, :] + (sy - 0.5)[:, None]
                          * camera.v[None, :]).contiguous()
    origin = camera.eye[None, :].expand(direction.shape).contiguous()
    every = torch.ones((direction.shape[0],), dtype=torch.bool, device=dev)
    bvh = scene.bvh
    hit = traverse.closest_hit(bvh.table, origin, direction, every, 0.0,
                               1e20, *bvh.walk_args, **bvh.instance_kwargs)
    attr = scene.tri_pack[torch.clamp(hit["tri_id"], min=0).to(torch.int64)]
    # the geometric normal, faceforward
    n = cross(attr[:, 39:42], attr[:, 42:45])
    ng = n * torch.rsqrt(torch.clamp(dot(n, n), min=1e-20))[:, None]
    ng = torch.where(dot(direction, ng)[:, None] > 0.0, -ng, ng)
    return origin, direction, hit, attr, ng


def shadow_rays(scene, camera, width: int, height: int,
                light_pos=(-907.108, 2205.875, -400.0267)):
    """The 04 raycast's shadow rays -> (origin, direction, query): from
    each hit, nudged 1e-3 along the faceforward geometric normal, toward
    the point light, walked over t in [1e-3, 1 - 1e-3] where the primary
    ray hit."""
    origin, direction, hit, _, ng = _primary_hits(scene, camera, width,
                                                  height)
    return _shadow(scene, origin, direction, hit, ng, light_pos)


def _shadow(scene, origin, direction, hit, ng, light_pos):
    p = origin + hit["t"][:, None] * direction
    light = torch.tensor(light_pos, dtype=torch.float32, device=scene.device)
    return ((p + 1e-3 * ng).contiguous(), (light[None, :] - p).contiguous(),
            hit["hit"])


def raycast(scene, camera, width: int, height: int,
            light_pos=(-907.108, 2205.875, -400.0267)) -> torch.Tensor:
    """The 04 raycast of ``scene`` through ``camera`` (``CameraParams``) ->
    (height, width, 3) uint8."""
    if scene.shading_normals is None:
        raise ValueError("raycast needs the scene's shading normals: "
                         "build_scene(..., shading_normals=True) or "
                         "build_scene_instanced(..., shading_normals=True)")
    origin, direction, hit, attr, ng = _primary_hits(scene, camera, width,
                                                     height)
    hm = hit["hit"]
    tri = torch.clamp(hit["tri_id"], min=0).to(torch.int64)

    # the shading normal, flipped to agree with the geometric one
    sn = scene.shading_normals[tri]
    bu, bv = hit["u"][:, None], hit["v"][:, None]
    ns_raw = (1.0 - bu - bv) * sn[:, 0:3] + bu * sn[:, 3:6] + bv * sn[:, 6:9]
    ns = torch.where((sn[:, 9] > 0.0)[:, None], ns_raw, ng)
    ns = torch.where(dot(ng, ns)[:, None] < 0.0,
                     ns - 2.0 * dot(ng, ns)[:, None] * ng, ns)
    ns = normalize(ns)

    # diffuse colour times the texture
    color = view_rows(attr[:, 12:36]).color
    if scene.has_textures:
        tex_id = attr[:, 10].contiguous().view(torch.int32)
        tex = sample_bilinear_wrap(scene.textures, tex_id,
                                   hit_uv(attr, hit["u"], hit["v"]))
        color = color * torch.where((tex_id >= 0)[:, None], tex, 1.0)

    # the shadow ray toward the point light, back faces not culled
    so, sd, query = _shadow(scene, origin, direction, hit, ng, light_pos)
    bvh = scene.bvh
    occ = traverse.occluded(bvh.table, so, sd, query, 1e-3, 1.0 - 1e-3,
                            *bvh.walk_args, cull_backface=False,
                            **bvh.instance_kwargs)
    visibility = torch.where(occ, 0.0, 1.0)

    cos_dn = 0.1 + 0.8 * dot(direction, ns).abs()
    shade = (0.1 + (0.2 + 0.8 * visibility) * cos_dn)[:, None] * color
    shade = torch.where(hm[:, None], shade, 0.0)
    return _to_u8(shade.reshape(height, width, 3))
