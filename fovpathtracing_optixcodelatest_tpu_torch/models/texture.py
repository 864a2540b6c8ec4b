"""Texture storage and bilinear-wrap sampling (counterpart of the JAX
package's ``models/texture.py``).

All textures live in one padded (K, H, W, 3) float32 tensor with each
texture's true (width, height). ``sample_bilinear_wrap`` follows CUDA's
normalized-coordinate linear filtering with wrap addressing: the sample
point is (u*w - 0.5, v*h - 0.5), the four taps are wrapped by floor-mod and
lerped in x, then in y. It reads the four taps from ``data`` directly; the
JAX package's quad rows pack the same four texels into one row, so both
give the same texel values and the same lerp.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TextureArray:
    data: torch.Tensor  # (K, H, W, 3) float32, linear [0, 1]
    sizes: torch.Tensor  # (K, 2) int64: (width, height) of each texture

    @property
    def num_textures(self) -> int:
        return self.data.shape[0]


def texture_arrays(images: Sequence[np.ndarray]):
    """Pad (h, w, 3) images to a common (H, W) -> (data (K, H, W, 3)
    float32, sizes (K, 2) int32). No images give one 1x1 magenta texture,
    as in the JAX package."""
    images = list(images)
    if not images:
        images = [np.full((1, 1, 3), [1.0, 0.0, 1.0], dtype=np.float32)]
    max_h = max(im.shape[0] for im in images)
    max_w = max(im.shape[1] for im in images)
    data = np.zeros((len(images), max_h, max_w, 3), dtype=np.float32)
    sizes = np.zeros((len(images), 2), dtype=np.int32)
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        data[i, :h, :w, :] = im[..., :3]
        sizes[i] = (w, h)
    return data, sizes


def build_texture_array(images: Sequence[np.ndarray],
                        device="cuda") -> TextureArray:
    """Pack images into a padded TextureArray on ``device``."""
    data, sizes = texture_arrays(images)
    return TextureArray(
        data=torch.tensor(data, device=device),
        sizes=torch.tensor(sizes, dtype=torch.int64, device=device),
    )


def hit_uv(attr: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Texture coordinates of hits: the barycentric blend (1-u-v, u, v) of
    the corner uvs in ``tri_pack`` rows ``attr`` (cols 3:9) -> (N, 2)."""
    bu, bv = u[:, None], v[:, None]
    return (1.0 - bu - bv) * attr[:, 3:5] + bu * attr[:, 5:7] \
        + bv * attr[:, 7:9]


def sample_bilinear_wrap(tex: TextureArray, tex_ids: torch.Tensor,
                         uv: torch.Tensor) -> torch.Tensor:
    """(N,) texture ids and (N, 2) uv -> (N, 3) bilinear samples with wrap
    addressing. Ids outside [0, K) are clamped (callers mask on id >= 0)."""
    ids = torch.clamp(tex_ids.to(torch.int64), 0, tex.num_textures - 1)
    wh = tex.sizes[ids]
    wi, hi = wh[:, 0], wh[:, 1]
    x = uv[:, 0] * wi.to(torch.float32) - 0.5
    y = uv[:, 1] * hi.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    # floor-mod: uv below 0 occurs (tiled faces wrap both ways)
    xa, xb = torch.remainder(x0i, wi), torch.remainder(x0i + 1, wi)
    ya, yb = torch.remainder(y0i, hi), torch.remainder(y0i + 1, hi)
    kh, kw = tex.data.shape[1], tex.data.shape[2]
    flat = tex.data.reshape(-1, 3)
    row = ids * kh

    def fetch(yy, xx):
        return flat[(row + yy) * kw + xx]

    c00, c10 = fetch(ya, xa), fetch(ya, xb)
    c01, c11 = fetch(yb, xa), fetch(yb, xb)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def checkerboard(size: int = 64, squares: int = 8,
                 c0=(0.8, 0.8, 0.8), c1=(0.1, 0.1, 0.4)) -> np.ndarray:
    """Procedural (size, size, 3) float32 test texture."""
    yy, xx = np.mgrid[0:size, 0:size]
    mask = ((xx * squares // size) + (yy * squares // size)) % 2
    img = np.where(mask[..., None] == 0, np.asarray(c0), np.asarray(c1))
    return img.astype(np.float32)
