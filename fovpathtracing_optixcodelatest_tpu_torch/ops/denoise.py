"""Edge-aware à-trous denoiser over the renderer's normal and albedo AOVs
(counterpart of the JAX package's ``ops/denoise.py``).

Per iteration i the 5x5 B3-spline kernel's taps are spread 2^i pixels
apart; each tap's weight is the spline weight times edge-stopping terms
exp(-|Δ|² / σ²) of the color, normal and albedo differences. Taps past the
border repeat the edge pixel. Plain tensor code: 25 shifted gathers a pass.
"""

from __future__ import annotations

import torch

# B3-spline 5-tap weights
_W = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _shift2(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped 2-D shift of (H, W, C): out[y, x] = x[y + dy, x + dx]."""
    h, w = x.shape[:2]
    ys = torch.clamp(torch.arange(h, device=x.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=x.device) + dx, 0, w - 1)
    return x[ys][:, xs]


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the 3 channels of (a - b)², left to right."""
    e = (a - b) ** 2
    return ((e[..., 0] + e[..., 1]) + e[..., 2])[..., None]


def atrous_denoise(color: torch.Tensor, normal: torch.Tensor,
                   albedo: torch.Tensor, iterations: int = 3,
                   sigma_color: float = 0.35, sigma_normal: float = 0.25,
                   sigma_albedo: float = 0.15) -> torch.Tensor:
    """À-trous cross-bilateral filter of (H, W, 3) linear color guided by
    (H, W, 3) normal and albedo -> the filtered (H, W, 3) image."""
    out = color
    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(out)
        wsum = torch.zeros(out.shape[:2] + (1,), dtype=out.dtype,
                           device=out.device)
        for iy, wy in enumerate(_W):
            for ix, wx in enumerate(_W):
                dy, dx = (iy - 2) * step, (ix - 2) * step
                c = _shift2(out, dy, dx)
                w = ((wy * wx)
                     * torch.exp(-_sq_dist(c, out) / (sigma_color ** 2))
                     * torch.exp(-_sq_dist(_shift2(normal, dy, dx), normal)
                                 / (sigma_normal ** 2))
                     * torch.exp(-_sq_dist(_shift2(albedo, dy, dx), albedo)
                                 / (sigma_albedo ** 2)))
                acc = acc + w * c
                wsum = wsum + w
        out = acc / torch.clamp(wsum, min=1e-8)
    return out
