"""Environment probe lookup, pdf and alias-table sampling over a ray batch
(counterpart of the JAX package's ``ops/probe_sampling.py``; the alias-row
sampling path only). ``probe`` is a ``models.scene.DeviceProbe``."""

from __future__ import annotations

import torch

from fovpathtracing_optixcodelatest_tpu_torch.ops.sampling import PI, TWO_PI


def dir_to_uv(d: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit directions -> (..., 2) lat-long uv."""
    theta = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.where(
        (d[..., 0] == 0.0) & (d[..., 2] == 0.0),
        0.0,
        torch.atan2(d[..., 2], d[..., 0]),
    )
    u = (PI + phi) / TWO_PI
    v = theta / PI
    return torch.stack([u, v], dim=-1)


def uv_to_dir(uv: torch.Tensor) -> torch.Tensor:
    """(..., 2) uv -> (..., 3) unit directions."""
    theta = uv[..., 1] * PI
    phi = uv[..., 0] * TWO_PI
    sin_t = torch.sin(theta)
    return torch.stack(
        [-sin_t * torch.cos(phi), torch.cos(theta), -sin_t * torch.sin(phi)],
        dim=-1,
    )


def _texel(probe, uv):
    w, h = probe.width, probe.height
    px = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
    py = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
    return px, py


def probe_eval(probe, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-texel radiance with clamped indices."""
    px, py = _texel(probe, uv)
    return probe.data.reshape(-1, 3)[py * probe.width + px]


def probe_pdf(probe, d: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of sampling direction ``d``."""
    w, h = probe.width, probe.height
    uv = dir_to_uv(d)
    col, row = _texel(probe, uv)
    pdf = probe.pdf_x.reshape(-1)[row * w + col] * probe.pdf_y[row]
    sin_theta = torch.sin(uv[..., 1] * PI)
    small = sin_theta.abs() < 1e-4
    jac = w * h / (2.0 * PI * PI * torch.where(small, 1.0, sin_theta))
    return torch.where(small, 0.0, pdf * jac)


def probe_sample(probe, r1: torch.Tensor, r2: torch.Tensor):
    """Importance-sample the probe through the Walker alias rows: one
    (13,)-row gather per sample. Returns (dir (N, 3), color (N, 3),
    pdf (N,))."""
    w, h = probe.width, probe.height
    k = w * h
    cand = torch.clamp((r1 * k).to(torch.int64), max=k - 1)
    g = probe.sample_rows[cand]
    accept = r2 < g[:, 0]
    u = torch.where(accept, g[:, 1], g[:, 7])
    v = torch.where(accept, g[:, 2], g[:, 8])
    pdf = torch.where(accept, g[:, 3], g[:, 9])
    color = torch.where(accept[:, None], g[:, 4:7], g[:, 10:13])
    sin_theta = torch.sin(v * PI)
    zero = sin_theta == 0.0
    pdf = torch.where(
        zero, 0.0,
        pdf * w * h / (2.0 * PI * PI * torch.where(zero, 1.0, sin_theta)),
    )
    return uv_to_dir(torch.stack([u, v], dim=-1)), color, pdf
