"""Environment probe lookup, pdf and alias-table sampling over a ray batch
(counterpart of the JAX package's ``ops/probe_sampling.py``: the Walker alias
sampling through the 13-column rows, or through the per-field alias arrays
on probes too large for the rows). ``probe`` is a
``models.scene.DeviceProbe``, but for ``probe_sample_cdf``, the reference's
two-level CDF inversion kept as the alias table's distribution oracle,
which reads the host ``models.probe.ProbeParams``."""

from __future__ import annotations

import math

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
    """Importance-sample the probe through the Walker alias table: one
    (13,)-row gather per sample, or, on a probe without sample rows, the
    alias probability, the alias index, then the chosen texel's color and
    pdf. Returns (dir (N, 3), color (N, 3), pdf (N,))."""
    w, h = probe.width, probe.height
    k = w * h
    cand = torch.clamp((r1 * k).to(torch.int64), max=k - 1)
    if probe.sample_rows is not None:
        g = probe.sample_rows[cand]
        accept = r2 < g[:, 0]
        u = torch.where(accept, g[:, 1], g[:, 7])
        v = torch.where(accept, g[:, 2], g[:, 8])
        pdf = torch.where(accept, g[:, 3], g[:, 9])
        color = torch.where(accept[:, None], g[:, 4:7], g[:, 10:13])
    else:
        accept = r2 < probe.alias_prob[cand]
        lin = torch.where(accept, cand, probe.alias_idx[cand])
        row = lin // w
        col = lin - row * w
        color = probe.data.reshape(-1, 3)[lin]
        pdf = probe.pdf_flat[lin]
        u = col.to(torch.float32) / w
        v = row.to(torch.float32) / h
    sin_theta = torch.sin(v * PI)
    zero = sin_theta == 0.0
    pdf = torch.where(
        zero, 0.0,
        pdf * w * h / (2.0 * PI * PI * torch.where(zero, 1.0, sin_theta)),
    )
    return uv_to_dir(torch.stack([u, v], dim=-1)), color, pdf


def _lower_bound_rows(cdf_flat: torch.Tensor, row: torch.Tensor, width: int,
                      values: torch.Tensor) -> torch.Tensor:
    """Batched lower bound over per-ray rows of a flattened (H*W,) CDF: the
    column in [0, width] of the first entry of row ``row`` >= ``value``.
    A branchless binary search of ``ceil(log2 width) + 1`` gather steps."""
    base = row.long() * width
    lo = torch.zeros_like(base)
    hi = torch.full_like(lo, width)
    steps = max(1, math.ceil(math.log2(width)) if width > 1 else 1)
    for _ in range(steps + 1):
        mid = lo + (hi - lo) // 2
        go_right = cdf_flat[base + mid.clamp(max=width - 1)] < values
        open_ = lo < hi
        lo, hi = (torch.where(go_right & open_, mid + 1, lo),
                  torch.where(~go_right & open_, mid, hi))
    return lo


def cdf_texel(probe, r1: torch.Tensor, r2: torch.Tensor):
    """The texel (row, col) the reference's two-level CDF inversion picks
    for uniforms ``r1`` (row) and ``r2`` (column): the row from the
    marginal CDF (``searchsorted``, left side), then the column from the
    row's conditional CDF. ``probe`` is the host ``ProbeParams``; its CDFs
    go to the uniforms' device."""
    w, h = probe.width, probe.height
    cdf_y = torch.as_tensor(probe.cdf_y, device=r1.device)
    cdf_x = torch.as_tensor(probe.cdf_x, device=r1.device)
    row = torch.clamp(torch.searchsorted(cdf_y, r1, right=False), 0, h - 1)
    col = torch.clamp(_lower_bound_rows(cdf_x.reshape(-1), row, w, r2), 0,
                      w - 1)
    return row, col


def probe_sample_cdf(probe, r1: torch.Tensor, r2: torch.Tensor):
    """The reference's exact two-level CDF inversion (``cdf_texel``), the
    alias table's distribution oracle. ``probe`` is the host
    ``ProbeParams``; its tables go to the uniforms' device. Returns
    (dir (N, 3), color (N, 3), pdf (N,)), as ``probe_sample``."""
    w, h = probe.width, probe.height
    table = lambda a: torch.as_tensor(a, device=r1.device)  # noqa: E731
    row, col = cdf_texel(probe, r1, r2)
    lin = row * w + col
    color = table(probe.data).reshape(-1, 3)[lin]
    pdf = table(probe.pdf_x).reshape(-1)[lin] * table(probe.pdf_y)[row]
    u = col.to(torch.float32) / w
    v = row.to(torch.float32) / h
    sin_theta = torch.sin(v * PI)
    zero = sin_theta == 0.0
    pdf = torch.where(
        zero, 0.0,
        pdf * w * h / (2.0 * PI * PI * torch.where(zero, 1.0, sin_theta)),
    )
    return uv_to_dir(torch.stack([u, v], dim=-1)), color, pdf
