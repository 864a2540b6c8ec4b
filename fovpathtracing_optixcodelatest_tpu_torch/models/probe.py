"""Environment probe: host-side 2-level luminance CDF, Walker alias table and
the 13-column one-gather sampling rows (counterpart of the JAX package's
``models/probe.py``; the same numpy build, so the tables are bit-identical).

``ProbeParams`` holds host numpy arrays; ``models/scene.py`` uploads the
ones shading reads (``data``, ``pdf_x``, ``pdf_y``, ``sample_rows``)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProbeParams:
    data: np.ndarray  # (H, W, 3) float32 radiance
    pdf_x: np.ndarray  # (H, W) row-conditional pdf
    cdf_x: np.ndarray  # (H, W) row-conditional cdf (inclusive)
    pdf_y: np.ndarray  # (H,) row marginal pdf
    cdf_y: np.ndarray  # (H,)
    alias_prob: np.ndarray  # (H*W,)
    alias_idx: np.ndarray  # (H*W,) int32
    pdf_flat: np.ndarray  # (H*W,) joint texel pdf
    # (H*W, 13): [prob, uA, vA, pdfA, colA rgb, uB, vB, pdfB, colB rgb] with
    # A = texel c and B = its alias; None above SAMPLE_ROWS_MAX_TEXELS
    sample_rows: np.ndarray | None

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]


def _build_alias(weights: np.ndarray):
    """Walker/Vose alias table (two-pointer sweep)."""
    k = len(weights)
    total = weights.sum()
    if total <= 0:
        return np.ones(k, np.float32), np.arange(k, dtype=np.int32)
    p = weights.astype(np.float64) * (k / total)
    prob = np.ones(k, dtype=np.float64)
    alias = np.arange(k, dtype=np.int32)
    order = np.argsort(p)
    small_list = [i for i in order if p[i] < 1.0]
    large_list = [i for i in order[::-1] if p[i] >= 1.0]
    si = li = 0
    while si < len(small_list) and li < len(large_list):
        s = small_list[si]
        lg = large_list[li]
        prob[s] = p[s]
        alias[s] = lg
        p[lg] = (p[lg] + p[s]) - 1.0
        si += 1
        if p[lg] < 1.0:
            small_list.append(lg)
            li += 1
    return prob.astype(np.float32), alias.astype(np.int32)


SAMPLE_ROWS_MAX_TEXELS = 1 << 21


def build_cdf(data: np.ndarray) -> ProbeParams:
    """pdf_x[j,i] = L[j,i]/sum_i L[j,:], pdf_y[j] = sum_i L[j,:]/sum L over
    0.3/0.6/0.1 luminance; plus the alias table and sampling rows."""
    data = np.asarray(data, dtype=np.float32)
    assert data.ndim == 3 and data.shape[2] >= 3
    rgb = data[..., :3]
    weight = 0.3 * rgb[..., 0] + 0.6 * rgb[..., 1] + 0.1 * rgb[..., 2]
    weight = np.maximum(weight, 0.0)
    row_sum = weight.sum(axis=1)
    safe_row = np.where(row_sum > 0, row_sum, 1.0)
    pdf_x = weight / safe_row[:, None]
    cdf_x = np.cumsum(weight, axis=1) / safe_row[:, None]
    total = row_sum.sum()
    safe_total = total if total > 0 else 1.0
    pdf_y = row_sum / safe_total
    cdf_y = np.cumsum(row_sum) / safe_total
    alias_prob, alias_idx = _build_alias(weight.reshape(-1))
    pdf_flat = (pdf_x * pdf_y[:, None]).reshape(-1).astype(np.float32)
    h, w = weight.shape
    sample_rows = None
    if h * w <= SAMPLE_ROWS_MAX_TEXELS:
        lin = np.arange(h * w, dtype=np.int64)
        rgb_flat = rgb.reshape(-1, 3).astype(np.float32)

        def _uv(ids):
            r = (ids // w).astype(np.int32)
            c = (ids - r * w).astype(np.int32)
            return (c.astype(np.float32) / np.float32(w),
                    r.astype(np.float32) / np.float32(h))

        u_a, v_a = _uv(lin)
        u_b, v_b = _uv(alias_idx.astype(np.int64))
        sample_rows = np.concatenate([
            alias_prob[:, None], u_a[:, None], v_a[:, None],
            pdf_flat[:, None], rgb_flat,
            u_b[:, None], v_b[:, None],
            pdf_flat[alias_idx][:, None], rgb_flat[alias_idx],
        ], axis=1).astype(np.float32)
    return ProbeParams(
        data=rgb.astype(np.float32),
        pdf_x=pdf_x.astype(np.float32),
        cdf_x=cdf_x.astype(np.float32),
        pdf_y=pdf_y.astype(np.float32),
        cdf_y=cdf_y.astype(np.float32),
        alias_prob=alias_prob,
        alias_idx=alias_idx,
        pdf_flat=pdf_flat,
        sample_rows=sample_rows,
    )


def constant_probe(color, width: int = 64, height: int = 32) -> ProbeParams:
    """Solid-color environment."""
    data = np.tile(np.asarray(color, dtype=np.float32), (height, width, 1))
    return build_cdf(data)


def gradient_sky_probe(width: int = 256, height: int = 128,
                       zenith=(0.35, 0.55, 1.0), horizon=(1.0, 0.95, 0.85),
                       sun_dir=(0.3, 0.8, 0.5), sun_power: float = 200.0,
                       sun_sharpness: float = 400.0) -> ProbeParams:
    """Procedural HDR sky with a bright sun disc."""
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    theta = v * np.pi
    phi = u * 2.0 * np.pi
    x = -np.sin(theta)[:, None] * np.cos(phi)[None, :]
    y = np.cos(theta)[:, None] * np.ones_like(phi)[None, :]
    z = -np.sin(theta)[:, None] * np.sin(phi)[None, :]
    t = np.clip(0.5 * (y + 1.0), 0.0, 1.0)[..., None]
    sky = np.asarray(horizon) * (1 - t) + np.asarray(zenith) * t
    sd = np.asarray(sun_dir, dtype=np.float64)
    sd /= np.linalg.norm(sd)
    cosang = x * sd[0] + y * sd[1] + z * sd[2]
    sun = np.exp(sun_sharpness * (np.clip(cosang, -1, 1) - 1.0))[..., None]
    data = sky + sun_power * sun
    return build_cdf(data.astype(np.float32))
