"""Spectral sampling: CIE curves, RGB <-> spectrum, hero wavelengths
(counterpart of the JAX package's ``ops/spectrum.py``; the constants are
built with numpy exactly as there).

- CIE 1931 colour matching through the Wyman-Sloan-Shirley multi-lobe
  Gaussian fits (analytic, no tables);
- RGB -> spectrum through a smooth 3-basis (raised-cosine bumps mixed so
  each basis reproduces its sRGB primary under the CIE curves);
- hero-wavelength sampling: one uniform sample spawns ``NUM_HERO`` evenly
  rotated wavelengths.
"""

from __future__ import annotations

import numpy as np
import torch

LAMBDA_MIN = 380.0
LAMBDA_MAX = 720.0
NUM_BINS = 81
NUM_HERO = 4

_LAMBDAS = np.linspace(LAMBDA_MIN, LAMBDA_MAX, NUM_BINS)


def _g(x, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    return np.exp(-0.5 * ((x - mu) / s) ** 2)


def cie_xyz_bar(lam: np.ndarray):
    """The CIE 1931 2-degree x/y/z-bar curves at ``lam`` (float64 numpy)."""
    lam = np.asarray(lam, dtype=np.float64)
    x = (1.056 * _g(lam, 599.8, 37.9, 31.0)
         + 0.362 * _g(lam, 442.0, 16.0, 26.7)
         - 0.065 * _g(lam, 501.1, 20.4, 26.2))
    y = 0.821 * _g(lam, 568.8, 46.9, 40.5) + 0.286 * _g(lam, 530.9, 16.3, 31.1)
    z = 1.217 * _g(lam, 437.0, 11.8, 36.0) + 0.681 * _g(lam, 459.0, 26.0, 13.8)
    return x, y, z


def cie_xyz_bar_torch(lam: torch.Tensor):
    """``cie_xyz_bar`` on a float32 tensor of wavelengths."""

    def g(x, mu, s1, s2):
        s = torch.where(x < mu, s1, s2)
        return torch.exp(-0.5 * ((x - mu) / s) ** 2)

    x = (1.056 * g(lam, 599.8, 37.9, 31.0)
         + 0.362 * g(lam, 442.0, 16.0, 26.7)
         - 0.065 * g(lam, 501.1, 20.4, 26.2))
    y = 0.821 * g(lam, 568.8, 46.9, 40.5) + 0.286 * g(lam, 530.9, 16.3, 31.1)
    z = 1.217 * g(lam, 437.0, 11.8, 36.0) + 0.681 * g(lam, 459.0, 26.0, 13.8)
    return x, y, z


_XBAR, _YBAR, _ZBAR = cie_xyz_bar(_LAMBDAS)
_DL = (LAMBDA_MAX - LAMBDA_MIN) / (NUM_BINS - 1)
_Y_NORM = float(np.sum(_YBAR) * _DL)

XYZ_TO_SRGB = np.asarray([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
])
SRGB_TO_XYZ = np.linalg.inv(XYZ_TO_SRGB)


def _build_rgb_basis() -> np.ndarray:
    """Three smooth spectra for R, G, B, each mixed from wide raised-cosine
    bumps so that its (Y-normalised) CIE response is its sRGB primary's
    XYZ."""
    centers = np.asarray([460.0, 550.0, 630.0])
    widths = np.asarray([70.0, 75.0, 80.0])
    bumps = np.stack([
        np.clip(np.cos((_LAMBDAS - c) / w * np.pi / 2), 0.0, None) ** 2
        for c, w in zip(centers, widths)
    ])
    resp = np.stack([
        [np.sum(b * _XBAR) * _DL / _Y_NORM,
         np.sum(b * _YBAR) * _DL / _Y_NORM,
         np.sum(b * _ZBAR) * _DL / _Y_NORM]
        for b in bumps
    ])
    weights = SRGB_TO_XYZ.T @ np.linalg.inv(resp)
    return np.maximum(weights @ bumps, 0.0)


RGB_BASIS = _build_rgb_basis()  # (3, NUM_BINS)


def _f32(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=like.device)


def rgb_to_spectrum(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) linear sRGB -> (..., NUM_BINS) non-negative spectra."""
    return torch.clamp(rgb @ _f32(RGB_BASIS, rgb), min=0.0)


def spectrum_to_xyz(spec: torch.Tensor) -> torch.Tensor:
    """(..., NUM_BINS) -> (..., 3) CIE XYZ (Y-normalised)."""
    cmf = _f32(np.stack([_XBAR, _YBAR, _ZBAR]), spec)
    return (spec @ cmf.T) * (_DL / _Y_NORM)


def spectrum_to_rgb(spec: torch.Tensor) -> torch.Tensor:
    """(..., NUM_BINS) -> linear sRGB."""
    return spectrum_to_xyz(spec) @ _f32(XYZ_TO_SRGB, spec).T


def sample_hero_wavelengths(u: torch.Tensor) -> torch.Tensor:
    """One uniform per ray (N,) -> (N, NUM_HERO) wavelengths rotated evenly
    across the visible range."""
    span = LAMBDA_MAX - LAMBDA_MIN
    hero = LAMBDA_MIN + u[..., None] * span
    offsets = torch.arange(NUM_HERO, dtype=torch.float32,
                           device=u.device) * (span / NUM_HERO)
    lam = hero + offsets
    return torch.where(lam > LAMBDA_MAX, lam - span, lam)


def eval_spectrum_at(spec: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of (..., NUM_BINS) spectra at (..., K)
    wavelengths -> (..., K)."""
    t = (lam - LAMBDA_MIN) / (LAMBDA_MAX - LAMBDA_MIN) * (NUM_BINS - 1)
    t = torch.clamp(t, 0.0, NUM_BINS - 1)
    i0 = torch.clamp(t.to(torch.int64), max=NUM_BINS - 2)
    frac = t - i0
    s0 = torch.gather(spec, -1, i0)
    s1 = torch.gather(spec, -1, i0 + 1)
    return s0 * (1 - frac) + s1 * frac
