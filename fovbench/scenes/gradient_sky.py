"""The procedural HDR sky with a bright sun disc, as a lat-long (H, W, 3)
float32 image: a frozen copy of the image half of the port's
``models/probe.py`` ``gradient_sky_probe`` (the port builds its sampling
tables from the image; the reference builds its own)."""

from __future__ import annotations

import numpy as np


def generate(width: int = 256, height: int = 128,
             zenith=(0.35, 0.55, 1.0), horizon=(1.0, 0.95, 0.85),
             sun_dir=(0.3, 0.8, 0.5), sun_power: float = 200.0,
             sun_sharpness: float = 400.0) -> np.ndarray:
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
    return (sky + sun_power * sun).astype(np.float32)
