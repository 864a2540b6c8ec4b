"""Disney material parameters and the packed 24-column material row
(counterpart of the JAX package's ``models/material.py``; same fields,
defaults and row layout)."""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

MATERIAL_FLAG_NONE = 0
MATERIAL_FLAG_SHADOW_CATCHER = 1 << 0
MATERIAL_FLAGS_COL = 22  # the packed row's column of the int32 flags


@dataclasses.dataclass
class Material:
    color: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    emission: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    absorption: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    eta: float = 1.4
    metallic: float = 0.5
    subsurface: float = 0.0
    specular: float = 1.0
    roughness: float = 1.0
    specular_tint: float = 1.0
    anisotropic: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.0
    clearcoat: float = 0.0
    clearcoat_gloss: float = 1.0
    transmission: float = 0.4
    bump: float = 0.0
    flags: int = MATERIAL_FLAG_NONE

    def index_of_refraction(self) -> float:
        """eta, or inferred from specular when eta == 0."""
        if self.eta == 0.0:
            return 2.0 / (1.0 - float(np.sqrt(0.08 * self.specular))) - 1.0
        return self.eta


SCALAR_FIELDS = (
    "eta", "metallic", "subsurface", "specular", "roughness",
    "specular_tint", "anisotropic", "sheen", "sheen_tint", "clearcoat",
    "clearcoat_gloss", "transmission", "bump",
)


def packed_rows_numpy(materials: Sequence[Material]) -> np.ndarray:
    """(M, 24) float32 rows: color 0:3, emission 3:6, absorption 6:9, the
    scalar fields 9:22, int32 flags bitcast into column 22."""
    if not materials:
        materials = [Material()]
    packed = np.zeros((len(materials), 24), dtype=np.float32)
    for i, m in enumerate(materials):
        packed[i, 0:3] = m.color
        packed[i, 3:6] = m.emission
        packed[i, 6:9] = m.absorption
        for j, f in enumerate(SCALAR_FIELDS):
            v = m.index_of_refraction() if f == "eta" else getattr(m, f)
            packed[i, 9 + j] = v
    packed[:, MATERIAL_FLAGS_COL] = np.array(
        [m.flags for m in materials], dtype=np.int32
    ).view(np.float32)
    return packed


@dataclasses.dataclass
class MaterialView:
    """Per-ray material fields viewed over already-gathered (N, 24) rows."""

    color: torch.Tensor
    emission: torch.Tensor
    absorption: torch.Tensor
    eta: torch.Tensor
    metallic: torch.Tensor
    subsurface: torch.Tensor
    specular: torch.Tensor
    roughness: torch.Tensor
    specular_tint: torch.Tensor
    anisotropic: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    transmission: torch.Tensor
    bump: torch.Tensor
    flags: torch.Tensor


def view_rows(g: torch.Tensor) -> MaterialView:
    kw = {"color": g[:, 0:3], "emission": g[:, 3:6], "absorption": g[:, 6:9]}
    for j, f in enumerate(SCALAR_FIELDS):
        kw[f] = g[:, 9 + j]
    kw["flags"] = g[:, MATERIAL_FLAGS_COL].contiguous().view(torch.int32)
    return MaterialView(**kw)
