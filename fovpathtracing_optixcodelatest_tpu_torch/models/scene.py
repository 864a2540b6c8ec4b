"""The device scene: packed BVH table, triangle attribute rows, material rows
and the probe tables, as tensors on one device (counterpart of the JAX
package's ``models/scene.py`` for untextured single-level scenes).

``scene_from_arrays`` is the one door between the packages: it builds the
port's scene from plain numpy arrays (the JAX ``Scene``'s arrays, collected
with ``np.asarray`` by the tests), so both packages can be fed the same BVH
table, ``tri_pack``, material rows and probe rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from fovpathtracing_optixcodelatest_tpu_torch.models.material import (
    MATERIAL_FLAG_SHADOW_CATCHER,
    packed_rows_numpy,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
    HostMesh,
    flatten_meshes,
    host_triangles,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
    ProbeParams,
    constant_probe,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import bvh_native


@dataclasses.dataclass(frozen=True)
class DeviceBVH:
    table: torch.Tensor  # (U, W) float32
    stack_depth: int
    arity: int
    leaf_size: int

    @property
    def num_rows(self) -> int:
        return self.table.shape[0]


@dataclasses.dataclass(frozen=True)
class DeviceProbe:
    data: torch.Tensor  # (H, W, 3)
    pdf_x: torch.Tensor  # (H, W)
    pdf_y: torch.Tensor  # (H,)
    sample_rows: torch.Tensor  # (H*W, 13)

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]


@dataclasses.dataclass(frozen=True)
class Scene:
    bvh: DeviceBVH
    tri_pack: torch.Tensor  # (T, 48)
    material_rows: torch.Tensor  # (M, 24)
    probe: DeviceProbe
    # the legacy 8-wide f32 table of the packet kernel (optional)
    legacy: Optional[DeviceBVH] = None

    @property
    def num_triangles(self) -> int:
        return self.tri_pack.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_pack.device

    def with_probe(self, probe: ProbeParams) -> "Scene":
        return dataclasses.replace(
            self, probe=_device_probe(_probe_arrays(probe), self.device)
        )


def _probe_arrays(probe: ProbeParams) -> Dict[str, np.ndarray]:
    if probe.sample_rows is None:
        raise NotImplementedError(
            "probes above SAMPLE_ROWS_MAX_TEXELS (no sample rows) are not ported"
        )
    return {
        "probe_data": probe.data, "probe_pdf_x": probe.pdf_x,
        "probe_pdf_y": probe.pdf_y, "probe_sample_rows": probe.sample_rows,
    }


def _device_probe(arrays, device) -> DeviceProbe:
    t = lambda k: torch.tensor(  # noqa: E731
        np.asarray(arrays[k], dtype=np.float32), device=device
    )
    return DeviceProbe(
        data=t("probe_data"), pdf_x=t("probe_pdf_x"), pdf_y=t("probe_pdf_y"),
        sample_rows=t("probe_sample_rows"),
    )


def _check_supported(tri_pack: np.ndarray, material_rows: np.ndarray) -> None:
    if (tri_pack[:, 10].view(np.int32) >= 0).any():
        raise NotImplementedError("textured scenes are not ported")
    if (material_rows[:, 22].view(np.int32) & MATERIAL_FLAG_SHADOW_CATCHER).any():
        raise NotImplementedError("shadow-catcher materials are not ported")


def scene_from_arrays(arrays: Dict[str, np.ndarray], device="cuda") -> Scene:
    """Build a Scene from numpy arrays. Keys: ``bvh_table``,
    ``bvh_stack_depth``, ``bvh_arity``, ``bvh_leaf_size``, ``tri_pack``,
    ``material_rows``, ``probe_data``, ``probe_pdf_x``, ``probe_pdf_y``,
    ``probe_sample_rows``; optionally ``legacy_table`` and
    ``legacy_stack_depth`` for the packet kernel."""
    if arrays.get("instanced", False):
        raise NotImplementedError("instanced (two-level) scenes are not ported")
    if arrays.get("demand") is not None:
        raise NotImplementedError("demand-loaded textures are not ported")
    tri_pack = np.ascontiguousarray(arrays["tri_pack"], dtype=np.float32)
    mat = np.ascontiguousarray(arrays["material_rows"], dtype=np.float32)
    _check_supported(tri_pack, mat)
    f32 = lambda a: torch.tensor(  # noqa: E731
        np.asarray(a, dtype=np.float32), device=device
    )
    bvh = DeviceBVH(
        table=f32(arrays["bvh_table"]),
        stack_depth=int(arrays["bvh_stack_depth"]),
        arity=int(arrays["bvh_arity"]),
        leaf_size=int(arrays["bvh_leaf_size"]),
    )
    legacy = None
    if "legacy_table" in arrays:
        legacy = DeviceBVH(
            table=f32(arrays["legacy_table"]),
            stack_depth=int(arrays["legacy_stack_depth"]),
            arity=8, leaf_size=4,
        )
    return Scene(
        bvh=bvh, tri_pack=f32(tri_pack), material_rows=f32(mat),
        probe=_device_probe(arrays, device), legacy=legacy,
    )


def scene_arrays(meshes: Sequence[HostMesh], probe: Optional[ProbeParams] = None,
                 legacy8: bool = False) -> Dict[str, np.ndarray]:
    """Host build: flatten, pack the BVH (and optionally the legacy table),
    build the probe tables -> the ``scene_from_arrays`` dict."""
    tri_pack, materials = flatten_meshes(meshes)
    tris = host_triangles(meshes)
    bvh = bvh_native.build(tris)
    if probe is None:
        probe = constant_probe((2.5, 2.5, 2.5))
    arrays = {
        "bvh_table": bvh.table, "bvh_stack_depth": bvh.stack_depth,
        "bvh_arity": bvh.arity, "bvh_leaf_size": bvh.leaf_size,
        "tri_pack": tri_pack, "material_rows": packed_rows_numpy(materials),
        **_probe_arrays(probe),
    }
    if legacy8:
        leg = bvh_native.build_legacy8(tris)
        arrays["legacy_table"] = leg.table
        arrays["legacy_stack_depth"] = leg.stack_depth
    return arrays


def build_scene(meshes: Sequence[HostMesh], probe: Optional[ProbeParams] = None,
                device="cuda", legacy8: bool = False) -> Scene:
    """Flatten meshes, build the BVH, attach the probe (default: the constant
    2.5 ambient probe), upload to ``device``. Textured meshes raise
    NotImplementedError."""
    if any(m.diffuse_texture_id >= 0 for m in meshes):
        raise NotImplementedError("textured scenes are not ported")
    return scene_from_arrays(scene_arrays(meshes, probe, legacy8), device)
