"""The device scene: packed BVH table, triangle attribute rows, material rows,
textures and the probe tables, as tensors on one device (counterpart of the
JAX package's ``models/scene.py``). ``build_scene`` packs a single-level
table of the world-space triangles; ``build_scene_instanced`` the two-level
table of an ``InstancedScene`` (``ops/tlas.py``), whose ``tri_pack`` holds
the unique meshes' object-space triangles only.

``has_textures`` (a triangle has a texture id >= 0) and ``has_catcher`` (a
material carries the shadow-catcher flag) are fixed when the scene is built:
a scene with neither runs the integrator without the texture fetch and
without the catcher branches. ``Scene.with_demand`` attaches a demand-loaded
texture context (``models/demand.py``): the integrator then point-samples
its tile atlas for every textured hit and reports the pages it missed.

A scene built with ``shading_normals=True`` also carries each triangle's
corner shading normals (``shading_normals``), which only the 04 raycast
(``render/simple.py``) reads; the path tracer never uploads them.

``scene_from_arrays`` is the one door between the packages: it builds the
port's scene from plain numpy arrays (the JAX ``Scene``'s arrays, collected
with ``np.asarray`` by the tests), so both packages can be fed the same BVH
table, ``tri_pack``, material rows, textures and probe tables.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from fovpathtracing_optixcodelatest_tpu_torch.models.material import (
    MATERIAL_FLAG_SHADOW_CATCHER,
    MATERIAL_FLAGS_COL,
    packed_rows_numpy,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
    HostMesh,
    flatten_meshes,
    host_triangles,
    shading_normal_rows,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
    ProbeParams,
    constant_probe,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.texture import (
    TextureArray,
    texture_arrays,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import bvh_native, tlas


@dataclasses.dataclass(frozen=True)
class DeviceBVH:
    table: torch.Tensor  # (U, W) float32
    stack_depth: int
    arity: int
    leaf_size: int
    # two-level tables: instance rows [inst_base, blas_base) (ops/tlas.py)
    num_instances: int = 0
    inst_base: int = 0
    blas_base: int = 0

    @property
    def num_rows(self) -> int:
        return self.table.shape[0]

    @property
    def instanced(self) -> bool:
        return self.num_instances > 0

    @property
    def walk_args(self) -> tuple:
        """The traversal wrappers' static arguments after tmin and tmax."""
        return (self.stack_depth, self.arity, self.leaf_size)

    @property
    def instance_kwargs(self) -> dict:
        """The traversal wrappers' instance arguments."""
        return {"num_instances": self.num_instances,
                "inst_base": self.inst_base, "blas_base": self.blas_base}


@dataclasses.dataclass(frozen=True)
class DeviceProbe:
    data: torch.Tensor  # (H, W, 3)
    pdf_x: torch.Tensor  # (H, W)
    pdf_y: torch.Tensor  # (H,)
    # (H*W, 13) alias rows, or None above SAMPLE_ROWS_MAX_TEXELS; then the
    # per-field alias arrays below are set instead
    sample_rows: Optional[torch.Tensor]
    alias_prob: Optional[torch.Tensor] = None  # (H*W,) float32
    alias_idx: Optional[torch.Tensor] = None  # (H*W,) int64
    pdf_flat: Optional[torch.Tensor] = None  # (H*W,) float32

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
    # None on a scene whose triangles carry no texture id
    textures: Optional[TextureArray] = None
    has_catcher: bool = False
    # the legacy 8-wide f32 table of the packet kernel (optional)
    legacy: Optional[DeviceBVH] = None
    # (T, 10) corner shading normals n0, n1, n2 and a has-normals flag
    # (1.0 / 0.0), where the scene was built with them
    shading_normals: Optional[torch.Tensor] = None
    # the demand-loaded texture context (models/demand.DemandContext)
    demand: object = None
    # one rank's view of a row-sharded scene (parallel/scene_shard.py):
    # every rank's tri_pack block, each on its rank's device, and this
    # rank's index; tri_pack is then this rank's own block. The integrator
    # gathers rows through render/integrator.take_tri_pack.
    pack_blocks: Optional[tuple] = None
    pack_rank: int = 0

    @property
    def has_textures(self) -> bool:
        return self.textures is not None

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

    def with_demand(self, demand) -> "Scene":
        """This scene with the demand-texture context ``demand`` (None
        detaches it), which must lie on the scene's device and know every
        texture id the triangles carry."""
        if demand is not None:
            if demand.device != self.device:
                raise ValueError(f"demand context on {demand.device}, "
                                 f"scene on {self.device}")
            top = int(self.tri_pack[:, 10].contiguous().view(torch.int32)
                      .max())
            if top >= demand.tex_meta.shape[0]:
                raise ValueError(f"texture id {top} of "
                                 f"{demand.tex_meta.shape[0]} textures")
        return dataclasses.replace(self, demand=demand)

    def memory_bytes(self) -> Dict[str, int]:
        """Device bytes of each scene array (the legacy table and the
        demand context left out, as the JAX package's report leaves them
        out)."""
        nbytes = lambda ts: sum(t.numel() * t.element_size()  # noqa: E731
                                for t in ts if t is not None)
        return {
            "bvh.table": nbytes([self.bvh.table]),
            "geom.tri_pack": nbytes([self.tri_pack]),
            "geom.shading_normals": nbytes([self.shading_normals]),
            "textures": nbytes([] if self.textures is None else
                               [self.textures.data, self.textures.sizes]),
            "probe": nbytes(
                getattr(self.probe, f.name)
                for f in dataclasses.fields(self.probe)),
        }

    def memory_report(self, n_rays: int = 0) -> str:
        """The scene's device footprint, array by array, and with
        ``n_rays`` an estimate of the frame state on top: the JAX package's
        (46 float32 a ray, doubled for temporaries)."""
        parts = self.memory_bytes()
        total = sum(parts.values())
        txt = " + ".join(f"{k} {v / 1e6:.0f}MB" for k, v in parts.items())
        if n_rays:
            frame = n_rays * 46 * 4 * 2
            return (f"scene {total / 1e9:.2f} GB ({txt}); frame state "
                    f"~{frame / 1e9:.2f} GB at {n_rays} rays "
                    f"=> ~{(total + frame) / 1e9:.2f} GB of device memory")
        return f"scene {total / 1e9:.2f} GB ({txt})"


def _probe_arrays(probe: ProbeParams) -> Dict[str, np.ndarray]:
    arrays = {
        "probe_data": probe.data, "probe_pdf_x": probe.pdf_x,
        "probe_pdf_y": probe.pdf_y,
    }
    if probe.sample_rows is not None:
        arrays["probe_sample_rows"] = probe.sample_rows
    else:
        arrays.update(probe_alias_prob=probe.alias_prob,
                      probe_alias_idx=probe.alias_idx,
                      probe_pdf_flat=probe.pdf_flat)
    return arrays


def _device_probe(arrays, device) -> DeviceProbe:
    t = lambda k: torch.tensor(  # noqa: E731
        np.asarray(arrays[k], dtype=np.float32), device=device
    )
    if arrays.get("probe_sample_rows") is not None:
        return DeviceProbe(
            data=t("probe_data"), pdf_x=t("probe_pdf_x"),
            pdf_y=t("probe_pdf_y"), sample_rows=t("probe_sample_rows"),
        )
    return DeviceProbe(
        data=t("probe_data"), pdf_x=t("probe_pdf_x"), pdf_y=t("probe_pdf_y"),
        sample_rows=None, alias_prob=t("probe_alias_prob"),
        alias_idx=torch.tensor(np.asarray(arrays["probe_alias_idx"],
                                          dtype=np.int64), device=device),
        pdf_flat=t("probe_pdf_flat"),
    )


def scene_from_arrays(arrays: Dict[str, np.ndarray], device="cuda",
                      demand=None) -> Scene:
    """Build a Scene from numpy arrays. Keys: ``bvh_table``,
    ``bvh_stack_depth``, ``bvh_arity``, ``bvh_leaf_size``, ``tri_pack``,
    ``material_rows``, ``probe_data``, ``probe_pdf_x``, ``probe_pdf_y`` and
    either ``probe_sample_rows`` or ``probe_alias_prob``,
    ``probe_alias_idx`` and ``probe_pdf_flat``; ``texture_data`` (K, H, W,
    3) and ``texture_sizes`` (K, 2) when a triangle carries a texture id;
    optionally ``legacy_table`` and ``legacy_stack_depth`` for the packet
    kernel; ``bvh_num_instances``, ``bvh_inst_base`` and ``bvh_blas_base``
    for a two-level table; optionally ``shading_normals`` (T, 10). A demand
    texture context ``demand`` stands in for ``texture_data``: the
    triangles' texture ids then index its textures."""
    tri_pack = np.ascontiguousarray(arrays["tri_pack"], dtype=np.float32)
    mat = np.ascontiguousarray(arrays["material_rows"], dtype=np.float32)
    f32 = lambda a: torch.tensor(  # noqa: E731
        np.asarray(a, dtype=np.float32), device=device
    )
    textures = None
    tex_ids = tri_pack[:, 10].view(np.int32)
    if (tex_ids >= 0).any() and demand is None:
        if "texture_data" not in arrays:
            raise ValueError("textured triangles need texture_data")
        data = np.asarray(arrays["texture_data"], dtype=np.float32)
        if int(tex_ids.max()) >= data.shape[0]:
            raise ValueError(
                f"texture id {int(tex_ids.max())} of {data.shape[0]} textures"
            )
        textures = TextureArray(
            data=f32(data),
            sizes=torch.tensor(np.asarray(arrays["texture_sizes"],
                                          dtype=np.int64), device=device),
        )
    flags = mat[:, MATERIAL_FLAGS_COL].view(np.int32)
    bvh = DeviceBVH(
        table=f32(arrays["bvh_table"]),
        stack_depth=int(arrays["bvh_stack_depth"]),
        arity=int(arrays["bvh_arity"]),
        leaf_size=int(arrays["bvh_leaf_size"]),
        num_instances=int(arrays.get("bvh_num_instances", 0)),
        inst_base=int(arrays.get("bvh_inst_base", 0)),
        blas_base=int(arrays.get("bvh_blas_base", 0)),
    )
    legacy = None
    if "legacy_table" in arrays:
        legacy = DeviceBVH(
            table=f32(arrays["legacy_table"]),
            stack_depth=int(arrays["legacy_stack_depth"]),
            arity=8, leaf_size=4,
        )
    normals = arrays.get("shading_normals")
    scene = Scene(
        bvh=bvh, tri_pack=f32(tri_pack), material_rows=f32(mat),
        probe=_device_probe(arrays, device), textures=textures,
        has_catcher=bool((flags & MATERIAL_FLAG_SHADOW_CATCHER).any()),
        legacy=legacy,
        shading_normals=None if normals is None else f32(normals),
    )
    return scene if demand is None else scene.with_demand(demand)


def scene_arrays(meshes: Sequence[HostMesh], probe: Optional[ProbeParams] = None,
                 texture_images: Optional[Sequence[np.ndarray]] = None,
                 legacy8: bool = False, bvh=None,
                 shading_normals: bool = False) -> Dict[str, np.ndarray]:
    """Host build: flatten, pack the BVH (and optionally the legacy table
    and the corner shading normals), pad the textures, build the probe
    tables -> the ``scene_from_arrays`` dict. ``bvh`` is the packed
    ``WideBVH`` of these meshes where it is built already."""
    tris = host_triangles(meshes)
    if bvh is None:
        bvh = bvh_native.build(tris)
    arrays = _host_arrays(meshes, bvh, probe, texture_images)
    if shading_normals:
        arrays["shading_normals"] = shading_normal_rows(meshes)
    if legacy8:
        leg = bvh_native.build_legacy8(tris)
        arrays["legacy_table"] = leg.table
        arrays["legacy_stack_depth"] = leg.stack_depth
    return arrays


def _host_arrays(meshes, bvh, probe, texture_images) -> Dict[str, np.ndarray]:
    tri_pack, materials = flatten_meshes(meshes)
    if probe is None:
        probe = constant_probe((2.5, 2.5, 2.5))
    tex_data, tex_sizes = texture_arrays(texture_images or [])
    return {
        "bvh_table": bvh.table, "bvh_stack_depth": bvh.stack_depth,
        "bvh_arity": bvh.arity, "bvh_leaf_size": bvh.leaf_size,
        "bvh_num_instances": bvh.num_instances,
        "bvh_inst_base": bvh.inst_base, "bvh_blas_base": bvh.blas_base,
        "tri_pack": tri_pack, "material_rows": packed_rows_numpy(materials),
        "texture_data": tex_data, "texture_sizes": tex_sizes,
        **_probe_arrays(probe),
    }


def scene_arrays_instanced(instanced_scene,
                           probe: Optional[ProbeParams] = None,
                           texture_images: Optional[Sequence[np.ndarray]] = None
                           ) -> Dict[str, np.ndarray]:
    """Host build of an ``InstancedScene``: the two-level table
    (``ops/tlas.py``) and the unique meshes' ``tri_pack`` -> the
    ``scene_from_arrays`` dict. Textures default to the scene's own."""
    unique_tris, mesh_ids, mats = tlas.scene_tables_from_instanced(
        instanced_scene)
    bvh = tlas.build_instanced(unique_tris, mesh_ids, mats)
    if texture_images is None:
        texture_images = instanced_scene.textures
    return _host_arrays(instanced_scene.unique, bvh, probe, texture_images)


def build_scene_instanced(instanced_scene,
                          probe: Optional[ProbeParams] = None,
                          texture_images: Optional[Sequence[np.ndarray]] = None,
                          device="cuda") -> Scene:
    """Render-time instancing: device geometry and table scale with the
    unique meshes; the instances live as a TLAS and transform rows in the
    one table K1 and K2 walk. ``build_scene(instanced_scene.flatten())``
    builds the same scene single-level."""
    return scene_from_arrays(
        scene_arrays_instanced(instanced_scene, probe, texture_images), device
    )


def build_scene(meshes: Sequence[HostMesh], probe: Optional[ProbeParams] = None,
                texture_images: Optional[Sequence[np.ndarray]] = None,
                device="cuda", legacy8: bool = False, demand=None,
                shading_normals: bool = False) -> Scene:
    """Flatten meshes, build the BVH, pack the textures (a mesh's
    ``diffuse_texture_id`` indexes ``texture_images``, or the textures of
    the demand context ``demand``), attach the probe (default: the constant
    2.5 ambient probe), upload to ``device``; ``shading_normals`` adds the
    corner normals the 04 raycast reads."""
    return scene_from_arrays(
        scene_arrays(meshes, probe, texture_images, legacy8,
                     shading_normals=shading_normals), device, demand
    )
