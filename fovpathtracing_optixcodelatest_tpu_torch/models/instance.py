"""Scene instancing: unique object-space meshes and an instance table
(counterpart of the JAX package's ``models/instance.py``).

The unique geometry is stored once; each instance names its meshes and a
4x4 object-to-world transform. ``models/scene.py``
``build_scene_instanced`` renders the table as it is (a TLAS over the
instances, ``ops/tlas.py``); ``flatten`` expands it into the world-space
mesh list that ``build_scene`` takes. Editing a transform is the analog of
an instance-table update: the unique vertex data is untouched.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import HostMesh


def transform_mesh(mesh: HostMesh, world: np.ndarray) -> HostMesh:
    """Apply a 4x4 affine transform: positions by the matrix, normals by its
    inverse transpose, renormalised."""
    world = np.asarray(world, dtype=np.float64)
    rot = world[:3, :3]
    pos = mesh.vertex.astype(np.float64) @ rot.T + world[:3, 3]
    normal = None
    if mesh.normal is not None:
        nrm_mat = np.linalg.inv(rot).T
        normal = mesh.normal.astype(np.float64) @ nrm_mat.T
        norms = np.linalg.norm(normal, axis=1, keepdims=True)
        normal = (normal / np.maximum(norms, 1e-12)).astype(np.float32)
    return dataclasses.replace(
        mesh, vertex=pos.astype(np.float32), normal=normal
    )


@dataclasses.dataclass(frozen=True)
class Instance:
    """Which unique meshes, placed where."""

    mesh_ids: Tuple[int, ...]
    transform: np.ndarray  # (4, 4)


@dataclasses.dataclass
class InstancedScene:
    """Unique meshes, the instance table and the shared textures."""

    unique: List[HostMesh]
    instances: List[Instance]
    textures: List[np.ndarray]

    @property
    def num_unique_triangles(self) -> int:
        return sum(len(m.index) for m in self.unique)

    @property
    def num_world_triangles(self) -> int:
        return sum(len(self.unique[mid].index)
                   for inst in self.instances for mid in inst.mesh_ids)

    def flatten(self) -> List[HostMesh]:
        """The world-space mesh list ``build_scene`` takes."""
        return [transform_mesh(self.unique[mid], inst.transform)
                for inst in self.instances for mid in inst.mesh_ids]

    def replace_transform(self, index: int, transform: np.ndarray) -> None:
        """Move one instance."""
        inst = self.instances[index]
        self.instances[index] = Instance(
            mesh_ids=inst.mesh_ids,
            transform=np.asarray(transform, dtype=np.float64),
        )


def instanced(unique: Sequence[HostMesh],
              placements: Sequence[Tuple[int, np.ndarray]],
              textures: Optional[Sequence[np.ndarray]] = None
              ) -> InstancedScene:
    """An ``InstancedScene`` from (unique mesh id, 4x4) placements."""
    return InstancedScene(
        unique=list(unique),
        instances=[Instance(mesh_ids=(mid,),
                            transform=np.asarray(m, np.float64))
                   for mid, m in placements],
        textures=list(textures or []),
    )
