"""Render-time instancing in the benchmark's own terms.

A scene generator may return, beside its unique object-space meshes, an
instance table: a list of ``{"mesh_ids": [...], "transform": 4x4}``, each
entry placing the meshes it names by one object-to-world matrix. The port
builds such a table two-level; the reference renders the world that
``flatten`` expands it into. Plain numpy: nothing of the port is imported.
"""

from __future__ import annotations

import numpy as np


def place(mesh: dict, world) -> dict:
    """``mesh`` moved by the 4x4 affine ``world``: positions by the matrix,
    normals by its inverse transpose, renormalised, in float64 and rounded
    to float32 once (the port's ``models/instance.py`` ``transform_mesh``
    does the same)."""
    world = np.asarray(world, dtype=np.float64)
    rot = world[:3, :3]
    pos = mesh["vertex"].astype(np.float64) @ rot.T + world[:3, 3]
    normal = mesh["normal"].astype(np.float64) @ np.linalg.inv(rot)
    norms = np.linalg.norm(normal, axis=1, keepdims=True)
    normal = normal / np.maximum(norms, 1e-12)
    return dict(mesh, vertex=pos.astype(np.float32),
                normal=normal.astype(np.float32))


def flatten(meshes: list, instances: list) -> list:
    """The world-space meshes of the table ``instances`` over the unique
    ``meshes``: one a (instance, mesh id) pair, in the table's order."""
    return [place(meshes[mid], inst["transform"])
            for inst in instances for mid in inst["mesh_ids"]]
