"""The JAX package's Pallas occlusion entry point under its own name and
signature (its ``ops/pallas_traverse.py`` ``occluded_packets``), on the
port's K3.

``occluded_packets`` takes JAX's arguments in its order, with the port's
``DeviceBVH`` of the legacy 8-wide table (``scene.legacy``, built by
``build_scene(..., legacy8=True)``) where JAX takes a ``WideBVH``, and
forwards to ``ops/packet_traverse.py``: K3 on a CUDA table, its plain
version on a CPU one.
"""

from __future__ import annotations

import torch

from fovpathtracing_optixcodelatest_tpu_torch.ops import packet_traverse
from fovpathtracing_optixcodelatest_tpu_torch.ops.traverse8 import _rays


def occluded_packets(bvh, origin, direction, tmin: float, tmax: float,
                     active=None, interpret: bool = False) -> torch.Tensor:
    """Any-hit occlusion with back faces culled over the legacy table ->
    (N,) bool; inactive rays False. ``interpret`` runs JAX's kernel in
    Pallas's interpreter and has no effect here: a CPU table runs the
    plain version."""
    o, d, active = _rays(bvh, origin, direction, active)
    return packet_traverse.occluded_packets(bvh.table, o, d, active,
                                            float(tmin), float(tmax),
                                            bvh.stack_depth, bvh.leaf_size)
