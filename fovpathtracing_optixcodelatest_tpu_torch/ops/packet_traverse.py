"""Occlusion over the legacy 8-wide float32 BVH (counterpart of the JAX
package's Pallas kernel, ``ops/pallas_traverse.py`` ``occluded_packets``).

``occluded_packets`` is the kernel wrapper: on a CUDA tensor it launches K3
(``csrc/packet_traverse.cu``) and raises if the launch fails; on a CPU
tensor it runs ``occluded_packets_plain``, which walks every ray's stack as
one (N, stack_depth) int64 tensor and repeats the kernel's arithmetic.

Same contract as ``traverse.occluded``: back faces culled, tmin <= t <= tmax,
first-hit exit, inactive rays false. Stack entries are a node row, or
-(row + 1) for a leaf row; children are pushed in slot order.
"""

from __future__ import annotations

import torch

from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
from fovpathtracing_optixcodelatest_tpu_torch.ops.traverse import (
    _check,
    _push,
    safe_inv,
    slab,
    tri_test,
)

WIDTH = 8


def occluded_packets_plain(table, o, d, active, tmin: float, tmax: float,
                           stack_depth: int, leaf_size: int = 4,
                           stats: dict | None = None):
    """Plain PyTorch K3 -> (N,) bool; ``stats`` counts the node and
    leaf rows fetched."""
    n, dev = o.shape[0], o.device
    inv = safe_inv(d)
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    stack = torch.zeros((n, stack_depth), dtype=torch.int64, device=dev)
    sp = active.to(torch.int64)  # the root (row 0) sits at depth 0
    fetched = {"node_rows": 0, "leaf_rows": 0}
    while True:
        idx = torch.nonzero((sp > 0) & ~occ).squeeze(1)
        if idx.numel() == 0:
            break
        sp[idx] -= 1
        e = stack[idx, sp[idx]]
        leaf = e < 0
        rows = table[torch.where(leaf, -e - 1, e)]

        ni = idx[~leaf]
        fetched["node_rows"] += ni.numel()
        if ni.numel():
            nrows = rows[~leaf]
            boxes = nrows[:, :48].reshape(-1, WIDTH, 6)
            meta = nrows[:, 48:64].contiguous().view(torch.int32)
            a_val = meta[:, 0::2].to(torch.int64)
            kind = meta[:, 1::2].to(torch.int64)
            hit, _ = slab(boxes[..., 0:3], boxes[..., 3:6], o[ni], inv[ni],
                          tmin, tmax)
            child = torch.where(kind > 0, -(a_val + 1), a_val)
            _push(stack, sp, ni, child, hit & (kind >= 0))

        li = idx[leaf]
        fetched["leaf_rows"] += li.numel()
        if li.numel():
            lrows = rows[leaf]
            hit_any = torch.zeros((li.numel(),), dtype=torch.bool, device=dev)
            for k in range(leaf_size):
                hk, _, _, _ = tri_test(lrows[:, 9 * k: 9 * k + 9], o[li],
                                       d[li], tmin, tmax, cull=True)
                hit_any |= hk
            occ[li] = hit_any
    if stats is not None:
        for name, count in fetched.items():
            stats[name] = stats.get(name, 0) + count
    return occ


def occluded_packets(table, o, d, active, tmin: float, tmax: float,
                     stack_depth: int, leaf_size: int = 4):
    """Any-hit occlusion over the legacy table -> (N,) bool. CUDA tensors
    launch K3; CPU tensors run ``occluded_packets_plain``."""
    _check(table, o, d, active, stack_depth)
    if table.shape[1] < 64:
        raise ValueError("legacy table rows need 64 columns")
    if table.device.type == "cpu":
        return occluded_packets_plain(table, o, d, active, tmin, tmax,
                                      stack_depth, leaf_size)
    n = o.shape[0]
    occ = torch.empty((n,), dtype=torch.bool, device=o.device)
    rc = kernel_build.library("packet_traverse").fov_occluded_packets(
        table.data_ptr(), table.shape[1], o.data_ptr(), d.data_ptr(),
        active.data_ptr(), n, tmin, tmax, stack_depth, leaf_size,
        occ.data_ptr(), kernel_build.stream(),
    )
    kernel_build.check(rc, "occluded_packets")
    kernel_build.LAUNCHES["occluded_packets"] += 1
    return occ
