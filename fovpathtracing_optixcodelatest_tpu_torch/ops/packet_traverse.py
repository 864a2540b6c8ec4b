"""Occlusion over the legacy 8-wide float32 BVH (counterpart of the JAX
package's Pallas kernel, ``ops/pallas_traverse.py`` ``occluded_packets``).

``occluded_packets`` is the kernel wrapper: on a CUDA tensor it launches K3
(``csrc/packet_traverse.cu``, a masked warp-packet walk compiled for the
legacy layout only: 64 columns, leaf size 4) and raises if the launch
fails; on a CPU tensor it runs ``occluded_packets_plain``, which walks every
ray's stack as one (N, stack_depth) int64 tensor and repeats the kernel's
arithmetic. The plain version takes any leaf size.

Same contract as ``traverse.occluded``: back faces culled, tmin <= t <= tmax,
first-hit exit, inactive rays false, and each ray's answer that of its own
walk. Stack entries are a node row, or -(row + 1) for a leaf row; children
are pushed in slot order; a ray whose stack holds ``stack_depth`` entries
pushes no more children. The Pallas kernel's union walk may answer
differently on a ray that grazes a leaf's box (``ROADMAP.md`` §3).
"""

from __future__ import annotations

import ctypes

import torch

from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
from fovpathtracing_optixcodelatest_tpu_torch.ops.traverse import (
    RAYS,
    STATS,
    _add_stats,
    _check,
    _kernel_layout,
    _push,
    _seen_rows,
    safe_inv,
    slab,
    tri_test,
)

WIDTH = 8
KERNEL_LEAF_SIZE = 4  # the leaf size K3 is compiled for
# what K3 counts of its own walk (``fetched``): packets, and rows fetched
# once per packet step
FETCHES = ("packets", "node_rows", "leaf_rows")


class PacketArgs(ctypes.Structure):
    """``fov_occluded_packets``' argument struct (csrc/packet_traverse.cu)."""

    _fields_ = [*((k, ctypes.c_void_p) for k in (
                    "table", "orig", "dir", "active", "occ_out", "spill",
                    "counter")),
                ("n", ctypes.c_int), ("tmin", ctypes.c_float),
                ("tmax", ctypes.c_float), ("stack_depth", ctypes.c_int)]


def occluded_packets_plain(table, o, d, active, tmin: float, tmax: float,
                           stack_depth: int, leaf_size: int = 4,
                           stats: dict | None = None):
    """Plain PyTorch K3 -> (N,) bool; ``stats`` counts the node and leaf
    rows fetched and the tests done on them, as ``traverse``'s plain
    versions do (a padding triangle slot is all zero: the legacy rows have
    no triangle ids)."""
    n, dev = o.shape[0], o.device
    inv = safe_inv(d)
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    stack = torch.zeros((n, stack_depth), dtype=torch.int64, device=dev)
    sp = active.to(torch.int64)  # the root (row 0) sits at depth 0
    fetched = dict.fromkeys(STATS, 0)
    seen = _seen_rows(table, stats)
    while True:
        idx = torch.nonzero((sp > 0) & ~occ).squeeze(1)
        if idx.numel() == 0:
            break
        sp[idx] -= 1
        e = stack[idx, sp[idx]]
        leaf = e < 0
        row = torch.where(leaf, -e - 1, e)
        if seen is not None:
            seen[row] = True
        rows = table[row]

        ni = idx[~leaf]
        fetched["node_rows"] += ni.numel()
        if ni.numel():
            nrows = rows[~leaf]
            boxes = nrows[:, :48].reshape(-1, WIDTH, 6)
            meta = nrows[:, 48:64].contiguous().view(torch.int32)
            a_val = meta[:, 0::2].to(torch.int64)
            kind = meta[:, 1::2].to(torch.int64)
            fetched["child_tests"] += int((kind >= 0).sum())
            hit, _ = slab(boxes[..., 0:3], boxes[..., 3:6], o[ni], inv[ni],
                          tmin, tmax)
            child = torch.where(kind > 0, -(a_val + 1), a_val)
            _push(stack, sp, ni, child, hit & (kind >= 0))

        li = idx[leaf]
        fetched["leaf_rows"] += li.numel()
        if li.numel():
            lrows = rows[leaf]
            tris = lrows[:, : 9 * leaf_size].reshape(-1, leaf_size, 9)
            fetched["tri_tests"] += int((tris != 0).any(dim=-1).sum())
            hit_any = torch.zeros((li.numel(),), dtype=torch.bool, device=dev)
            for k in range(leaf_size):
                hk, _, _, _ = tri_test(lrows[:, 9 * k: 9 * k + 9], o[li],
                                       d[li], tmin, tmax, cull=True)
                hit_any |= hk
            occ[li] = hit_any
    _add_stats(stats, fetched, seen)
    return occ


def occluded_packets(table, o, d, active, tmin: float, tmax: float,
                     stack_depth: int, leaf_size: int = 4,
                     fetched: dict | None = None):
    """Any-hit occlusion over the legacy table -> (N,) bool. CUDA tensors
    launch K3; CPU tensors run ``occluded_packets_plain``. On a CUDA tensor,
    ``fetched`` (a dict) gets K3's own counts added (``FETCHES``: packets
    walked, node and leaf rows fetched), which synchronises the host."""
    _check(table, o, d, active, stack_depth)
    if table.shape[1] < 64:
        raise ValueError("legacy table rows need 64 columns")
    if table.device.type == "cpu":
        if fetched is not None:
            raise ValueError("fetched counts K3's walk: CUDA tensors only")
        return occluded_packets_plain(table, o, d, active, tmin, tmax,
                                      stack_depth, leaf_size)
    n, dev = o.shape[0], o.device
    _kernel_layout(table, n, WIDTH, leaf_size, want=(WIDTH, KERNEL_LEAF_SIZE),
                   width=64)
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:  # nothing to launch
        return occ
    # the packets' stack entries beyond what shared memory holds
    entries, = kernel_build.query("packet_traverse", "fov_packet_spill",
                                  stack_depth, n, outs=1,
                                  out_type=ctypes.c_longlong)
    spill = torch.empty((entries, 2), dtype=torch.int32, device=dev)
    counter = torch.zeros((4,), dtype=torch.int32, device=dev)
    args = kernel_build.fill(
        PacketArgs(occ_out=occ.data_ptr(), spill=spill.data_ptr(),
                   counter=counter.data_ptr(), n=n, tmin=tmin, tmax=tmax,
                   stack_depth=stack_depth),
        dev, RAYS, {"table": table, "orig": o, "dir": d, "active": active})
    kernel_build.launch("packet_traverse", "fov_occluded_packets",
                        "occluded_packets", args)
    if fetched is not None:
        for name, count in zip(FETCHES, counter[1:].tolist()):
            fetched[name] = fetched.get(name, 0) + count
    return occ
