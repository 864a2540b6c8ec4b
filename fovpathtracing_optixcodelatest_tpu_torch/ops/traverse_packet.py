"""The packet walk of the threaded BVH (counterpart of the JAX package's
``ops/traverse_packet.py``): packets of ``packet_size`` consecutive rays
share one node pointer. A packet descends where any of its rays hits the
node's box, and tests each of its rays at every leaf it reaches, so each
ray still sees every node it needs: the answers are the per-ray walk's
(``ops/traverse_threaded.py``), but where a ray's own float32 slab test
rejects by rounding a leaf whose triangle the ray hits, and another ray
leads the packet there. The packet walk then finds that triangle, as
brute force does, and the per-ray walk does not (JAX's packet walk alike;
ROADMAP.md section 3). The link tables' octant is chosen per packet, by
the sign of the packet's summed direction.

Two nested loops, as JAX's: the inner one steps every packet that sits on
an internal node through slab tests only, until each live packet sits on a
leaf or at END; the outer one then tests the leaves' triangles
(``leaf_cap`` of them a leaf) for the packets on leaves. ``steps`` counts
the iterations of both. Each loop works on the packets it steps only
(one host sync an iteration). Padding rays are inactive and never reach
the results.

A plain PyTorch oracle beside K1/K2/K3, on no render path; it runs on the
device of the tensors it is given.
"""

from __future__ import annotations

import torch

from fovpathtracing_optixcodelatest_tpu_torch.ops.bvh import BVH, LEAF_SIZE
from fovpathtracing_optixcodelatest_tpu_torch.ops.intersect import ray_triangle
from fovpathtracing_optixcodelatest_tpu_torch.ops.traverse_threaded import (
    _inv_dir,
    check_device,
    gather_node,
)

DEFAULT_PACKET = 256


def _pad_packets(x, r, fill):
    n = x.shape[0]
    pad = (-n) % r
    if pad:
        x = torch.cat([x, torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype,
                                     device=x.device)])
    return x, n + pad


def _packet_octant(direction_kr3):
    """Majority direction octant per packet, from the summed direction."""
    mean = direction_kr3.sum(dim=1)  # (K, 3)
    return ((mean[:, 0] < 0).long() + 2 * (mean[:, 1] < 0).long()
            + 4 * (mean[:, 2] < 0).long())


def _slab_any(lo, hi, origin, inv_d, tmin, tlimit, lane_ok):
    """(K, 3) node boxes against (K, R, 3) rays -> each packet's any-hit."""
    t0 = (lo[:, None, :] - origin) * inv_d
    t1 = (hi[:, None, :] - origin) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    hit = (tn <= tf) & (tf >= tmin) & (tn <= tlimit) & lane_ok
    return hit.any(dim=1)


def _packets(bvh: BVH, origin, direction, active, packet_size, leaf_cap):
    """Pad to whole packets and lay the rays out (K, R)."""
    check_device(bvh, origin)
    n0, r, dev = origin.shape[0], packet_size, origin.device
    if active is None:
        active = torch.ones((n0,), dtype=torch.bool, device=dev)
    origin, n = _pad_packets(origin, r, 0.0)
    direction, _ = _pad_packets(direction, r, 1.0)
    active, _ = _pad_packets(active, r, False)
    k, m = n // r, bvh.num_nodes
    o = origin.reshape(k, r, 3)
    d = direction.reshape(k, r, 3)
    lane_ok = active.reshape(k, r)
    node = torch.where(lane_ok.any(dim=1), 0, m).long()
    return dict(n0=n0, k=k, m=m, o=o, d=d, lane_ok=lane_ok, inv_d=_inv_dir(d),
                oct_base=_packet_octant(d) * m, node=node,
                lcap=int(leaf_cap) if leaf_cap else LEAF_SIZE)


def _on(bvh: BVH, p: dict, leaf: bool):
    """Indices of the packets on a leaf (``leaf``) or on an internal node."""
    node, m = p["node"], p["m"]
    count = bvh.tri_count[node.clamp(max=m - 1)]
    return torch.nonzero((node < m) & ((count > 0) == leaf)).squeeze(1)


def _leaf_tests(bvh: BVH, p: dict, idx, tmin, tmax, cull_backface=False):
    """Möller-Trumbore of each ray of packets ``idx`` against its packet's
    leaf -> (t, u, v, hit) (K', R, lcap), the node's miss links and
    offsets."""
    _, _, count, offset, _, missl = gather_node(
        bvh, p["node"][idx], p["oct_base"][idx])
    ks = torch.arange(p["lcap"], device=idx.device)
    slots = offset.long()[:, None] + ks[None, :]
    in_leaf = ks[None, :] < count[:, None]
    slots_c = slots.clamp(0, bvh.tri_v0.shape[0] - 1)
    t, u, v, hit = ray_triangle(
        p["o"][idx][:, :, None, :], p["d"][idx][:, :, None, :],
        bvh.tri_v0[slots_c][:, None], bvh.tri_e1[slots_c][:, None],
        bvh.tri_e2[slots_c][:, None], tmin, tmax,
        cull_backface=cull_backface)
    return t, u, v, hit & in_leaf[:, None, :], missl, offset


def closest_hit(bvh: BVH, origin: torch.Tensor, direction: torch.Tensor,
                tmin: float, tmax: float, active=None,
                packet_size: int = DEFAULT_PACKET, leaf_cap: int = None
                ) -> dict:
    """Packet closest hit: the contract of ``traverse_threaded.closest_hit``
    (its hits but on the rounding lanes of the module docstring; ``steps``
    counts both loops' iterations)."""
    p = _packets(bvh, origin, direction, active, packet_size, leaf_cap)
    k, r, m, dev = p["k"], packet_size, p["m"], origin.device
    t = torch.full((k, r), float("inf"), dtype=torch.float32, device=dev)
    u = torch.zeros((k, r), dtype=torch.float32, device=dev)
    v = torch.zeros((k, r), dtype=torch.float32, device=dev)
    slot = torch.full((k, r), -1, dtype=torch.long, device=dev)
    leaf_len = bvh.tri_v0.shape[0]
    steps = 0
    while bool((p["node"] < m).any()):
        inner = _on(bvh, p, leaf=False)
        while inner.numel():
            lo, hi, _, _, hitl, missl = gather_node(
                bvh, p["node"][inner], p["oct_base"][inner])
            any_hit = _slab_any(lo, hi, p["o"][inner], p["inv_d"][inner],
                                tmin, torch.clamp(t[inner], max=tmax),
                                p["lane_ok"][inner])
            p["node"][inner] = torch.where(any_hit, hitl, missl)
            steps += 1
            inner = _on(bvh, p, leaf=False)
        # every live packet now sits on a leaf
        idx = _on(bvh, p, leaf=True)
        lt, lu, lv, lhit, missl, offset = _leaf_tests(bvh, p, idx, tmin, tmax)
        lhit = lhit & p["lane_ok"][idx][:, :, None]
        lt = torch.where(lhit, lt, float("inf"))
        j = torch.argmin(lt, dim=2, keepdim=True)  # (K', R, 1)
        tbest = lt.gather(2, j)[:, :, 0]
        t_i = t[idx]
        better = tbest < t_i
        t[idx] = torch.where(better, tbest, t_i)
        u[idx] = torch.where(better, lu.gather(2, j)[:, :, 0], u[idx])
        v[idx] = torch.where(better, lv.gather(2, j)[:, :, 0], v[idx])
        slot_best = (offset.long()[:, None] + j[:, :, 0]).clamp(
            0, leaf_len - 1)
        slot[idx] = torch.where(better, slot_best, slot[idx])
        p["node"][idx] = missl
        steps += 1
    n0 = p["n0"]
    slot = slot.reshape(-1)[:n0]
    hit = slot >= 0
    tri_id = torch.where(hit, bvh.tri_perm[slot.clamp(min=0)], -1)
    return {"t": t.reshape(-1)[:n0], "tri_id": tri_id.to(torch.int32),
            "u": u.reshape(-1)[:n0], "v": v.reshape(-1)[:n0], "hit": hit,
            "steps": steps}


def occluded(bvh: BVH, origin: torch.Tensor, direction: torch.Tensor,
             tmin: float, tmax: float, active=None,
             packet_size: int = DEFAULT_PACKET, leaf_cap: int = None
             ) -> torch.Tensor:
    """Packet any-hit occlusion with back-face culling; a packet stops once
    every live lane is occluded. Returns (N,) bool."""
    p = _packets(bvh, origin, direction, active, packet_size, leaf_cap)
    m, lane_ok = p["m"], p["lane_ok"]
    occ = torch.zeros_like(lane_ok)
    while bool((p["node"] < m).any()):
        inner = _on(bvh, p, leaf=False)
        while inner.numel():
            lo, hi, _, _, hitl, missl = gather_node(
                bvh, p["node"][inner], p["oct_base"][inner])
            pending = lane_ok[inner] & ~occ[inner]
            any_hit = _slab_any(lo, hi, p["o"][inner], p["inv_d"][inner],
                                tmin, tmax, pending)
            p["node"][inner] = torch.where(any_hit, hitl, missl)
            inner = _on(bvh, p, leaf=False)
        idx = _on(bvh, p, leaf=True)
        _, _, _, lhit, missl, _ = _leaf_tests(bvh, p, idx, tmin, tmax,
                                              cull_backface=True)
        ok = lane_ok[idx]
        occ_i = occ[idx] | (lhit & (ok & ~occ[idx])[:, :, None]).any(dim=2)
        occ[idx] = occ_i
        done = ~(ok & ~occ_i).any(dim=1)
        p["node"][idx] = torch.where(done, m, missl)
    return occ.reshape(-1)[:p["n0"]]
