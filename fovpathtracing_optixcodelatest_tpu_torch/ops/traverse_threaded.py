"""The per-ray walk of the stackless threaded BVH (counterpart of the JAX
package's ``ops/traverse.py``; this module takes another name because the
port's ``ops/traverse.py`` holds the K1/K2 wrappers).

Every ray carries one node pointer into ``ops/bvh.BVH``: a step gathers its
node, runs a slab test against the node's box, tests up to ``LEAF_SIZE``
triangles where the node is a leaf, and follows the octant's hit or miss
link. A ray is done when it reaches the END sentinel ``num_nodes``.
``steps`` counts the lockstep iterations as JAX's ``lax.while_loop``
does: until no ray is left, or ``max_steps``.

These walks are plain PyTorch oracles for K1, K2 and K3 on an independent
tree; no render path runs them. The loop is a Python ``while`` that reads
the live lanes back once a step (one host sync a step) and works on those
lanes only, which leaves every result as the lockstep walk computes it.
The walks run on the device of the tensors they are given.
"""

from __future__ import annotations

import torch

from fovpathtracing_optixcodelatest_tpu_torch.ops.bvh import BVH, LEAF_SIZE
from fovpathtracing_optixcodelatest_tpu_torch.ops.intersect import ray_triangle

MAX_STEPS = 1 << 30


def check_device(bvh: BVH, origin: torch.Tensor) -> None:
    """Refuse a BVH that is not on the rays' device (``BVH.to`` moves it)."""
    table = bvh.aabb_lo
    if not isinstance(table, torch.Tensor) or table.device != origin.device:
        where = getattr(table, "device", "the host (numpy)")
        raise ValueError(f"the BVH is on {where} and the rays on "
                         f"{origin.device}: call bvh.to(device) first")


def _inv_dir(direction):
    d = direction
    safe = torch.where(d.abs() < 1e-12, torch.where(d < 0, -1e-12, 1e-12), d)
    return 1.0 / safe


def _octant(direction):
    return ((direction[:, 0] < 0).long() + 2 * (direction[:, 1] < 0).long()
            + 4 * (direction[:, 2] < 0).long())


def _slab_test(lo, hi, origin, inv_d, tmin, tlimit):
    t0 = (lo - origin) * inv_d
    t1 = (hi - origin) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    return (tn <= tf) & (tf >= tmin) & (tn <= tlimit)


def _leaf_intersect(bvh: BVH, offset, count, origin, direction, tmin, tmax,
                    cull_backface: bool):
    """Masked ``LEAF_SIZE``-wide triangle test -> (t, u, v, slot, hit) of
    each ray's closest candidate in its leaf; ``torch.argmin`` picks the
    first of equal minima, as ``jnp.argmin`` does (an all-inf row picks
    slot 0, whose hit is False)."""
    ks = torch.arange(LEAF_SIZE, device=origin.device)
    slots = offset.long()[:, None] + ks[None, :]
    in_leaf = ks[None, :] < count[:, None]
    slots_c = slots.clamp(0, bvh.tri_v0.shape[0] - 1)
    t, u, v, hit = ray_triangle(
        origin[:, None, :], direction[:, None, :], bvh.tri_v0[slots_c],
        bvh.tri_e1[slots_c], bvh.tri_e2[slots_c], tmin, tmax,
        cull_backface=cull_backface)
    hit = hit & in_leaf
    t = torch.where(hit, t, float("inf"))
    k = torch.argmin(t, dim=1, keepdim=True)
    pick = lambda x: x.gather(1, k)[:, 0]  # noqa: E731
    return pick(t), pick(u), pick(v), pick(slots_c), pick(hit)


def _start(bvh: BVH, origin, active):
    """(per-lane start node, END for inactive lanes; the END sentinel)."""
    check_device(bvh, origin)
    n, m = origin.shape[0], bvh.num_nodes
    node = torch.zeros((n,), dtype=torch.long, device=origin.device)
    if active is not None:
        node = torch.where(active, node, m)
    return node, m


def gather_node(bvh: BVH, node, oct_base):
    """The boxes, triangle counts and offsets, and the octant's hit and
    miss links of ``node`` (every entry < END)."""
    return (bvh.aabb_lo[node], bvh.aabb_hi[node], bvh.tri_count[node],
            bvh.tri_offset[node],
            bvh.hit_link.reshape(-1)[oct_base + node].long(),
            bvh.miss_link.reshape(-1)[oct_base + node].long())


def closest_hit(bvh: BVH, origin: torch.Tensor, direction: torch.Tensor,
                tmin: float, tmax: float, max_steps: int = MAX_STEPS,
                active=None) -> dict:
    """Closest-hit walk. ``active`` (optional (N,) bool) starts dead lanes
    at END. Returns dict: t (N,), tri_id (N,) int32 original ids (-1 miss),
    u, v, hit (N,) bool, steps (int: the lockstep iterations)."""
    node, m = _start(bvh, origin, active)
    n, dev = origin.shape[0], origin.device
    inv_d = _inv_dir(direction)
    oct_base = _octant(direction) * m
    t = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    u = torch.zeros((n,), dtype=torch.float32, device=dev)
    v = torch.zeros((n,), dtype=torch.float32, device=dev)
    slot = torch.full((n,), -1, dtype=torch.long, device=dev)
    live = torch.nonzero(node < m).squeeze(1)
    steps = 0
    while live.numel() and steps < max_steps:
        o, d, nc = origin[live], direction[live], node[live]
        lo, hi, count, offset, hitl, missl = gather_node(bvh, nc,
                                                         oct_base[live])
        t_l = t[live]
        aabb_hit = _slab_test(lo, hi, o, inv_d[live], tmin,
                              torch.clamp(t_l, max=tmax))
        lt, lu, lv, lslot, lhit = _leaf_intersect(
            bvh, offset, count, o, d, tmin, tmax, cull_backface=False)
        take = (count > 0) & aabb_hit & lhit & (lt < t_l)
        t[live] = torch.where(take, lt, t_l)
        u[live] = torch.where(take, lu, u[live])
        v[live] = torch.where(take, lv, v[live])
        slot[live] = torch.where(take, lslot, slot[live])
        nxt = torch.where(aabb_hit, hitl, missl)
        node[live] = nxt
        steps += 1
        live = live[nxt < m]
    hit = slot >= 0
    tri_id = torch.where(hit, bvh.tri_perm[slot.clamp(min=0)], -1)
    return {"t": t, "tri_id": tri_id.to(torch.int32), "u": u, "v": v,
            "hit": hit, "steps": steps}


def occluded(bvh: BVH, origin: torch.Tensor, direction: torch.Tensor,
             tmin: float, tmax: float, max_steps: int = MAX_STEPS,
             active=None) -> torch.Tensor:
    """Any-hit occlusion with back-face culling; a ray stops at its first
    hit. Returns (N,) bool."""
    node, m = _start(bvh, origin, active)
    inv_d = _inv_dir(direction)
    oct_base = _octant(direction) * m
    occ = torch.zeros((origin.shape[0],), dtype=torch.bool,
                      device=origin.device)
    live = torch.nonzero(node < m).squeeze(1)
    steps = 0
    while live.numel() and steps < max_steps:
        o, d, nc = origin[live], direction[live], node[live]
        lo, hi, count, offset, hitl, missl = gather_node(bvh, nc,
                                                         oct_base[live])
        aabb_hit = _slab_test(lo, hi, o, inv_d[live], tmin, tmax)
        lhit = _leaf_intersect(bvh, offset, count, o, d, tmin, tmax,
                               cull_backface=True)[4]
        occ_l = (count > 0) & aabb_hit & lhit
        occ[live] = occ_l
        # an occluded ray jumps straight to END
        nxt = torch.where(occ_l, m, torch.where(aabb_hit, hitl, missl))
        node[live] = nxt
        steps += 1
        live = live[nxt < m]
    return occ
