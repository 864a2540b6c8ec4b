"""The reference's own acceleration structure and queries: a complete tree
of arity ``ARITY`` over the triangles in Morton order of their centroids,
``LEAF`` triangles a leaf, stored level by level (node j of a level has
children ARITY j ... ARITY j + ARITY - 1 on the next). A query walks it
breadth first for all rays at once, level by level: the (ray, node) pairs
whose boxes the ray's [tmin, tmax] segment pierces, with no ordering and
no culling by the nearest hit, so that a level costs a few large gathers
rather than a step a node. Möller-Trumbore in the same operation order as
the port's kernels, so a triangle's t, u and v agree to the bit; the tree,
its order and its tie rule (the least triangle id among equal t) are its
own.
"""

from __future__ import annotations

import torch

ARITY = 8
LEAF = 8
_MORTON_BITS = 10
PAIRS = 1 << 22  # (ray, node) pairs a slice takes (a level expands it ARITY-fold)


def _spread_bits(x: torch.Tensor) -> torch.Tensor:
    """10-bit integers -> their bits spread three apart (30-bit Morton)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def safe_inv(d: torch.Tensor) -> torch.Tensor:
    tiny = torch.where(d < 0, -1e-12, 1e-12).to(d.dtype)
    return 1.0 / torch.where(d.abs() < 1e-12, tiny, d)


def tri_test(v0, e1, e2, o, d, tmin: float, tmax: float, cull: bool):
    """Möller-Trumbore of triangles against rays (broadcasting (..., 3))
    -> (hit, t, u, v)."""
    v0x, v0y, v0z = v0.unbind(-1)
    e1x, e1y, e1z = e1.unbind(-1)
    e2x, e2y, e2z = e2.unbind(-1)
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = det > 1e-9 if cull else det.abs() > 1e-9
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= tmin) & (t <= tmax))
    return hit, t, u, v


def _slices(n: int, size: int):
    for s in range(0, n, size):
        yield slice(s, min(n, s + size))


class RefBVH:
    """Build from (T, 3) ``v0``, ``e1``, ``e2`` on their device and dtype."""

    def __init__(self, v0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor):
        dev, dt = v0.device, v0.dtype
        self.v0, self.e1, self.e2 = v0, e1, e2
        t = v0.shape[0]
        f32 = lambda a: a.to(torch.float32)  # noqa: E731
        corners = torch.stack([f32(v0), f32(v0) + f32(e1), f32(v0) + f32(e2)],
                              dim=1)
        cen = corners.mean(dim=1)
        lo, hi = cen.amin(dim=0), cen.amax(dim=0)
        q = ((cen - lo) / torch.clamp(hi - lo, min=1e-20)
             * ((1 << _MORTON_BITS) - 1)).to(torch.int64)
        code = (_spread_bits(q[:, 0]) << 2) | (_spread_bits(q[:, 1]) << 1) \
            | _spread_bits(q[:, 2])
        order = torch.argsort(code, stable=True)
        n_leaf = max(1, -(-t // LEAF))
        self.depth, n = 0, 1
        while n < n_leaf:
            n *= ARITY
            self.depth += 1
        slots = torch.full((n * LEAF,), -1, dtype=torch.int64, device=dev)
        slots[:t] = order
        self.slots = slots.view(n, LEAF)
        big = torch.tensor(3.0e38, device=dev)
        blo = torch.full((n, 3), 3.0e38, device=dev)
        bhi = torch.full((n, 3), -3.0e38, device=dev)
        for k in range(LEAF):  # a leaf's box: its triangles' corners
            tid = self.slots[:, k]
            c = corners[torch.clamp(tid, min=0)]
            real = (tid >= 0)[:, None, None]
            blo = torch.minimum(blo, torch.where(real, c, big).amin(dim=1))
            bhi = torch.maximum(bhi, torch.where(real, c, -big).amax(dim=1))
        # pad each box by a rounding margin: the tested triangle is the one
        # v0, e1, e2 span, whose corners the float sums above round
        pad = (blo.abs().maximum(bhi.abs()) + 1.0) * 1e-6
        lo_l, hi_l = blo - pad, bhi + pad
        valid = self.slots[:, 0] >= 0
        levels = [(lo_l, hi_l, valid)]
        while lo_l.shape[0] > 1:
            lo_l = lo_l.view(-1, ARITY, 3).amin(dim=1)
            hi_l = hi_l.view(-1, ARITY, 3).amax(dim=1)
            valid = valid.view(-1, ARITY).any(dim=1)
            levels.append((lo_l, hi_l, valid))
        self.levels = [(a.to(dt), b.to(dt), c) for a, b, c in levels[::-1]]

    def _pairs(self, o, inv, active, tmin: float, tmax: float):
        """(ray, leaf) pairs whose leaf box the ray's segment pierces."""
        rays = torch.nonzero(active).squeeze(1)
        nodes = torch.zeros_like(rays)
        kids = torch.arange(ARITY, device=o.device)
        for level, (lo, hi, valid) in enumerate(self.levels):
            out_r, out_n = [rays[:0]], [nodes[:0]]
            for s in _slices(rays.numel(), PAIRS):
                r, nd = rays[s], nodes[s]
                if level:  # expand to the children
                    r = r.repeat_interleave(ARITY)
                    nd = (nd[:, None] * ARITY + kids).reshape(-1)
                t0 = (lo[nd] - o[r]) * inv[r]
                t1 = (hi[nd] - o[r]) * inv[r]
                tn = torch.minimum(t0, t1).amax(dim=-1)
                tf = torch.maximum(t0, t1).amin(dim=-1)
                keep = (valid[nd] & (tn <= tf) & (tf >= tmin)
                        & (tn <= tmax))
                out_r.append(r[keep])
                out_n.append(nd[keep])
            rays, nodes = torch.cat(out_r), torch.cat(out_n)
        return rays, nodes

    def _leaf_tests(self, o, d, rays, leaves, tmin, tmax, cull):
        """Per slice of pairs: (rays, triangle ids (K, LEAF), hit, t)."""
        for s in _slices(rays.numel(), PAIRS):
            r = rays[s]
            tids = self.slots[leaves[s]]
            safe = torch.clamp(tids, min=0)
            hit, t, _, _ = tri_test(self.v0[safe], self.e1[safe],
                                    self.e2[safe], o[r, None], d[r, None],
                                    tmin, tmax, cull)
            yield r, tids, hit & (tids >= 0), t

    def closest_hit(self, o, d, active, tmin: float, tmax: float) -> dict:
        """-> dict(t, tri_id int64 (-1 = miss), u, v, hit): the least t,
        and of equal t the least triangle id."""
        n, dev, dt = o.shape[0], o.device, o.dtype
        rays, leaves = self._pairs(o, safe_inv(d), active, tmin, tmax)
        best_t = torch.full((n,), float("inf"), dtype=dt, device=dev)
        for r, _, hit, t in self._leaf_tests(o, d, rays, leaves, tmin, tmax,
                                             False):
            t = torch.where(hit, t, float("inf")).amin(dim=1)
            best_t.scatter_reduce_(0, r, t, reduce="amin")
        none = 1 << 62
        best = torch.full((n,), none, dtype=torch.int64, device=dev)
        for r, tids, hit, t in self._leaf_tests(o, d, rays, leaves, tmin,
                                                tmax, False):
            at = hit & (t == best_t[r, None])
            best.scatter_reduce_(0, r, torch.where(at, tids, none).amin(dim=1),
                                 reduce="amin")
        hit = best < none
        best = torch.where(hit, best, -1)
        safe = torch.clamp(best, min=0)
        _, t, u, v = tri_test(self.v0[safe], self.e1[safe], self.e2[safe], o,
                              d, tmin, tmax, False)
        zero = torch.zeros_like(t)
        return {"t": torch.where(hit, t, float("inf")), "tri_id": best,
                "u": torch.where(hit, u, zero), "v": torch.where(hit, v, zero),
                "hit": hit}

    def occluded(self, o, d, active, tmin: float, tmax: float) -> torch.Tensor:
        """Any hit of a front face (back faces cull) -> (N,) bool."""
        rays, leaves = self._pairs(o, safe_inv(d), active, tmin, tmax)
        occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
        for r, _, hit, _ in self._leaf_tests(o, d, rays, leaves, tmin, tmax,
                                             True):
            occ[r[hit.any(dim=1)]] = True
        return occ
