"""The binned-SAH binary BVH and its stackless threaded layout (counterpart
of the JAX package's ``ops/bvh.py``: host numpy, bit-identical output).

``build_bvh2`` is the binary build both this layout and the pure-Python
wide collapse (``ops/bvh8.collapse_bvh2``) start from: binned SAH over 16
bins on the widest centroid axis, a stable median split where SAH finds
none. ``flatten_bvh`` numbers the nodes in DFS preorder and threads them
once per ray-direction octant (octant bit a = sign of dir[a]): a walk
follows ``hit_link`` after a box hit and ``miss_link`` after a miss or a
leaf, near child first for its octant, until it reaches the END sentinel
``num_nodes``. Leaf triangles lie contiguous in the leaf order;
``tri_perm`` maps a slot back to the original triangle id.

The walks over this layout (``ops/traverse_threaded.py``,
``ops/traverse_packet.py``) are test oracles beside K1/K2/K3; no render
path uses them. The builder keeps numpy's dtypes and the order of every
operation of the JAX builder, because the SAH decides its splits from
float sums and comparisons: another rounding gives a valid tree that is
not JAX's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

LEAF_SIZE = 4  # max triangles per leaf
NUM_SAH_BINS = 16


@dataclasses.dataclass
class _BuildNode:
    lo: np.ndarray
    hi: np.ndarray
    start: int  # range into the primitive order array
    count: int  # 0 for internal
    left: int = -1
    right: int = -1
    axis: int = 0  # split axis (orders the children per octant)


def build_bvh2(tris: np.ndarray, leaf_size: int = LEAF_SIZE):
    """Binned-SAH binary BVH over (T, 3, 3) float32 triangle corners
    -> (nodes: list[_BuildNode], order: (T,) permutation of triangle ids)."""
    t_count = tris.shape[0]
    lo_all = tris.min(axis=1)
    hi_all = tris.max(axis=1)
    centroid = 0.5 * (lo_all + hi_all)
    order = np.arange(t_count, dtype=np.int64)
    nodes: list[_BuildNode] = []

    def make_node(start: int, count: int) -> int:
        ids = order[start: start + count]
        nodes.append(_BuildNode(lo=lo_all[ids].min(axis=0),
                                hi=hi_all[ids].max(axis=0),
                                start=start, count=count))
        return len(nodes) - 1

    def sa(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                      + d[:, 2] * d[:, 0])

    stack = [make_node(0, t_count)]
    while stack:
        ni = stack.pop()
        node = nodes[ni]
        count = node.count
        if count <= leaf_size:
            continue  # stays a leaf
        start = node.start
        ids = order[start: start + count]
        cen = centroid[ids]
        cmin = cen.min(axis=0)
        cmax = cen.max(axis=0)
        ext = cmax - cmin
        axis = int(np.argmax(ext))
        mid = 0
        if ext[axis] > 1e-12:
            nb = NUM_SAH_BINS
            scale = nb * (1.0 - 1e-6) / ext[axis]
            bin_ids = np.clip(
                ((cen[:, axis] - cmin[axis]) * scale).astype(np.int64), 0,
                nb - 1)
            bin_lo = np.full((nb, 3), np.inf)
            bin_hi = np.full((nb, 3), -np.inf)
            bin_n = np.zeros(nb, dtype=np.int64)
            np.add.at(bin_n, bin_ids, 1)
            for a in range(3):
                np.minimum.at(bin_lo[:, a], bin_ids, lo_all[ids][:, a])
                np.maximum.at(bin_hi[:, a], bin_ids, hi_all[ids][:, a])
            lcount = np.cumsum(bin_n)[:-1]
            rcount = count - lcount
            llo = np.minimum.accumulate(bin_lo, axis=0)[:-1]
            lhi = np.maximum.accumulate(bin_hi, axis=0)[:-1]
            rlo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1][1:]
            rhi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1][1:]
            cost = np.where((lcount > 0) & (rcount > 0),
                            sa(llo, lhi) * lcount + sa(rlo, rhi) * rcount,
                            np.inf)
            best = int(np.argmin(cost))
            if np.isfinite(cost[best]):
                left_mask = bin_ids <= best
                mid = int(left_mask.sum())
                if 0 < mid < count:
                    seg = ids.copy()
                    order[start: start + mid] = seg[left_mask]
                    order[start + mid: start + count] = seg[~left_mask]
                else:
                    mid = 0
        if mid == 0:
            # median split by centroid order (degenerate or SAH-failed)
            mid = count // 2
            key = np.argsort(cen[:, axis], kind="stable")
            order[start: start + count] = ids[key]
        li = make_node(start, mid)
        ri = make_node(start + mid, count - mid)
        node.left, node.right, node.axis, node.count = li, ri, axis, 0
        stack.append(li)
        stack.append(ri)
    return nodes, order


@dataclasses.dataclass(frozen=True)
class BVH:
    """Threaded BVH, node arrays in DFS preorder: numpy arrays from
    ``build``, tensors after ``to``. ``hit_link``/``miss_link`` (8, M) hold
    one threading per ray-direction octant; ``num_nodes`` is the END
    sentinel. Leaf slots index ``tri_v0/e1/e2``; ``tri_perm`` maps a slot
    to its original triangle id (-1 = padding)."""

    aabb_lo: np.ndarray  # (M, 3) float32
    aabb_hi: np.ndarray  # (M, 3) float32
    hit_link: np.ndarray  # (8, M) int32
    miss_link: np.ndarray  # (8, M) int32
    tri_offset: np.ndarray  # (M,) int32 (valid for leaves)
    tri_count: np.ndarray  # (M,) int32 (0 = internal)
    tri_v0: np.ndarray  # (Tp, 3) float32, leaf-ordered
    tri_e1: np.ndarray
    tri_e2: np.ndarray
    tri_perm: np.ndarray  # (Tp,) int32

    @property
    def num_nodes(self) -> int:
        return self.aabb_lo.shape[0]

    def to(self, device="cuda") -> "BVH":
        """The same BVH with every array a tensor on ``device``."""
        return BVH(**{f.name: torch.as_tensor(getattr(self, f.name),
                                              device=device)
                      for f in dataclasses.fields(self)})


def flatten_bvh(nodes, order, tris: np.ndarray) -> BVH:
    """Flatten the build tree: preorder numbering, the 8 octant link
    tables and leaf-contiguous triangle slots."""
    m = len(nodes)
    pre_index = np.full(m, -1, dtype=np.int64)
    preorder = []
    stack = [0]
    while stack:
        ni = stack.pop()
        pre_index[ni] = len(preorder)
        preorder.append(ni)
        n = nodes[ni]
        if n.count == 0:
            stack.append(n.right)
            stack.append(n.left)
    assert len(preorder) == m

    aabb_lo = np.stack([nodes[ni].lo for ni in preorder]).astype(np.float32)
    aabb_hi = np.stack([nodes[ni].hi for ni in preorder]).astype(np.float32)
    counts = np.asarray([nodes[ni].count for ni in preorder], dtype=np.int32)

    hit_link = np.zeros((8, m), dtype=np.int32)
    miss_link = np.zeros((8, m), dtype=np.int32)
    for o in range(8):
        stack2 = [(0, m)]  # (build node id, miss target in preorder numbers)
        while stack2:
            ni, miss = stack2.pop()
            p = pre_index[ni]
            miss_link[o, p] = miss
            n = nodes[ni]
            if n.count > 0:
                hit_link[o, p] = miss  # leaf: go on after its triangles
                continue
            first, second = n.left, n.right
            # the left child covers the low side of the split axis, so rays
            # with a negative direction on that axis visit the right first
            if (o >> n.axis) & 1:
                first, second = second, first
            hit_link[o, p] = pre_index[first]
            stack2.append((first, pre_index[second]))
            stack2.append((second, miss))

    slot_of = np.zeros(m, dtype=np.int32)
    total = 0
    for p, ni in enumerate(preorder):
        if nodes[ni].count > 0:
            slot_of[p] = total
            total += nodes[ni].count
    total = max(total, 1)
    tri_v0 = np.zeros((total, 3), dtype=np.float32)
    tri_e1 = np.zeros_like(tri_v0)
    tri_e2 = np.zeros_like(tri_v0)
    tri_perm = np.full(total, -1, dtype=np.int32)
    for p, ni in enumerate(preorder):
        n = nodes[ni]
        if n.count > 0:
            ids = order[n.start: n.start + n.count]
            s = slot_of[p]
            tri_v0[s: s + n.count] = tris[ids, 0]
            tri_e1[s: s + n.count] = tris[ids, 1] - tris[ids, 0]
            tri_e2[s: s + n.count] = tris[ids, 2] - tris[ids, 0]
            tri_perm[s: s + n.count] = ids

    return BVH(aabb_lo=aabb_lo, aabb_hi=aabb_hi, hit_link=hit_link,
               miss_link=miss_link, tri_offset=slot_of, tri_count=counts,
               tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2,
               tri_perm=tri_perm)


def build(tris: np.ndarray, leaf_size: int = LEAF_SIZE) -> BVH:
    """The threaded BVH of (T, 3, 3) triangle corners, on the host
    (``BVH.to`` moves it to a device)."""
    nodes, order = build_bvh2(tris, leaf_size)
    return flatten_bvh(nodes, order, tris)
