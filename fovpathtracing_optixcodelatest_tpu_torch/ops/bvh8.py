"""Packed wide BVH tables (counterpart of the JAX package's ``ops/bvh8.py``:
the single-level layout, the node and region writers the two-level table
of ``ops/tlas.py`` shares, and the pure-Python wide builder
``collapse_bvh2``/``build``/``build_legacy8``; host numpy, bit-identical
output).

Packed (default A16/L6) layout, W = max(4A, 10L) float32 columns:

- node rows (first M rows): cols [3c + a] hold child c's axis-a bounds as a
  conservative bf16 pair in one uint32, ``lo = u & 0xFFFF0000`` (rounded
  toward -inf) and ``hi = u << 16`` (rounded toward +inf); cols [3A + c]
  hold the child's entry code ("ucode") ``(row << 2) | kind`` as int32
  (kind 0 internal, 1 leaf, 2 instance in a TLAS row, ``ops/tlas.py``;
  0 = empty slot, since the root is nobody's child).
- leaf rows: L triangles ``[v0, e1, e2]`` (9 floats each; unused slots all
  zero, so det == 0 never hits), then cols [9L + k] the ORIGINAL triangle id
  of slot k as int32 (-1 pad).

Legacy 8-wide layout (``pack_wide_legacy8``, the packet kernel's table): 8
children x [lo3, hi3] float32 (48 cols) then 8 x [a, kind] int32 (16 cols),
kind 0 internal (a = node row), 1 leaf (a = leaf row), -1 empty; leaf rows
hold 4 triangles x 9 floats.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fovpathtracing_optixcodelatest_tpu_torch.ops.bvh import build_bvh2

ARITY = 16
LEAF_SIZE = 6
KIND_NODE, KIND_LEAF, KIND_INST = 0, 1, 2
EMPTY = np.int32(0)

WIDTH8 = 8
LEAF_SIZE8 = 4


@dataclasses.dataclass(frozen=True)
class WideBVH:
    """Host-side packed table plus its static traversal facts."""

    table: np.ndarray  # (U, W) float32
    leaf_perm: np.ndarray  # (U, leaf_size) int32
    leaf_size: int = LEAF_SIZE
    arity: int = ARITY
    packed: bool = True
    # exact worst-case stack occupancy (+1 safety entry)
    stack_depth: int = 28
    # two-level tables (ops/tlas.py): instance rows [inst_base, blas_base)
    num_instances: int = 0
    inst_base: int = 0
    blas_base: int = 0

    @property
    def num_rows(self) -> int:
        return self.table.shape[0]


def codebits(num_rows: int) -> int:
    """Bit width of the ucode field in a packed (tn | ucode) stack entry."""
    return max(int(num_rows - 1).bit_length() + 2, 3)


def _bf16_down_bits(x: np.ndarray) -> np.ndarray:
    """uint32 bf16-aligned bits of the largest bf16 <= x (finite x)."""
    x = np.asarray(x, dtype=np.float32)
    t = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    need = t > x
    b = t.view(np.uint32)
    sign = (b & np.uint32(0x80000000)) != 0
    stepped = np.where(
        sign,
        b + np.uint32(0x10000),
        np.where(b == 0, np.uint32(0x80010000), b - np.uint32(0x10000)),
    )
    out = np.where(need, stepped, b)
    return out & np.uint32(0xFFFF0000)


def _bf16_up_bits(x: np.ndarray) -> np.ndarray:
    """uint32 bf16-aligned bits of the smallest bf16 >= x (finite x)."""
    neg = _bf16_down_bits(-np.asarray(x, dtype=np.float32))
    return neg ^ np.uint32(0x80000000)


def _leaf_triangles(meta, tris, order_slots, leaf_size):
    """Per leaf slot: (lw, ls, tid (L, leaf_size), packed (L, leaf_size, 9))."""
    counts = meta[..., 1]
    a_vals = meta[..., 0]
    lw, ls = np.nonzero(counts > 0)
    if not len(lw):
        return lw, ls, None, None
    offs = a_vals[lw, ls].astype(np.int64)
    cnts = counts[lw, ls].astype(np.int64)
    k = np.arange(leaf_size, dtype=np.int64)
    slot_idx = np.clip(offs[:, None] + k[None, :], 0, len(order_slots) - 1)
    valid = k[None, :] < cnts[:, None]
    tid = np.where(valid, order_slots[slot_idx], -1)
    p = tris[np.maximum(tid, 0)]
    v0 = p[:, :, 0]
    e1 = p[:, :, 1] - v0
    e2 = p[:, :, 2] - v0
    packed = np.concatenate([v0, e1, e2], axis=-1)
    packed[~valid] = 0.0
    return lw, ls, tid, packed


def pack_boxes_into(table: np.ndarray, row0: int, boxes: np.ndarray,
                    entry: np.ndarray, arity: int) -> None:
    """Write node rows (conservative bf16-pair boxes and entry codes) into
    ``table`` rows ``row0 .. row0 + M``: the single-level packing and the
    TLAS builder (``ops/tlas.py``) both go through here."""
    m = boxes.shape[0]
    lo = boxes[..., 0:3]
    hi = boxes[..., 3:6]
    finite = np.isfinite(lo) & np.isfinite(hi)
    lo_b = np.where(finite, _bf16_down_bits(np.where(finite, lo, 0.0)),
                    np.float32(np.inf).view(np.uint32) & np.uint32(0xFFFF0000))
    hi_b = np.where(finite, _bf16_up_bits(np.where(finite, hi, 0.0)),
                    (-np.float32(np.inf)).view(np.uint32) & np.uint32(0xFFFF0000))
    pair = (lo_b & np.uint32(0xFFFF0000)) | (hi_b >> np.uint32(16))
    table[row0: row0 + m, : 3 * arity] = (
        pair.astype(np.uint32).reshape(m, 3 * arity).view(np.float32)
    )
    table[row0: row0 + m, 3 * arity: 4 * arity] = (
        entry.astype(np.int32).view(np.float32)
    )


def pack_region_into(table, leaf_perm, row0, tri_base, boxes, meta, tris,
                     order_slots, leaf_size, arity):
    """Pack one collapsed wide BVH (node rows, then leaf rows) into ``table``
    from row ``row0``, entry codes offset by ``row0`` and triangle ids by
    ``tri_base`` -> (rows used, entry (M, A) absolute child codes)."""
    m = boxes.shape[0]
    counts = meta[..., 1]
    a_vals = meta[..., 0]
    entry = np.full((m, arity), EMPTY, dtype=np.int32)
    entry[counts == 0] = (a_vals[counts == 0] + row0) << 2
    lw, ls, tid, packed = _leaf_triangles(meta, tris, order_slots, leaf_size)
    if len(lw):
        lr0 = row0 + m
        table[lr0: lr0 + len(lw), : 9 * leaf_size] = packed.reshape(
            len(lw), 9 * leaf_size
        )
        gid = np.where(tid >= 0, tid + tri_base, -1).astype(np.int32)
        table[lr0: lr0 + len(lw), 9 * leaf_size: 10 * leaf_size] = (
            gid.view(np.float32)
        )
        leaf_perm[lr0: lr0 + len(lw)] = gid
        entry[lw, ls] = (
            (lr0 + np.arange(len(lw), dtype=np.int32)) << 2
        ) | KIND_LEAF
    pack_boxes_into(table, row0, boxes, entry, arity)
    return m + len(lw), entry


def pack_wide(boxes: np.ndarray, meta: np.ndarray, tris: np.ndarray,
              order_slots: np.ndarray, leaf_size: int,
              arity: int | None = None) -> WideBVH:
    """Pack (M, A, 6) boxes + (M, A, 2) meta ([a, count]: count > 0 leaf at
    slot offset a, 0 internal node a, -1 empty) + the leaf slot permutation
    into the packed single-level layout (node rows, then leaf rows)."""
    m, a_width = boxes.shape[0], boxes.shape[1]
    arity = a_width if arity is None else arity
    assert a_width == arity
    num_leaves = max(int((meta[..., 1] > 0).sum()), 1)
    u = m + num_leaves
    width = max(4 * arity, 10 * leaf_size)

    table = np.zeros((u, width), dtype=np.float32)
    table[:, 9 * leaf_size: 10 * leaf_size] = np.float32(
        np.int32(-1).view(np.float32)
    )
    leaf_perm = np.full((u, leaf_size), -1, dtype=np.int32)
    _, entry = pack_region_into(table, leaf_perm, 0, 0, boxes, meta, tris,
                                order_slots, leaf_size, arity)
    return WideBVH(
        table=table, leaf_perm=leaf_perm, leaf_size=leaf_size, arity=arity,
        packed=True, stack_depth=lifo_stack_bound(entry) + 1,
    )


def lifo_stack_bound(entry: np.ndarray, row0: int = 0) -> int:
    """Exact worst-case stack occupancy of the wide tree with child codes
    ``entry`` (M, A), whose internal codes address absolute rows from
    ``row0``: g(v) = c(v) - 1 + max(1, max over internal children u of
    g(u)), answer max(1, g(root)). An instance code takes a slot but has no
    subtree here (``ops/tlas.py`` adds the BLAS separately)."""
    m = entry.shape[0]
    if m == 0:
        return 1
    internal = (entry != EMPTY) & ((entry & 3) == KIND_NODE)
    child = np.where(internal, (entry >> 2) - row0, 0).astype(np.int64)
    valid = internal & (child >= 0) & (child < m)
    c = (entry != EMPTY).sum(axis=1).astype(np.int64)
    levels = []
    frontier = np.asarray([0], dtype=np.int64)
    seen = np.zeros(m, dtype=bool)
    seen[0] = True
    while frontier.size:
        levels.append(frontier)
        k = child[frontier][valid[frontier]]
        k = k[~seen[k]]
        if k.size:
            k = np.unique(k)
        seen[k] = True
        frontier = k
    g = np.zeros(m, dtype=np.int64)
    for lvl in reversed(levels):
        kid_g = np.where(valid[lvl], g[child[lvl]], 0)
        g[lvl] = c[lvl] - 1 + np.maximum(1, kid_g.max(axis=1))
    return int(max(1, g[0]))


def pack_wide_legacy8(boxes: np.ndarray, meta: np.ndarray, tris: np.ndarray,
                      order_slots: np.ndarray, leaf_size: int) -> WideBVH:
    """The legacy 8-wide full-f32 layout (see module docstring); stack depth
    is the full-tree closed form (8 - 1) * height + 2."""
    m = boxes.shape[0]
    counts = meta[..., 1]
    a_vals = meta[..., 0]
    lw, ls, tid, packed = _leaf_triangles(meta, tris, order_slots, leaf_size)
    num_leaves = max(len(lw), 1)
    u = m + num_leaves
    width = max(64, 9 * leaf_size)
    new_a = a_vals.copy()
    new_kind = np.where(counts > 0, 1, np.where(counts == 0, 0, -1)).astype(
        np.int32
    )
    table = np.zeros((u, width), dtype=np.float32)
    leaf_perm = np.full((u, leaf_size), -1, dtype=np.int32)
    if len(lw):
        table[m:, : 9 * leaf_size] = packed.reshape(len(lw), 9 * leaf_size)
        leaf_perm[m:] = tid.astype(np.int32)
        new_a[lw, ls] = m + np.arange(len(lw), dtype=np.int32)
    meta_packed = np.zeros((m, 8, 2), dtype=np.int32)
    meta_packed[..., 0] = new_a
    meta_packed[..., 1] = new_kind
    table[:m, :48] = boxes.reshape(m, 48)
    table[:m, 48:64] = meta_packed.reshape(m, 16).view(np.float32)

    height = 0
    frontier = np.asarray([0], dtype=np.int64)
    while frontier.size:
        kids = new_a[frontier]
        internal = new_kind[frontier] == 0
        frontier = kids[internal].astype(np.int64)
        height += 1
        if height > 64:
            break
    return WideBVH(
        table=table, leaf_perm=leaf_perm, leaf_size=leaf_size, arity=8,
        packed=False, stack_depth=(8 - 1) * height + 2,
    )


def _surface_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


def collapse_bvh2(tris: np.ndarray, leaf_size: int, arity: int):
    """The pure-Python wide collapse (the JAX package's ``collapse_bvh2``,
    bit for bit): ``ops/bvh.build_bvh2``, then each wide node opens its
    largest-area internal child while the group still fits ``arity``
    slots, sibling leaves merged first-fit decreasing into slots of up to
    ``leaf_size`` triangles. Returns (boxes (M, A, 6), meta (M, A, 2)
    [a, count], order_slots) in ``pack_wide``'s input convention.

    Not the native collapse's tree (``bvh_native.collapse``): the two
    builders split and group differently and give different tables of the
    same shape."""
    nodes, order = build_bvh2(tris, leaf_size)

    wide_slots: list[list] = []  # per wide node: its slot records
    wide_index: dict[int, int] = {}

    def leaf_bins(group):
        """The group's leaves merged first-fit decreasing into bins of up
        to ``leaf_size`` triangles."""
        bins: list[list] = []
        fill: list[int] = []
        for lid in sorted((c for c in group if nodes[c].count > 0),
                          key=lambda c: -nodes[c].count):
            lc = nodes[lid].count
            for k in range(len(fill)):
                if fill[k] + lc <= leaf_size:
                    fill[k] += lc
                    bins[k].append(lid)
                    break
            else:
                fill.append(lc)
                bins.append([lid])
        return bins

    def slots_needed(group):
        internals = sum(1 for c in group if nodes[c].count == 0)
        return internals + len(leaf_bins(group))

    def make_wide(b2: int) -> int:
        n = nodes[b2]
        group = [n.left, n.right] if n.count == 0 else [b2]
        while True:
            best, best_sa = -1, -1.0
            for i, c in enumerate(group):
                cn = nodes[c]
                if cn.count == 0:
                    sa = _surface_area(cn.lo, cn.hi)
                    if sa > best_sa:
                        best, best_sa = i, sa
            if best < 0:
                break
            cn = nodes[group[best]]
            trial = group[:best] + [cn.left, cn.right] + group[best + 1:]
            if slots_needed(trial) > arity:
                break
            group = trial
        # slot records: ("i", bvh2 node) internal | ("l", [leaf ids]) merged
        slots = ([("i", c) for c in group if nodes[c].count == 0]
                 + [("l", b) for b in leaf_bins(group)])
        wide_slots.append(slots)
        wide_index[b2] = len(wide_slots) - 1
        return wide_index[b2]

    queue = [make_wide(0)]
    while queue:
        w = queue.pop()
        for kind, payload in wide_slots[w]:
            if kind == "i" and payload not in wide_index:
                make_wide(payload)
                queue.append(wide_index[payload])

    m = len(wide_slots)
    boxes = np.zeros((m, arity, 6), dtype=np.float32)
    boxes[..., 0:3] = np.inf
    boxes[..., 3:6] = -np.inf
    meta = np.full((m, arity, 2), [0, -1], dtype=np.int32)
    total = max(int(sum(nodes[lid].count for g in wide_slots
                        for kind, payload in g if kind == "l"
                        for lid in payload)), 1)
    order_slots = np.full(total, -1, dtype=np.int64)
    cursor = 0
    for w, group in enumerate(wide_slots):
        for s, (kind, payload) in enumerate(group):
            if kind == "i":
                cn = nodes[payload]
                boxes[w, s, 0:3] = cn.lo
                boxes[w, s, 3:6] = cn.hi
                meta[w, s] = (wide_index[payload], 0)
                continue
            lo = np.full(3, np.inf, dtype=np.float32)
            hi = np.full(3, -np.inf, dtype=np.float32)
            start = cursor
            for lid in payload:
                cn = nodes[lid]
                lo = np.minimum(lo, cn.lo)
                hi = np.maximum(hi, cn.hi)
                order_slots[cursor: cursor + cn.count] = \
                    order[cn.start: cn.start + cn.count]
                cursor += cn.count
            boxes[w, s, 0:3] = lo
            boxes[w, s, 3:6] = hi
            meta[w, s] = (start, cursor - start)
    return boxes, meta, order_slots


def build(tris: np.ndarray, leaf_size: int = LEAF_SIZE, arity: int = ARITY,
          dfs: bool = False, treelet_budget: int = 0) -> WideBVH:
    """The packed wide table through the Python collapse (the JAX
    package's ``bvh8.build``; ``bvh_native.build`` is the native one).
    The DFS row order and the treelet layout serve the TPU's windowed
    gathers and are left out of the port by design: ``dfs`` must be False
    and ``treelet_budget`` 0."""
    if dfs or treelet_budget:
        raise ValueError(
            "DFS rows and treelets are TPU gather layouts the port leaves "
            f"out by design (dfs={dfs}, treelet_budget={treelet_budget})")
    boxes, meta, order_slots = collapse_bvh2(tris, leaf_size, arity)
    return pack_wide(boxes, meta, tris, order_slots, leaf_size, arity)


def build_legacy8(tris: np.ndarray, leaf_size: int = LEAF_SIZE8) -> WideBVH:
    """The legacy 8-wide f32 table through the Python collapse: the JAX
    package's ``bvh8.build_legacy8`` tree, the one its packet-kernel tests
    walk (``bvh_native.build_legacy8`` is the native collapse's tree)."""
    boxes, meta, order_slots = collapse_bvh2(tris, leaf_size, 8)
    return pack_wide_legacy8(boxes, meta, tris, order_slots, leaf_size)
