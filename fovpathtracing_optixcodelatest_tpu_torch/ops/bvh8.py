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

Row orders (the JAX package's deep-scene tables, bit for bit): the packing
writes node rows, then leaf rows. ``dfs_permute_host`` reorders them
depth first (a node row, its leaf rows, then each child subtree);
``group_small_siblings_host`` adds synthetic group rows over runs of small
sibling subtrees and ``treelet_permute_host`` lays the table out as a top
and bottom treelets of at most ``budget`` rows (``pack_wide(dfs=,
treelet_budget=)``). Each is a permutation of the same tree's rows plus
group rows whose box is the bf16 union of their members': a walk finds the
same hits; only the order among equal keys follows the new row ids.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from fovpathtracing_optixcodelatest_tpu_torch.ops.bvh import build_bvh2

ARITY = 16
LEAF_SIZE = 6
KIND_NODE, KIND_LEAF, KIND_INST = 0, 1, 2
EMPTY = np.int32(0)

WIDTH = 8
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
    # rows in depth-first order (dfs_permute_host, or the treelet layout)
    dfs: bool = False
    # the treelet layout (treelet_permute_host): rows [0, top_rows) are the
    # top, the rest bottom treelets; 0 = not treelet-laid. The JAX
    # package's ``top_table``, a second copy of those rows for the TPU's
    # VMEM, is left out: every walk here reads them from ``table``.
    top_rows: int = 0
    # exact worst-case stack of a walk of the top alone, and of any one
    # treelet (the JAX package's treelet walks size their stacks by them)
    top_stack: int = 0
    treelet_stack: int = 0

    @property
    def num_rows(self) -> int:
        return self.table.shape[0]

    @property
    def instanced(self) -> bool:
        return self.num_instances > 0


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


def dfs_permute_host(table: np.ndarray, leaf_perm: np.ndarray,
                     arity: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The table's rows in depth-first order: a node row, then its leaf
    rows, then each child subtree, children in slot order; rows no walk
    reaches (padding) last. Child codes are rewritten to the new rows ->
    (table, leaf_perm, perm) with perm[old_row] = new_row; the root stays
    row 0."""
    u = table.shape[0]
    codes_all = table[:, 3 * arity: 4 * arity].view(np.int32)
    perm = np.full(u, -1, dtype=np.int64)
    node_mask = np.zeros(u, dtype=bool)
    cursor = 0
    stack = [0]
    while stack:
        r = stack.pop()
        if perm[r] >= 0:
            continue
        perm[r] = cursor
        cursor += 1
        node_mask[r] = True
        c = codes_all[r]
        nz = c[c != EMPTY]
        kinds = nz & 3
        rows = (nz >> 2).astype(np.int64)
        for lr in rows[kinds == KIND_LEAF]:
            if perm[lr] < 0:
                perm[lr] = cursor
                cursor += 1
        for kn in rows[kinds == KIND_NODE][::-1]:  # visited in slot order
            if perm[kn] < 0:
                stack.append(kn)
    unreached = np.nonzero(perm < 0)[0]
    perm[unreached] = cursor + np.arange(len(unreached))
    return _permuted(table, leaf_perm, perm, np.nonzero(node_mask)[0],
                     arity) + (perm,)


def _permuted(table, leaf_perm, perm, nodes_old, arity):
    """``table`` and ``leaf_perm`` with row r moved to perm[r], the child
    codes of the node rows ``nodes_old`` rewritten to the new rows."""
    new_table = np.empty_like(table)
    new_table[perm] = table
    new_leaf_perm = np.empty_like(leaf_perm)
    new_leaf_perm[perm] = leaf_perm
    oc = table[nodes_old, 3 * arity: 4 * arity].view(np.int32)
    nc = np.where(oc == EMPTY, EMPTY,
                  ((perm[oc >> 2] << 2) | (oc & 3)).astype(np.int32))
    new_table[perm[nodes_old], 3 * arity: 4 * arity] = (
        nc.astype(np.int32).view(np.float32))
    return new_table, new_leaf_perm


_EMPTY_BOX_PAIR = np.uint32(0x7F80FF80)  # bf16 pair (lo=+inf, hi=-inf)


def _walk_order(codes_all: np.ndarray, u: int):
    """The node rows in depth-first order from the root (children pushed in
    reverse slot order, each row once) and each one's non-empty codes."""
    kids: dict[int, np.ndarray] = {}
    order: list[int] = []
    stack = [0]
    seen = np.zeros(u, dtype=bool)
    seen[0] = True
    while stack:
        r = stack.pop()
        order.append(r)
        c = codes_all[r]
        nz = c[c != EMPTY]
        kids[r] = nz
        for code in nz[::-1]:
            if (code & 3) == KIND_NODE:
                k = int(code) >> 2
                if not seen[k]:
                    seen[k] = True
                    stack.append(k)
    return order, kids


def group_small_siblings_host(
    table: np.ndarray, leaf_perm: np.ndarray, arity: int, budget: int
) -> tuple[np.ndarray, np.ndarray]:
    """Put runs of small sibling subtrees under new group rows, so that the
    treelets of ``treelet_permute_host`` come near ``budget`` rows. In each
    node whose subtree spans more than ``budget`` rows, the internal
    children of at most ``budget // FOVTPU_TGROUP_DIV`` (default 4) rows
    are grouped first-fit in slot order (a group's rows + 1 within the
    budget, at most ``arity`` members, at least 2): the group row holds the
    members' boxes and codes in its first slots, empty slots
    ``_EMPTY_BOX_PAIR``; the parent's first member slot takes the group's
    code and the bf16 union of the members' boxes, its other member slots
    are emptied. -> (table, leaf_perm) with the group rows appended (the
    inputs themselves where nothing is grouped; the parent rows are
    rewritten in place)."""
    u = table.shape[0]
    codes_all = table[:, 3 * arity: 4 * arity].view(np.int32)
    order_found, kids = _walk_order(codes_all, u)
    span = np.zeros(u, dtype=np.int64)
    for r in reversed(order_found):
        n_leaf = sum(1 for c in kids[r] if (c & 3) == KIND_LEAF)
        n_sub = sum(int(span[c >> 2]) for c in kids[r]
                    if (c & 3) == KIND_NODE)
        span[r] = 1 + n_leaf + n_sub
    if span[0] <= budget:
        return table, leaf_perm
    member_max = budget // int(os.environ.get("FOVTPU_TGROUP_DIV", "4"))

    new_rows: list[np.ndarray] = []
    for r in order_found:
        if span[r] <= budget:
            continue
        row_codes = codes_all[r]
        small = [s for s in range(arity)
                 if row_codes[s] != EMPTY
                 and (row_codes[s] & 3) == KIND_NODE
                 and span[row_codes[s] >> 2] <= member_max]
        groups: list[list[int]] = []
        cur: list[int] = []
        cur_span = 1  # the group row itself
        for s in small:
            sp = int(span[row_codes[s] >> 2])
            if cur and (cur_span + sp > budget or len(cur) == arity):
                groups.append(cur)
                cur, cur_span = [], 1
            cur.append(s)
            cur_span += sp
        if cur:
            groups.append(cur)
        for g in groups:
            if len(g) < 2:
                continue
            grow = np.zeros((table.shape[1],), dtype=np.float32)
            gu = grow[: 4 * arity].view(np.uint32)
            gu[: 3 * arity] = _EMPTY_BOX_PAIR
            lo_u = np.full(3, np.uint32(0x7F800000))  # +inf
            hi_u = np.full(3, np.uint32(0xFF800000))  # -inf
            tu = table[r, : 4 * arity].view(np.uint32)
            for j, s in enumerate(g):
                for a in range(3):
                    p = tu[3 * s + a]
                    mlo = p & np.uint32(0xFFFF0000)
                    mhi = p << np.uint32(16)
                    if mlo.view(np.float32) < lo_u[a].view(np.float32):
                        lo_u[a] = mlo
                    if mhi.view(np.float32) > hi_u[a].view(np.float32):
                        hi_u[a] = mhi
                    gu[3 * j + a] = p
                gu[3 * arity + j] = tu[3 * arity + s]
            s0 = g[0]
            new_id = u + len(new_rows)
            for a in range(3):
                tu[3 * s0 + a] = (lo_u[a] & np.uint32(0xFFFF0000)) | (
                    hi_u[a] >> np.uint32(16))
            codes_all[r, s0] = np.int32((new_id << 2) | KIND_NODE)
            for s in g[1:]:
                codes_all[r, s] = EMPTY
                for a in range(3):
                    tu[3 * s + a] = _EMPTY_BOX_PAIR
            new_rows.append(grow)
    if not new_rows:
        return table, leaf_perm
    table2 = np.vstack([table, np.stack(new_rows, axis=0)])
    pad = np.full((len(new_rows), leaf_perm.shape[1]), -1, dtype=np.int32)
    return table2, np.vstack([leaf_perm, pad])


def _lifo_bound(nodes, kids_of, leaves_of) -> dict:
    """g(v) = children pushed - 1 + max(1, max g of the node children),
    over ``nodes`` in reverse depth-first order (children first)."""
    g: dict[int, int] = {}
    for r in reversed(nodes):
        kn = kids_of(r)
        sub = max([g[k] for k in kn], default=0)
        g[r] = len(kn) + leaves_of(r) - 1 + max(1, sub)
    return g


def treelet_permute_host(
    table: np.ndarray, leaf_perm: np.ndarray, arity: int, budget: int
) -> tuple:
    """The treelet layout: rows [0, top_rows) hold the top, every node whose
    subtree spans more than ``budget`` rows with its own leaf rows, in
    depth-first order; then each bottom treelet (a child subtree of at
    most ``budget`` rows) depth first, in the order the top's walk meets
    them. -> (table, leaf_perm, perm, top_rows, top_stack, treelet_stack,
    full_stack): the exact worst-case stacks of a walk of the top alone
    (treelet children not pushed, + 1), of any one treelet (+ 1) and of
    the whole tree. A tree of at most ``budget`` rows is only
    ``dfs_permute_host``-ed (top_rows = top_stack = treelet_stack = 0)."""
    u = table.shape[0]
    codes_all = table[:, 3 * arity: 4 * arity].view(np.int32)
    order_found, kids = _walk_order(codes_all, u)
    kids_node, kids_leaf = {}, {}
    for r in order_found:
        nz = kids[r]
        rows = (nz >> 2).astype(np.int64)
        kids_node[r] = rows[(nz & 3) == KIND_NODE]
        kids_leaf[r] = rows[(nz & 3) == KIND_LEAF]
    span = np.zeros(u, dtype=np.int64)
    for r in reversed(order_found):
        span[r] = 1 + len(kids_leaf[r]) + int(span[kids_node[r]].sum())
    n_leaves = lambda r: len(kids_leaf[r])  # noqa: E731
    gf = _lifo_bound(order_found, lambda r: [int(k) for k in kids_node[r]],
                     n_leaves)
    full_stack = max(1, gf.get(0, 1))
    if span[0] <= budget:
        nt, nl, perm = dfs_permute_host(table, leaf_perm, arity)
        return nt, nl, perm, 0, 0, 0, full_stack

    perm = np.full(u, -1, dtype=np.int64)
    cursor = 0
    treelet_roots: list[int] = []
    stack = [0]
    while stack:
        r = stack.pop()
        if perm[r] >= 0:
            continue
        perm[r] = cursor
        cursor += 1
        for lr in kids_leaf[r]:
            if perm[lr] < 0:
                perm[lr] = cursor
                cursor += 1
        big = [int(k) for k in kids_node[r] if span[k] > budget]
        treelet_roots.extend(int(k) for k in kids_node[r]
                             if span[k] <= budget)
        stack.extend(big[::-1])
    top_rows = cursor
    for root in treelet_roots:
        stack = [root]
        while stack:
            r = stack.pop()
            if perm[r] >= 0:
                continue
            perm[r] = cursor
            cursor += 1
            for lr in kids_leaf[r]:
                if perm[lr] < 0:
                    perm[lr] = cursor
                    cursor += 1
            for k in kids_node[r][::-1]:
                if perm[k] < 0:
                    stack.append(int(k))
    unreached = np.nonzero(perm < 0)[0]
    perm[unreached] = cursor + np.arange(len(unreached))
    new_table, new_leaf_perm = _permuted(
        table, leaf_perm, perm, np.asarray(order_found, dtype=np.int64),
        arity)

    top_nodes = [r for r in order_found if span[r] > budget]
    g = _lifo_bound(top_nodes, lambda r: [int(k) for k in kids_node[r]
                                          if span[k] > budget], n_leaves)
    top_stack = max(1, g.get(0, 1)) + 1
    gt = _lifo_bound([r for r in order_found if span[r] <= budget],
                     lambda r: [int(k) for k in kids_node[r]], n_leaves)
    treelet_stack = max([gt[r] for r in treelet_roots], default=1) + 1
    return (new_table, new_leaf_perm, perm, int(top_rows), int(top_stack),
            int(treelet_stack), int(full_stack))


def pack_wide(boxes: np.ndarray, meta: np.ndarray, tris: np.ndarray,
              order_slots: np.ndarray, leaf_size: int,
              arity: int | None = None, dfs: bool = False,
              treelet_budget: int = 0) -> WideBVH:
    """Pack (M, A, 6) boxes + (M, A, 2) meta ([a, count]: count > 0 leaf at
    slot offset a, 0 internal node a, -1 empty) + the leaf slot permutation
    into the packed single-level layout (node rows, then leaf rows).
    ``dfs`` reorders the rows depth first (``dfs_permute_host``);
    ``treelet_budget > 0`` groups small siblings (unless
    ``FOVTPU_TGROUP=0``) and lays out treelets instead
    (``treelet_permute_host``; then ``dfs`` is set and ``stack_depth`` is
    the grouped tree's exact bound + 1)."""
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
    stack_depth = lifo_stack_bound(entry) + 1
    top_rows = top_stack = treelet_stack = 0
    if treelet_budget > 0:
        if os.environ.get("FOVTPU_TGROUP", "1") != "0":
            table, leaf_perm = group_small_siblings_host(
                table, leaf_perm, arity, treelet_budget)
        (table, leaf_perm, _, top_rows, top_stack, treelet_stack,
         full_stack) = treelet_permute_host(table, leaf_perm, arity,
                                            treelet_budget)
        stack_depth = full_stack + 1
        dfs = True
    elif dfs:
        table, leaf_perm, _ = dfs_permute_host(table, leaf_perm, arity)
    return WideBVH(
        table=table, leaf_perm=leaf_perm, leaf_size=leaf_size, arity=arity,
        packed=True, stack_depth=stack_depth, dfs=dfs, top_rows=top_rows,
        top_stack=top_stack, treelet_stack=treelet_stack,
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
    package's ``bvh8.build``; ``bvh_native.build`` is the native one), in
    the row order ``dfs`` and ``treelet_budget`` choose (``pack_wide``)."""
    boxes, meta, order_slots = collapse_bvh2(tris, leaf_size, arity)
    return pack_wide(boxes, meta, tris, order_slots, leaf_size, arity,
                     dfs=dfs, treelet_budget=treelet_budget)


def build_legacy8(tris: np.ndarray, leaf_size: int = LEAF_SIZE8) -> WideBVH:
    """The legacy 8-wide f32 table through the Python collapse: the JAX
    package's ``bvh8.build_legacy8`` tree, the one its packet-kernel tests
    walk (``bvh_native.build_legacy8`` is the native collapse's tree)."""
    boxes, meta, order_slots = collapse_bvh2(tris, leaf_size, 8)
    return pack_wide_legacy8(boxes, meta, tris, order_slots, leaf_size)
