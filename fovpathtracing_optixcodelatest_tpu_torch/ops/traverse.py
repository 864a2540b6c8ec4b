"""Closest-hit and occlusion traversal of the packed wide BVH (counterpart of
the JAX package's ``ops/traverse8.py`` ``closest_hit``/``occluded``).

``closest_hit`` and ``occluded`` are the kernel wrappers: on a CUDA tensor
they launch the hand-written kernels of ``csrc/traverse.cu`` (K1, K2) and
raise if the launch fails; on a CPU tensor they run ``closest_hit_plain`` /
``occluded_plain``. The kernels are compiled for the packed layouts the
port builds (``KERNEL_LAYOUTS``): (arity, leaf_size) = (16, 6), the
default, and the JAX package's wide (32, 12) and (32, 24); a wide launch
also counts under ``layout_name``. On a CUDA tensor any other
(arity, leaf_size), rows of another width, or a table that is not 16-byte
aligned raises ``ValueError``. The plain versions take any layout: they
walk every ray's stack as one (N, stack_depth) int64 tensor with masked
gathers and repeat the kernels' arithmetic and visit order operation for
operation, so the two agree bit for bit.

Visit order is the reference's: a closest-hit stack entry is the packed key
``(mono(tn) & himask) | code``; a node's hit children are pushed sorted by
descending key (the nearest ends on top); a popped entry whose key exceeds
``mono(min(t, tmax)) | lowmask`` is stale and skipped.

Two-level tables (``ops/tlas.py``, ``num_instances > 0``) walk as the
reference's ``_ch_step`` and occlusion loop do: popping an instance code
reads the instance row, sets the lane's object-space ray (``inv_transform``:
the direction left unnormalised, so t stays in world units) and the lane's
instance ``cur``, and pushes the BLAS root with the instance's key bits;
popping a TLAS node row (``row < blas_base``) moves the lane back to world
space; BLAS nodes and leaves are tested in object space. ``closest_hit``
then also returns ``inst``, the hit's instance (-1 on a miss). The kernels
have an instanced variant each, compiled for the same layouts and chosen
by the wrappers from ``num_instances``; they test the BLAS root in the
instance entry's own step, which visits the same rows in the same order.

A table in DFS or treelet order (``bvh8.pack_wide(dfs=,
treelet_budget=)``) is walked as any other: its rows are the same tree's,
permuted, with group rows whose boxes hold their members'; ties between
equal keys follow its row ids, as the reference's walk of the same table
does.

``occluded(..., cull_backface=False)`` lets back faces occlude too (the 04
raycast's shadow ray, ``render/simple.py``): on a CUDA tensor it launches
K2's non-culling instantiation, or on a two-level table the two-level
K2's (``NOCULL_INSTANCED``), each compiled for every layout.

All six kernels launch through one entry, ``fov_traverse``, which takes a
``TraverseArgs`` whose ``which`` names the kernel (``WHICH``).

Over a wavefront's lane list (``render/integrator.py`` ``trace_paths`` on
the card) the wrappers take ``count``, the list's length as a (1,) int32
tensor the device holds (``ops/lanes.py``): the kernel walks the lanes
below it, its grid sized for all N, and the outputs past it are left as
they were. ``counter`` gives the kernel's zeroed lane counter and ``out``
its output tensors, so such a caller allocates them once a wavefront.

``ops/traverse8.py`` gives these walks under the JAX package's names and
signatures. Each call of ``closest_hit`` or ``occluded``, on either
device, is the span ``fov.k1`` or ``fov.k2`` (``utils/tracing.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
from fovpathtracing_optixcodelatest_tpu_torch.ops.bvh8 import (
    ARITY,
    KIND_INST,
    LEAF_SIZE,
    codebits,
)
from fovpathtracing_optixcodelatest_tpu_torch.utils import tracing

_MASK = 0xFFFFFFFF
# deepest stack the wrappers take: the wide tables need up to 164 entries
# (A32/L12 at 10M triangles); csrc/traverse.cu kMaxStack
MAX_STACK = 256
# the layouts (arity, leaf_size) every kernel is compiled for besides the
# default (16, 6): the JAX package's wide packings ((32, 12) as
# group-per-ray walks, (32, 24) as one thread a ray)
WIDE_LAYOUTS = ((32, 12), (32, 24))
# the (arity, leaf_size) layouts the kernels are compiled for, with their
# rows' widths (bvh8: max(4 arity, 10 leaf_size) columns)
KERNEL_LAYOUTS = {lay: max(4 * lay[0], 10 * lay[1])
                  for lay in ((ARITY, LEAF_SIZE), *WIDE_LAYOUTS)}
# the single-level kernels
LAYOUT_KERNELS = ("closest_hit", "occluded", "occluded_nocull")
# the two-level kernels
INSTANCED_KERNELS = ("closest_hit_instanced", "occluded_instanced")
# the two-level K2 without back-face culling (the 04 raycast of an
# instanced scene)
NOCULL_INSTANCED = "occluded_nocull_instanced"
WIDE_KERNELS = LAYOUT_KERNELS + INSTANCED_KERNELS + (NOCULL_INSTANCED,)
# each kernel's index ``which`` in csrc/traverse.cu
WHICH = {"closest_hit": 0, "occluded": 1, "closest_hit_instanced": 2,
         "occluded_instanced": 3, "occluded_nocull": 4, NOCULL_INSTANCED: 5}
# the K2 that ``occluded`` launches, by (two-level table, culls back faces)
_OCCLUDED = {(False, True): "occluded", (False, False): "occluded_nocull",
             (True, True): "occluded_instanced",
             (True, False): NOCULL_INSTANCED}
# how a kernel's rows reach its walk, and where its stacks lie
# (``fov_traverse_design``)
ROW_COPIES = ("ldg", "cp.async")
STACK_HOMES = ("shared", "global", "local")
# what the plain versions' ``stats`` count: rows fetched, the distinct rows
# among them (each call's, summed over calls: what the calls must read from
# memory at least once), and the tests done on them (non-empty children
# slab-tested, real triangles tested); on a two-level table also the
# instance rows fetched (``INST_STATS``)
STATS = ("node_rows", "leaf_rows", "distinct_rows", "child_tests",
         "tri_tests")
INST_STATS = STATS + ("inst_rows",)


# ---------------------------------------------------------------------------
# bit helpers (32-bit words held in int64)
# ---------------------------------------------------------------------------


def _bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its uint32 bit pattern in int64."""
    return x.contiguous().view(torch.int32).to(torch.int64) & _MASK


def _from_bits(b: torch.Tensor) -> torch.Tensor:
    """uint32 bit pattern in int64 -> float32."""
    signed = (b ^ 0x80000000) - 0x80000000
    return signed.to(torch.int32).view(torch.float32)


def mono_u32(x: torch.Tensor) -> torch.Tensor:
    """Monotone float32 -> uint32 map: a < b <=> mono(a) < mono(b)."""
    b = _bits(x)
    return torch.where(x < 0, (~b) & _MASK, b | 0x80000000)


def safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1 / d with |d| < 1e-12 replaced by +-1e-12."""
    tiny = torch.where(d < 0, -1e-12, 1e-12).to(d.dtype)
    return 1.0 / torch.where(d.abs() < 1e-12, tiny, d)


def slab(lo, hi, o, inv, tmin, tlimit):
    """(K, C, 3) boxes against (K, 3) rays -> (hit (K, C), tn (K, C)) with
    hit = tn <= tf & tf >= tmin & tn <= tlimit ((K, 1) or scalar)."""
    t0 = (lo - o[:, None, :]) * inv[:, None, :]
    t1 = (hi - o[:, None, :]) * inv[:, None, :]
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    return (tn <= tf) & (tf >= tmin) & (tn <= tlimit), tn


def tri_test(tri, o, d, tmin, tmax, cull: bool):
    """Möller-Trumbore of (K, 9) rows [v0, e1, e2] against (K, 3) rays, in
    the kernels' operation order (csrc/tri.cuh) -> (hit, t, u, v)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri.unbind(-1)
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


def inv_transform(irows: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """The object-space ray of (K, >= 13) instance rows [root code, A (3x3
    row-major), b (3)] -> (origin A o + b, direction A d, its safe
    inverse), each sum left to right as the reference's
    ``_apply_inv_transform`` writes it."""
    op, dp = [], []
    for a in range(3):
        r0, r1, r2 = irows[:, 1 + 3 * a], irows[:, 2 + 3 * a], irows[:, 3 + 3 * a]
        op.append(r0 * o[:, 0] + r1 * o[:, 1] + r2 * o[:, 2] + irows[:, 10 + a])
        dp.append(r0 * d[:, 0] + r1 * d[:, 1] + r2 * d[:, 2])
    dp = torch.stack(dp, dim=1)
    return torch.stack(op, dim=1), dp, safe_inv(dp)


class _Spaces:
    """Per-lane space state of a two-level walk: the object-space ray and
    the current instance (-1 = world space)."""

    def __init__(self, o, d, inv):
        self.o, self.d, self.inv = o.clone(), d.clone(), inv.clone()
        self.cur = torch.full((o.shape[0],), -1, dtype=torch.int32,
                              device=o.device)

    def enter(self, lanes, irows, o_world, d_world, inst_ids):
        """Lanes that popped an instance code take its object-space ray."""
        op, dp, ip = inv_transform(irows, o_world, d_world)
        self.o[lanes], self.d[lanes], self.inv[lanes] = op, dp, ip
        self.cur[lanes] = inst_ids.to(torch.int32)

    def node_ray(self, lanes, world, o, inv):
        """The ray node lanes test their children with: world space on a
        TLAS row (which also leaves the instance), object space below."""
        self.cur[lanes[world]] = -1
        w = world[:, None]
        return (torch.where(w, o[lanes], self.o[lanes]),
                torch.where(w, inv[lanes], self.inv[lanes]))


def _rows_of(table, code, instanced: bool, inst_base: int, seen=None):
    """The rows popped codes address, and which codes are instances; marks
    the rows' indices in ``seen`` (a (rows,) bool tensor) where given."""
    row = code >> 2
    is_inst = None
    if instanced:
        is_inst = (code & 3) == KIND_INST
        row = torch.where(is_inst, row + inst_base, row)
    if seen is not None:
        seen[row] = True
    return table[row], is_inst


def _seen_rows(table, stats):
    """The (rows,) bool tensor of rows a walk fetched, where ``stats`` is
    asked for."""
    if stats is None:
        return None
    return torch.zeros((table.shape[0],), dtype=torch.bool,
                       device=table.device)


def _add_stats(stats, fetched: dict, seen) -> None:
    if stats is None:
        return
    fetched["distinct_rows"] = int(seen.sum())
    for name, count in fetched.items():
        stats[name] = stats.get(name, 0) + count


def _node_boxes(rows: torch.Tensor, arity: int):
    """Decode the bf16-pair boxes and child codes of packed node rows ->
    lo, hi (K, A, 3) float32 and codes (K, A) int64."""
    b = _bits(rows[:, : 3 * arity]).view(-1, arity, 3)
    lo = _from_bits(b & 0xFFFF0000)
    hi = _from_bits((b << 16) & _MASK)
    codes = _bits(rows[:, 3 * arity: 4 * arity])
    return lo, hi, codes


def _push(stack, sp, who, entries, keep):
    """Write each row's kept ``entries`` (K, C) on top of its stack in column
    order (the last kept column ends on top)."""
    pos = sp[who][:, None] + torch.cumsum(keep.to(torch.int64), dim=1) - 1
    ok = keep & (pos < stack.shape[1])
    rows = who[:, None].expand_as(pos)
    stack.index_put_((rows[ok], pos[ok]), entries[ok])
    sp[who] = torch.clamp(sp[who] + keep.sum(dim=1), max=stack.shape[1])


def _real_triangles(lrows: torch.Tensor, leaf_size: int) -> int:
    """Triangles in packed leaf rows, padding slots (id -1) left out."""
    ids = lrows[:, 9 * leaf_size: 10 * leaf_size].contiguous()
    return int((ids.view(torch.int32) >= 0).sum())


# the rays' and the table's fields of ``TraverseArgs`` and ``PacketArgs``
RAYS = {"table": torch.float32, "orig": torch.float32, "dir": torch.float32,
        "active": torch.bool}
# the tensors ``_launch`` fills in: the rays, the table, the lane counter
# and the lane count
_LAUNCH = {**RAYS, "counter": torch.int32, "count": torch.int32}


class TraverseArgs(ctypes.Structure):
    """``fov_traverse``'s argument struct (csrc/traverse.cu)."""

    _fields_ = [*((k, ctypes.c_void_p) for k in (
                    "table", "orig", "dir", "active", "t_out", "tri_out",
                    "u_out", "v_out", "inst_out", "occ_out", "counter",
                    "stack", "count")),
                ("which", ctypes.c_int), ("n", ctypes.c_int),
                ("tmin", ctypes.c_float), ("tmax", ctypes.c_float),
                ("stack_depth", ctypes.c_int), ("lowmask", ctypes.c_uint),
                *((k, ctypes.c_int) for k in ("inst_base", "blas_base",
                                               "arity", "leaf"))]


def layout_name(kernel: str, arity: int, leaf_size: int) -> str:
    """The name of ``kernel``'s (arity, leaf_size) instantiation, which
    keys its launch count and its resources: the kernel's own at the
    default (16, 6), else e.g. "closest_hit_a32_l12"."""
    if (arity, leaf_size) == (ARITY, LEAF_SIZE):
        return kernel
    return f"{kernel}_a{arity}_l{leaf_size}"


def _check(table, o, d, active, stack_depth, num_instances=0, inst_base=0,
           blas_base=0):
    """Refuse what no walk takes: shapes, instance rows, stack depth and
    device; on the CPU also dtypes and devices, which on CUDA the launch's
    ``kernel_build.fill`` checks with contiguity."""
    dev = table.device
    if num_instances and not (
            0 < inst_base and inst_base + num_instances == blas_base
            < table.shape[0] and table.shape[1] >= 13):
        raise ValueError("instance rows must lie in [inst_base, blas_base) "
                         "of a table with BLAS rows after them")
    if table.ndim != 2:
        raise ValueError("table must be a 2-D tensor")
    if o.ndim != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError("origin and direction must be (N, 3)")
    if active.shape != (o.shape[0],):
        raise ValueError("active must be (N,)")
    if not 1 <= stack_depth <= MAX_STACK:
        raise ValueError(f"stack_depth {stack_depth} outside [1, {MAX_STACK}]")
    if dev.type == "cpu":
        if (table.dtype != torch.float32 or o.dtype != torch.float32
                or d.dtype != torch.float32 or active.dtype != torch.bool):
            raise ValueError("table, origin and direction must be float32 "
                             "and active bool")
        if o.device != dev or d.device != dev or active.device != dev:
            raise ValueError("table and rays must lie on one device")
    elif dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")


def _kernel_layout(table, n: int, arity: int, leaf_size: int,
                   want=None, width: int | None = None) -> None:
    """Refuse what a compiled kernel does not take: an (arity, leaf_size)
    layout it is not compiled for (K1/K2 and their two-level variants:
    ``KERNEL_LAYOUTS``; a kernel compiled for one layout, K3, passes it as
    ``want``, its rows' width as ``width``), rows of another width, a
    table that is not 16-byte aligned (rows are read as uint4), or more
    rays than an int32 counter can hand out."""
    layouts = KERNEL_LAYOUTS if want is None else {want: width}
    if (arity, leaf_size) not in layouts:
        raise ValueError(
            f"the CUDA kernel takes the layouts {sorted(layouts)}, not "
            f"({arity}, {leaf_size})")
    width = layouts[(arity, leaf_size)]
    if table.shape[1] != width:
        raise ValueError(f"the kernel's rows need {width} columns")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    if n >= 2**31 - 2**20:
        raise ValueError("too many rays for one launch")


@functools.cache
def _stack_home(arity: int, leaf_size: int) -> str:
    """Where K1's stacks lie at the layout (``STACK_HOMES``)."""
    return STACK_HOMES[kernel_build.query(
        "traverse", "fov_traverse_design", 0, arity, leaf_size, outs=3)[2]]


def _global_stack(arity: int, leaf_size: int, stack_depth: int, n: int,
                  dev):
    """The global-memory stack buffer K1 takes at the layout for n lanes
    (at (32, 12) its rays' stacks lie there; elsewhere in shared or local
    memory: None, and no query a launch)."""
    if _stack_home(arity, leaf_size) != "global":
        return None
    entries, = kernel_build.query("traverse", "fov_traverse_stack", 0, arity,
                                  leaf_size, stack_depth, n, outs=1,
                                  out_type=ctypes.c_longlong)
    if entries == 0:
        return None
    return torch.empty((entries,), dtype=torch.int32, device=dev)


def _launch(name: str, args: TraverseArgs, table, o, d, active,
            tmin: float, tmax: float, stack_depth: int, arity: int,
            leaf_size: int, count=None, counter=None) -> None:
    """Launch kernel ``name`` (``WHICH``) over the rays: ``args`` holds its
    outputs and any other fields it takes; this fills in the rays and the
    table (``kernel_build.fill`` checks them), the lane count (None: all)
    and counter (None: a fresh one), the kernel and the walk's parameters.
    Counts the launch, also under its ``layout_name`` at a wide layout."""
    dev = table.device
    if counter is None:
        counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    kernel_build.fill(args, dev, _LAUNCH, {
        "table": table, "orig": o, "dir": d, "active": active,
        "counter": counter, "count": count})
    args.which = WHICH[name]
    args.n = o.shape[0]
    args.tmin = tmin
    args.tmax = tmax
    args.stack_depth = stack_depth
    args.arity = arity
    args.leaf = leaf_size
    kernel_build.launch("traverse", "fov_traverse", name, args)
    if (arity, leaf_size) != (ARITY, LEAF_SIZE):
        kernel_build.LAUNCHES[layout_name(name, arity, leaf_size)] += 1


def resources(stack_depth: int) -> dict:
    """Registers per thread, local memory per thread (spills and stack
    frames), resident blocks per SM and dynamic shared memory per block of
    each kernel of ``WHICH`` at ``stack_depth``, and of K3
    (``occluded_packets``, whose shared memory does not depend on it), as
    the CUDA runtime reports them for the loaded build; the wide layouts'
    kernels under their ``layout_name``. Every traversal kernel's entry
    also gives its design: ``group_lanes`` (the lanes that walk one ray),
    ``row_copy`` (``ROW_COPIES``: 16-byte loads into registers, or
    ``cp.async`` into the ray's shared-memory row buffer) and ``stack``
    (``STACK_HOMES``)."""
    keys = ("registers", "local_bytes", "blocks_per_sm", "shared_bytes")
    out = {"occluded_packets": dict(zip(keys, kernel_build.query(
        "packet_traverse", "fov_packet_info")))}
    for lay in ((ARITY, LEAF_SIZE), *WIDE_LAYOUTS):
        for kernel, which in WHICH.items():
            rec = dict(zip(keys, kernel_build.query(
                "traverse", "fov_traverse_info", which, *lay, stack_depth)))
            group, copy, home = kernel_build.query(
                "traverse", "fov_traverse_design", which, *lay, outs=3)
            rec.update(group_lanes=group, row_copy=ROW_COPIES[copy],
                       stack=STACK_HOMES[home])
            out[layout_name(kernel, *lay)] = rec
    return out


# ---------------------------------------------------------------------------
# closest hit (K1)
# ---------------------------------------------------------------------------


def closest_hit_plain(table, o, d, active, tmin: float, tmax: float,
                      stack_depth: int, arity: int, leaf_size: int,
                      stats: dict | None = None, *, num_instances: int = 0,
                      inst_base: int = 0, blas_base: int = 0):
    """Plain PyTorch K1: dict(t, tri_id, u, v, hit), and ``inst`` on a
    two-level table. ``stats`` gets the node, leaf and instance rows
    fetched (``node_rows``, ``leaf_rows``, ``inst_rows``), how many distinct
    rows of the table they were (``distinct_rows``) and the work in
    them (``child_tests``: slab tests of the fetched nodes' non-empty
    children; ``tri_tests``: ray-triangle tests of the fetched leaves' real,
    non-padding triangles)."""
    n, dev = o.shape[0], o.device
    instanced = num_instances > 0
    cb = codebits(table.shape[0])
    lowmask = (1 << cb) - 1
    himask = _MASK & ~lowmask
    inv = safe_inv(d)
    t = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    u = torch.zeros((n,), dtype=torch.float32, device=dev)
    v = torch.zeros((n,), dtype=torch.float32, device=dev)
    best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if instanced:
        space = _Spaces(o, d, inv)
        best_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    stack = torch.zeros((n, stack_depth), dtype=torch.int64, device=dev)
    sp = active.to(torch.int64)  # the root (code 0) sits at depth 0
    fetched = dict.fromkeys(INST_STATS if instanced else STATS, 0)
    seen = _seen_rows(table, stats)
    tmax_t = torch.tensor(tmax, dtype=torch.float32, device=dev)
    while True:
        idx = torch.nonzero(sp > 0).squeeze(1)
        if idx.numel() == 0:
            break
        sp[idx] -= 1
        e = stack[idx, sp[idx]]
        tlimit = torch.minimum(t[idx], tmax_t)
        fresh = e <= (mono_u32(tlimit) | lowmask)
        idx, e, tlimit = idx[fresh], e[fresh], tlimit[fresh]
        code = e & lowmask
        rows, is_inst = _rows_of(table, code, instanced, inst_base, seen)
        node = (code & 3) == 0

        if instanced:
            ii = idx[is_inst]
            fetched["inst_rows"] += ii.numel()
            if ii.numel():
                irows = rows[is_inst]
                space.enter(ii, irows, o[ii], d[ii], code[is_inst] >> 2)
                # the BLAS root, keyed by the instance's entry
                key = (e[is_inst] & himask) | _bits(irows[:, 0])
                _push(stack, sp, ii, key[:, None],
                      torch.ones_like(key[:, None], dtype=torch.bool))

        ni = idx[node]
        fetched["node_rows"] += ni.numel()
        if ni.numel():
            lo, hi, codes = _node_boxes(rows[node], arity)
            fetched["child_tests"] += int((codes != 0).sum())
            if instanced:
                o_n, inv_n = space.node_ray(ni, (code[node] >> 2) < blas_base,
                                            o, inv)
            else:
                o_n, inv_n = o[ni], inv[ni]
            hit, tn = slab(lo, hi, o_n, inv_n, tmin, tlimit[node][:, None])
            hit = hit & (codes != 0)
            keys = torch.where(hit, (mono_u32(tn) & himask) | codes, 0)
            keys = torch.sort(keys, dim=1, descending=True).values
            cnt = hit.sum(dim=1)
            keep = torch.arange(arity, device=dev)[None, :] < cnt[:, None]
            _push(stack, sp, ni, keys, keep)

        leaf = ~node if is_inst is None else ~node & ~is_inst
        li = idx[leaf]
        fetched["leaf_rows"] += li.numel()
        if li.numel():
            lrows = rows[leaf]
            fetched["tri_tests"] += _real_triangles(lrows, leaf_size)
            tb, ub, vb, bb = t[li], u[li], v[li], best[li]
            if instanced:
                ol, dl = space.o[li], space.d[li]
                ib, cur = best_inst[li], space.cur[li]
            else:
                ol, dl = o[li], d[li]
            for k in range(leaf_size):
                hk, tk, uk, vk = tri_test(
                    lrows[:, 9 * k: 9 * k + 9], ol, dl, tmin, tmax, cull=False
                )
                better = hk & (tk < tb)
                tb = torch.where(better, tk, tb)
                ub = torch.where(better, uk, ub)
                vb = torch.where(better, vk, vb)
                tid = lrows[:, 9 * leaf_size + k].contiguous().view(torch.int32)
                bb = torch.where(better, tid, bb)
                if instanced:
                    ib = torch.where(better, cur, ib)
            t[li], u[li], v[li], best[li] = tb, ub, vb, bb
            if instanced:
                best_inst[li] = ib
    _add_stats(stats, fetched, seen)
    out = {"t": t, "tri_id": best, "u": u, "v": v, "hit": best >= 0}
    if instanced:
        out["inst"] = best_inst
    return out


def _card_only(table, **launch) -> None:
    """Refuse a lane count, counter or output tensors on the CPU: they
    are a kernel launch's."""
    if table.device.type == "cpu" and any(
            v is not None for v in launch.values()):
        raise ValueError(f"{sorted(launch)} are a CUDA launch's arguments")


def hit_outputs(n: int, device, instanced: bool) -> dict:
    """Fresh tensors for ``closest_hit``'s answer over n lanes (``t``,
    ``tri_id``, ``u``, ``v``, ``hit``; ``inst`` on a two-level table)."""
    t = torch.empty((n,), dtype=torch.float32, device=device)
    out = {"t": t, "tri_id": torch.empty((n,), dtype=torch.int32,
                                         device=device),
           "u": torch.empty_like(t), "v": torch.empty_like(t),
           "hit": torch.empty((n,), dtype=torch.bool, device=device)}
    if instanced:
        out["inst"] = torch.empty_like(out["tri_id"])
    return out


@tracing.spanned(tracing.K1)
def closest_hit(table, o, d, active, tmin: float, tmax: float,
                stack_depth: int, arity: int, leaf_size: int, *,
                num_instances: int = 0, inst_base: int = 0,
                blas_base: int = 0, count=None, counter=None, out=None):
    """Closest hit of each active ray: dict(t, tri_id, u, v, hit) of (N,)
    tensors (miss: t = inf, tri_id = -1, u = v = 0), and ``inst`` (-1 on a
    miss) on a two-level table. CUDA tensors launch K1 at the table's
    layout (``KERNEL_LAYOUTS``), or its instanced variant where
    ``num_instances > 0``, over the first ``count`` lanes where it is
    given, into ``out`` (``hit_outputs``) where it is given; CPU tensors
    run ``closest_hit_plain``."""
    inst_kw = {"num_instances": num_instances, "inst_base": inst_base,
               "blas_base": blas_base}
    _check(table, o, d, active, stack_depth, **inst_kw)
    _card_only(table, count=count, counter=counter, out=out)
    if table.device.type == "cpu":
        return closest_hit_plain(table, o, d, active, tmin, tmax,
                                 stack_depth, arity, leaf_size, **inst_kw)
    n, dev = o.shape[0], o.device
    _kernel_layout(table, n, arity, leaf_size)
    cb = codebits(table.shape[0])
    if cb > 26:
        raise ValueError("table too large for packed tn|code stack entries")
    if out is None:
        out = hit_outputs(n, dev, bool(num_instances))
    t, tri, u, v = out["t"], out["tri_id"], out["u"], out["v"]
    if n > 0:  # else nothing to launch
        args = TraverseArgs()
        args.t_out, args.tri_out = t.data_ptr(), tri.data_ptr()
        args.u_out, args.v_out = u.data_ptr(), v.data_ptr()
        args.lowmask = (1 << cb) - 1
        if num_instances:
            args.inst_out = out["inst"].data_ptr()
            args.inst_base, args.blas_base = inst_base, blas_base
            name = "closest_hit_instanced"
        else:
            stack = _global_stack(arity, leaf_size, stack_depth, n, dev)
            if stack is not None:
                args.stack = stack.data_ptr()
            name = "closest_hit"
        _launch(name, args, table, o, d, active, tmin, tmax, stack_depth,
                arity, leaf_size, count, counter)
    torch.ge(tri, 0, out=out["hit"])
    return out


# ---------------------------------------------------------------------------
# occlusion (K2)
# ---------------------------------------------------------------------------


def occluded_plain(table, o, d, active, tmin: float, tmax: float,
                   stack_depth: int, arity: int, leaf_size: int,
                   stats: dict | None = None, *, num_instances: int = 0,
                   inst_base: int = 0, blas_base: int = 0,
                   cull_backface: bool = True):
    """Plain PyTorch K2 -> (N,) bool. Children are pushed in slot order.
    Back faces do not occlude unless ``cull_backface`` is False. ``stats``
    counts as ``closest_hit_plain``'s does."""
    n, dev = o.shape[0], o.device
    instanced = num_instances > 0
    inv = safe_inv(d)
    if instanced:
        space = _Spaces(o, d, inv)
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    stack = torch.zeros((n, stack_depth), dtype=torch.int64, device=dev)
    sp = active.to(torch.int64)
    fetched = dict.fromkeys(INST_STATS if instanced else STATS, 0)
    seen = _seen_rows(table, stats)
    while True:
        idx = torch.nonzero((sp > 0) & ~occ).squeeze(1)
        if idx.numel() == 0:
            break
        sp[idx] -= 1
        code = stack[idx, sp[idx]]
        rows, is_inst = _rows_of(table, code, instanced, inst_base, seen)
        node = (code & 3) == 0

        if instanced:
            ii = idx[is_inst]
            fetched["inst_rows"] += ii.numel()
            if ii.numel():
                irows = rows[is_inst]
                space.enter(ii, irows, o[ii], d[ii], code[is_inst] >> 2)
                root = _bits(irows[:, 0])[:, None]
                _push(stack, sp, ii, root,
                      torch.ones_like(root, dtype=torch.bool))

        ni = idx[node]
        fetched["node_rows"] += ni.numel()
        if ni.numel():
            lo, hi, codes = _node_boxes(rows[node], arity)
            fetched["child_tests"] += int((codes != 0).sum())
            if instanced:
                o_n, inv_n = space.node_ray(ni, (code[node] >> 2) < blas_base,
                                            o, inv)
            else:
                o_n, inv_n = o[ni], inv[ni]
            hit, _ = slab(lo, hi, o_n, inv_n, tmin, tmax)
            _push(stack, sp, ni, codes, hit & (codes != 0))

        leaf = ~node if is_inst is None else ~node & ~is_inst
        li = idx[leaf]
        fetched["leaf_rows"] += li.numel()
        if li.numel():
            lrows = rows[leaf]
            fetched["tri_tests"] += _real_triangles(lrows, leaf_size)
            if instanced:  # back faces culled by the object-space winding
                ol, dl = space.o[li], space.d[li]
            else:
                ol, dl = o[li], d[li]
            hit_any = torch.zeros((li.numel(),), dtype=torch.bool, device=dev)
            for k in range(leaf_size):
                hk, _, _, _ = tri_test(lrows[:, 9 * k: 9 * k + 9], ol, dl,
                                       tmin, tmax, cull=cull_backface)
                hit_any |= hk
            occ[li] = hit_any
    _add_stats(stats, fetched, seen)
    return occ


@tracing.spanned(tracing.K2)
def occluded(table, o, d, active, tmin: float, tmax: float,
             stack_depth: int, arity: int, leaf_size: int, *,
             num_instances: int = 0, inst_base: int = 0, blas_base: int = 0,
             cull_backface: bool = True, count=None, counter=None, out=None):
    """Any-hit occlusion with first-hit exit -> (N,) bool; back faces do not
    occlude unless ``cull_backface`` is False. CUDA tensors launch K2 at
    the table's layout (``KERNEL_LAYOUTS``), walking only the active lanes
    (of the first ``count`` where it is given; into the (N,) bool ``out``
    where it is given): its instanced variant where ``num_instances > 0``,
    its non-culling instantiation where ``cull_backface`` is False (of
    either, on a two-level table); CPU tensors run ``occluded_plain``."""
    inst_kw = {"num_instances": num_instances, "inst_base": inst_base,
               "blas_base": blas_base}
    _check(table, o, d, active, stack_depth, **inst_kw)
    _card_only(table, count=count, counter=counter, out=out)
    if table.device.type == "cpu":
        return occluded_plain(table, o, d, active, tmin, tmax, stack_depth,
                              arity, leaf_size, cull_backface=cull_backface,
                              **inst_kw)
    n, dev = o.shape[0], o.device
    _kernel_layout(table, n, arity, leaf_size)
    occ = torch.empty((n,), dtype=torch.bool, device=dev) if out is None \
        else out
    if n == 0:  # nothing to launch
        return occ
    args = TraverseArgs()
    args.occ_out = occ.data_ptr()
    if num_instances:
        args.inst_base, args.blas_base = inst_base, blas_base
    _launch(_OCCLUDED[bool(num_instances), bool(cull_backface)], args, table,
            o, d, active, tmin, tmax, stack_depth, arity, leaf_size, count,
            counter)
    return occ
