"""Closest-hit and occlusion traversal of the packed wide BVH (counterpart of
the JAX package's ``ops/traverse8.py`` ``closest_hit``/``occluded``).

``closest_hit`` and ``occluded`` are the kernel wrappers: on a CUDA tensor
they launch the hand-written kernels of ``csrc/traverse.cu`` (K1, K2) and
raise if the launch fails; on a CPU tensor they run ``closest_hit_plain`` /
``occluded_plain``. The kernels are compiled for the one packed layout the
port builds, ``bvh8.ARITY`` x ``bvh8.LEAF_SIZE`` (16, 6): on a CUDA tensor
any other (arity, leaf_size), or a table that is not 16-byte aligned, raises
``ValueError``. The plain versions take any layout: they walk every ray's
stack as one (N, stack_depth) int64 tensor with masked gathers and repeat
the kernels' arithmetic and visit order operation for operation, so the two
agree bit for bit.

Visit order is the reference's: a closest-hit stack entry is the packed key
``(mono(tn) & himask) | code``; a node's hit children are pushed sorted by
descending key (the nearest ends on top); a popped entry whose key exceeds
``mono(min(t, tmax)) | lowmask`` is stale and skipped.
"""

from __future__ import annotations

import torch

from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
from fovpathtracing_optixcodelatest_tpu_torch.ops.bvh8 import (
    ARITY,
    LEAF_SIZE,
    codebits,
)

_MASK = 0xFFFFFFFF
MAX_STACK = 128  # deepest stack the wrappers take
# what the plain versions' ``stats`` count: rows fetched, and the tests done
# on them (non-empty children slab-tested, real triangles tested)
STATS = ("node_rows", "leaf_rows", "child_tests", "tri_tests")


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


def _check(table, o, d, active, stack_depth):
    dev = table.device
    if table.dtype != torch.float32 or table.ndim != 2:
        raise ValueError("table must be a 2-D float32 tensor")
    for name, x in (("origin", o), ("direction", d)):
        if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} must be (N, 3) float32")
        if x.shape[0] != o.shape[0]:
            raise ValueError("origin and direction differ in length")
    if active.dtype != torch.bool or active.shape != (o.shape[0],):
        raise ValueError("active must be an (N,) bool tensor")
    if any(x.device != dev for x in (o, d, active)):
        raise ValueError("table and rays must lie on one device")
    if not 1 <= stack_depth <= MAX_STACK:
        raise ValueError(f"stack_depth {stack_depth} outside [1, {MAX_STACK}]")
    if dev.type == "cuda":
        for x in (table, o, d, active):
            if not x.is_contiguous():
                raise ValueError("kernel inputs must be contiguous")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")


def _kernel_layout(table, n: int, arity: int, leaf_size: int,
                   want=(ARITY, LEAF_SIZE), width: int = 4 * ARITY) -> None:
    """Refuse what a compiled kernel does not take: another (arity,
    leaf_size) layout than ``want`` (K1/K2: the packed (ARITY, LEAF_SIZE)),
    rows not ``width`` columns wide, a table that is not 16-byte aligned
    (rows are read as uint4), or more rays than an int32 counter can hand
    out."""
    if (arity, leaf_size) != want:
        raise ValueError(
            f"the CUDA kernel takes only the {want} layout, not "
            f"({arity}, {leaf_size})")
    if table.shape[1] != width:
        raise ValueError(f"the kernel's rows need {width} columns")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    if n >= 2**31 - 2**20:
        raise ValueError("too many rays for one launch")


# ---------------------------------------------------------------------------
# closest hit (K1)
# ---------------------------------------------------------------------------


def closest_hit_plain(table, o, d, active, tmin: float, tmax: float,
                      stack_depth: int, arity: int, leaf_size: int,
                      stats: dict | None = None):
    """Plain PyTorch K1: dict(t, tri_id, u, v, hit). ``stats`` gets the
    node and leaf rows fetched (``node_rows``, ``leaf_rows``) and the work
    in them (``child_tests``: slab tests of the fetched nodes' non-empty
    children; ``tri_tests``: ray-triangle tests of the fetched leaves' real,
    non-padding triangles)."""
    n, dev = o.shape[0], o.device
    cb = codebits(table.shape[0])
    lowmask = (1 << cb) - 1
    himask = _MASK & ~lowmask
    inv = safe_inv(d)
    t = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    u = torch.zeros((n,), dtype=torch.float32, device=dev)
    v = torch.zeros((n,), dtype=torch.float32, device=dev)
    best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    stack = torch.zeros((n, stack_depth), dtype=torch.int64, device=dev)
    sp = active.to(torch.int64)  # the root (code 0) sits at depth 0
    fetched = dict.fromkeys(STATS, 0)
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
        rows = table[code >> 2]
        node = (code & 3) == 0

        ni = idx[node]
        fetched["node_rows"] += ni.numel()
        if ni.numel():
            lo, hi, codes = _node_boxes(rows[node], arity)
            fetched["child_tests"] += int((codes != 0).sum())
            hit, tn = slab(lo, hi, o[ni], inv[ni], tmin, tlimit[node][:, None])
            hit = hit & (codes != 0)
            keys = torch.where(hit, (mono_u32(tn) & himask) | codes, 0)
            keys = torch.sort(keys, dim=1, descending=True).values
            cnt = hit.sum(dim=1)
            keep = torch.arange(arity, device=dev)[None, :] < cnt[:, None]
            _push(stack, sp, ni, keys, keep)

        li = idx[~node]
        fetched["leaf_rows"] += li.numel()
        if li.numel():
            lrows = rows[~node]
            fetched["tri_tests"] += _real_triangles(lrows, leaf_size)
            tb, ub, vb, bb = t[li], u[li], v[li], best[li]
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
            t[li], u[li], v[li], best[li] = tb, ub, vb, bb
    if stats is not None:
        for name, count in fetched.items():
            stats[name] = stats.get(name, 0) + count
    return {"t": t, "tri_id": best, "u": u, "v": v, "hit": best >= 0}


def closest_hit(table, o, d, active, tmin: float, tmax: float,
                stack_depth: int, arity: int, leaf_size: int):
    """Closest hit of each active ray: dict(t, tri_id, u, v, hit) of (N,)
    tensors (miss: t = inf, tri_id = -1, u = v = 0). CUDA tensors launch K1
    (the (16, 6) layout only); CPU tensors run ``closest_hit_plain``."""
    _check(table, o, d, active, stack_depth)
    if table.device.type == "cpu":
        return closest_hit_plain(table, o, d, active, tmin, tmax,
                                 stack_depth, arity, leaf_size)
    n, dev = o.shape[0], o.device
    _kernel_layout(table, n, arity, leaf_size)
    cb = codebits(table.shape[0])
    if cb > 26:
        raise ValueError("table too large for packed tn|code stack entries")
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:  # nothing to launch
        return {"t": t, "tri_id": tri, "u": u, "v": v, "hit": tri >= 0}
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    rc = kernel_build.library("traverse").fov_closest_hit(
        table.data_ptr(), o.data_ptr(), d.data_ptr(), active.data_ptr(), n,
        tmin, tmax, stack_depth, (1 << cb) - 1, t.data_ptr(),
        tri.data_ptr(), u.data_ptr(), v.data_ptr(), counter.data_ptr(),
        kernel_build.stream(),
    )
    kernel_build.check(rc, "closest_hit")
    kernel_build.LAUNCHES["closest_hit"] += 1
    return {"t": t, "tri_id": tri, "u": u, "v": v, "hit": tri >= 0}


# ---------------------------------------------------------------------------
# occlusion (K2)
# ---------------------------------------------------------------------------


def occluded_plain(table, o, d, active, tmin: float, tmax: float,
                   stack_depth: int, arity: int, leaf_size: int,
                   stats: dict | None = None):
    """Plain PyTorch K2 -> (N,) bool. Children are pushed in slot order.
    ``stats`` counts as ``closest_hit_plain``'s does."""
    n, dev = o.shape[0], o.device
    inv = safe_inv(d)
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    stack = torch.zeros((n, stack_depth), dtype=torch.int64, device=dev)
    sp = active.to(torch.int64)
    fetched = dict.fromkeys(STATS, 0)
    while True:
        idx = torch.nonzero((sp > 0) & ~occ).squeeze(1)
        if idx.numel() == 0:
            break
        sp[idx] -= 1
        code = stack[idx, sp[idx]]
        rows = table[code >> 2]
        node = (code & 3) == 0

        ni = idx[node]
        fetched["node_rows"] += ni.numel()
        if ni.numel():
            lo, hi, codes = _node_boxes(rows[node], arity)
            fetched["child_tests"] += int((codes != 0).sum())
            hit, _ = slab(lo, hi, o[ni], inv[ni], tmin, tmax)
            _push(stack, sp, ni, codes, hit & (codes != 0))

        li = idx[~node]
        fetched["leaf_rows"] += li.numel()
        if li.numel():
            lrows = rows[~node]
            fetched["tri_tests"] += _real_triangles(lrows, leaf_size)
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


def occluded(table, o, d, active, tmin: float, tmax: float,
             stack_depth: int, arity: int, leaf_size: int):
    """Any-hit occlusion with back faces culled and first-hit exit -> (N,)
    bool. CUDA tensors launch K2 (the (16, 6) layout only), which walks only
    the active lanes; CPU tensors run ``occluded_plain``."""
    _check(table, o, d, active, stack_depth)
    if table.device.type == "cpu":
        return occluded_plain(table, o, d, active, tmin, tmax, stack_depth,
                              arity, leaf_size)
    n, dev = o.shape[0], o.device
    _kernel_layout(table, n, arity, leaf_size)
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:  # nothing to launch
        return occ
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    rc = kernel_build.library("traverse").fov_occluded(
        table.data_ptr(), o.data_ptr(), d.data_ptr(), active.data_ptr(), n,
        tmin, tmax, stack_depth, occ.data_ptr(), counter.data_ptr(),
        kernel_build.stream(),
    )
    kernel_build.check(rc, "occluded")
    kernel_build.LAUNCHES["occluded"] += 1
    return occ
