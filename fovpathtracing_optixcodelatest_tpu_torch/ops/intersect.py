"""Möller-Trumbore and the brute-force closest-hit / occlusion oracles
(counterpart of the JAX package's ``ops/intersect.py``). The oracles take
the triangles as (T, 3) ``v0``/``e1``/``e2`` tensors (``tri_pack`` columns
36:45) and scan them in chunks of rays and of triangles."""

from __future__ import annotations

import torch

from fovpathtracing_optixcodelatest_tpu_torch.ops.sampling import cross, dot

# rays the oracles take at a time: each (RAY_CHUNK, 512, 3) float32
# temporary of Möller-Trumbore is 100 MB, a whole 960x540 frame's 3.2 GB
RAY_CHUNK = 16384


def ray_triangle(origin, direction, v0, e1, e2, tmin, tmax,
                 cull_backface: bool = False):
    """Broadcasting Möller-Trumbore -> (t, u, v, hit); t is undefined where
    hit is False. ``cull_backface`` keeps only det > 1e-9."""
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    det_ok = det > 1e-9 if cull_backface else det.abs() > 1e-9
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tvec = origin - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(direction, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= tmin) & (t <= tmax))
    return t, u, v, hit


def brute_force_closest_hit(v0, e1, e2, origin, direction, tmin, tmax,
                            chunk: int = 512):
    """O(N·T) closest hit -> dict(t, tri_id int32 (-1 = miss), u, v, hit).
    Rays go ``RAY_CHUNK`` at a time against triangles ``chunk`` at a time,
    so the (rays, triangles, 3) temporaries stay bounded."""
    n = origin.shape[0]
    dev = origin.device
    bt = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    bid = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros((n,), dtype=torch.float32, device=dev)
    bv = torch.zeros((n,), dtype=torch.float32, device=dev)
    for r in range(0, n, RAY_CHUNK):
        sl = slice(r, r + RAY_CHUNK)
        o = origin[sl, None, :]
        d = direction[sl, None, :]
        rows = torch.arange(o.shape[0], device=dev)
        ct, cid, cu, cv = bt[sl], bid[sl], bu[sl], bv[sl]
        for s in range(0, v0.shape[0], chunk):
            t, u, v, hit = ray_triangle(
                o, d, v0[None, s:s + chunk], e1[None, s:s + chunk],
                e2[None, s:s + chunk], tmin, tmax,
            )
            t = torch.where(hit, t, float("inf"))
            k = torch.argmin(t, dim=1)
            tk = t[rows, k]
            better = tk < ct
            ct = torch.where(better, tk, ct)
            cid = torch.where(better, (s + k).to(torch.int32), cid)
            cu = torch.where(better, u[rows, k], cu)
            cv = torch.where(better, v[rows, k], cv)
        bt[sl], bid[sl], bu[sl], bv[sl] = ct, cid, cu, cv
    return {"t": bt, "tri_id": bid, "u": bu, "v": bv, "hit": bid >= 0}


def brute_force_occluded(v0, e1, e2, origin, direction, tmin, tmax,
                         chunk: int = 512, cull_backface: bool = True):
    """Any-hit occlusion -> (N,) bool; back faces do not occlude unless
    ``cull_backface`` is False. Chunked as ``brute_force_closest_hit``."""
    n = origin.shape[0]
    occ = torch.zeros((n,), dtype=torch.bool, device=origin.device)
    for r in range(0, n, RAY_CHUNK):
        sl = slice(r, r + RAY_CHUNK)
        o = origin[sl, None, :]
        d = direction[sl, None, :]
        c = occ[sl]
        for s in range(0, v0.shape[0], chunk):
            _, _, _, hit = ray_triangle(
                o, d, v0[None, s:s + chunk], e1[None, s:s + chunk],
                e2[None, s:s + chunk], tmin, tmax,
                cull_backface=cull_backface,
            )
            c = c | hit.any(dim=1)
        occ[sl] = c
    return occ
