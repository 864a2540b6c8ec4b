"""Hold the bounce's shading kernels (``csrc/shade.cu``, reached through
``render/integrator.py`` ``kernel_bounce``) to their plain version
(``plain_bounce``) on the same state and lanes, and time them.

``bounce_both`` runs one bounce both ways from copies of one
``PathState`` and reports, for the lanes, the masks that disagree
(``hit_mask``, ``shadow_query``, ``alpha_set``, ``alive``), ``traces``,
and for each float output of the state (origin, direction, throughput,
eta, radiance, alpha, normal, albedo) the rows that differ and their
largest distance in units in the last place, on the lanes whose masks
agree. ``frame_rays`` (``kernel_times``) gives a frame's primary lanes.

On the card, from the repository's root:

    python3 -m fovpathtracing_optixcodelatest_tpu_torch.tools.shade_check \\
        [--city 148] [--texture-size 1024] [--reps 20] [--out FILE]

builds ``box_city_fast(city)`` (textured as ``box_city_textured`` maps its
faces, at ``--texture-size``; 0 leaves it untextured) under the gradient
sky, takes the 960x540 ``reference_32_16_8`` frame's primary lanes, holds
the kernels to the plain bounce at depths 0 and 1, and times ``shade`` and
``resolve`` at the bounce-0 lane count with CUDA events (median of
``--reps``), with their registers, local memory and blocks per SM and
the time their least bytes take at the HBM's 3.35 TB/s (``least_bytes``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys

import torch

FLOATS = ("o", "d", "throughput", "eta", "radiance", "alpha", "normal",
          "albedo")
HBM_BYTES_S = 3.35e12  # the H100 SXM's HBM3


def ordered(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 keys whose differences count the representable
    floats between two values (both zeros map to 0)."""
    b = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(b < 0, -(b & 0x7FFFFFFF), b)


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-element distance of two float32 tensors in units in the last
    place; 0 where both are NaN, 2**32 where one is."""
    d = (ordered(a) - ordered(b)).abs()
    na, nb = torch.isnan(a), torch.isnan(b)
    d = torch.where(na & nb, 0, d)
    return torch.where(na ^ nb, 1 << 32, d)


def clone_state(st):
    return dataclasses.replace(st, **{
        f.name: (None if getattr(st, f.name) is None
                 else getattr(st, f.name).clone())
        for f in dataclasses.fields(st)})


def bounce_both(scene, config, st, idx, ray_ids, key, primary: bool):
    """One bounce of the lanes ``idx`` both ways from copies of ``st`` ->
    (report, the plain bounce's state, its alive mask). The kernels' masks
    are read from what ``shade`` returns (its query and the record's
    flags), the plain ones from ``bounce``'s dict."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import shade as shade_ops
    from fovpathtracing_optixcodelatest_tpu_torch.render import integrator

    sp, sk = clone_state(st), clone_state(st)
    seen = {}
    real_bounce, real_shade = integrator.bounce, shade_ops.shade

    def plain(*args, **kwargs):
        seen["plain"] = out = real_bounce(*args, **kwargs)
        return out

    def kernel(*args, **kwargs):
        seen["kernel"] = out = real_shade(*args, **kwargs)
        return out

    integrator.bounce, shade_ops.shade = plain, kernel
    try:
        alive_p = integrator.plain_bounce(scene, sp, idx, ray_ids, key,
                                          primary, config)
        wave = integrator.CardWave.from_indices(idx, sk, scene.bvh.instanced)
        alive_k = integrator.kernel_bounce(
            scene, sk, wave, 0, ray_ids.to(torch.int64).contiguous(), key,
            primary, config)
    finally:
        integrator.bounce, shade_ops.shade = real_bounce, real_shade
    b = seen["plain"]
    _, _, query, rec = seen["kernel"]
    flags = rec[shade_ops.REC_FLAGS].view(torch.int32)
    hit_k = (flags & 1) != 0
    catcher_k = (flags & 4) != 0
    masks = {
        "hit_mask": (b["hit_mask"], hit_k),
        "shadow_query": (b["shadow_query"], query),
        "alpha_set": (b["alpha_set"], hit_k & ~catcher_k),
        "alive": (alive_p, alive_k),
    }
    rep = {"lanes": int(idx.numel()),
           "hits": int(b["hit_mask"].sum()),
           "queries": int(b["shadow_query"].sum()),
           "alive_lanes": int(alive_p.sum()),
           "traces": [int(sp.traces), int(sk.traces)]}
    agree = torch.ones_like(alive_p)
    for name, (p, k) in masks.items():
        rep[f"{name}_mismatch"] = int((p != k).sum())
        agree &= p == k
    rows = idx[agree]
    for name in FLOATS:
        u = ulps(getattr(sp, name)[rows], getattr(sk, name)[rows])
        u = u.reshape(rows.numel(), -1).amax(dim=1) if u.ndim > 1 else u
        rep[f"{name}_rows_differ"] = int((u > 0).sum())
        rep[f"{name}_max_ulp"] = int(u.max()) if u.numel() else 0
    return rep, sp, alive_p


def exact(rep: dict, max_ulp: int = 0) -> bool:
    """Every mask agrees, ``traces`` too, and every float output within
    ``max_ulp``."""
    return (all(rep[f"{m}_mismatch"] == 0 for m in
                ("hit_mask", "shadow_query", "alpha_set", "alive"))
            and rep["traces"][0] == rep["traces"][1]
            and all(rep[f"{f}_max_ulp"] <= max_ulp for f in FLOATS))


def least_bytes(rep: dict, textured: bool, primary: bool) -> dict:
    """The least bytes ``shade`` and ``resolve`` move for the lanes of a
    ``bounce_both`` report, each word they use read or written once: shade
    reads a lane's index, ray, hit flag, ray id and probe row (8 + 24 + 1 +
    8 + 52) and writes K2's ray and mask and the flags (24 + 1 + 4); a hit
    adds t, tri_id and eta (12), the 19 ``tri_pack`` words it uses (76) and
    13 record words (52; 6 more at depth 0, 24), and on a textured hit the
    uvs and id (28), 4 taps (48) and the size pair (16). resolve reads a
    lane's index, flags, occlusion, query and p and rewrites its origin and
    radiance (8 + 4 + 1 + 1 + 12 + 12 + 24) and writes alive (1), at depth
    0 the normal and albedo (24); a hit adds light, throughput, direction
    and alpha (12 + 12 + 24 + 12; at depth 0 the record's normal and albedo,
    24), a continuing lane emission, thr_scale and the new throughput
    (36)."""
    lanes, hits, cont = rep["lanes"], rep["hits"], rep["alive_lanes"]
    hit_b = 12 + 76 + 52 + (24 if primary else 0) + (92 if textured else 0)
    shade_b = lanes * 122 + hits * hit_b
    resolve_b = (lanes * (62 + 1 + (24 if primary else 0))
                 + hits * (60 + (24 if primary else 0)) + cont * 36)
    return {"shade": shade_b, "resolve": resolve_b}


def _time(fn, reps: int) -> float:
    start = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    end = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    fn()
    for s, e in zip(start, end):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(start, end))


def bench_scene(city: int, texture_size: int, device="cuda"):
    """``box_city_fast(city)`` under the gradient sky, its faces mapped as
    ``box_city_textured`` maps them onto 8 procedural textures of
    ``texture_size`` (none at 0) -> (scene, camera)."""
    import numpy as np

    from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
    from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
        gradient_sky_probe,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
        build_scene,
    )

    meshes, cam = scenes.box_city_fast(n=city, seed=0)
    images = None
    if texture_size:
        rng = np.random.default_rng(7)
        hues = rng.uniform(0.4, 1.0, (8, 3)).astype(np.float32)
        images = [scenes._procedural_texture(hues[k], k % 3, texture_size)
                  for k in range(8)]
        face = np.asarray([[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]],
                          dtype=np.float32)
        meshes = [dataclasses.replace(
            m, texcoord=(np.tile(face, (m.vertex.shape[0] // 6, 1))
                         * (4.0 if i == 0 else 2.0)).astype(np.float32),
            diffuse_texture_id=i % 8) for i, m in enumerate(meshes)]
    scene = build_scene(meshes, gradient_sky_probe(width=256, height=128),
                        images, device=device)
    return scene, cam


def check_frame(scene, config, primary, reps: int = 20) -> dict:
    """The kernels against the plain bounce on a frame's ``primary`` lanes
    (origin, direction, active, ray ids of ``kernel_times.frame_rays``) at
    depth 0 and on their survivors at depth 1 (``depth0``, ``depth1``,
    ``exact``), then ``shade`` and ``resolve`` alone on depth 0's lanes,
    timed (median ms of ``reps``) beside one plain bounce, with their
    resources and least bytes (``bound_ms`` at 3.35 TB/s)."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import (
        kernel_build,
        shade as shade_ops,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import (
        fold_in,
        prng_key,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render import integrator

    o, d, act, ids = primary
    ids = ids.to(torch.int64).contiguous()
    idx = torch.nonzero(act).squeeze(1)
    key = fold_in(fold_in(prng_key(0), 1), 0)
    st = integrator.PathState.start(o, d, torch.ones_like(o))
    kernel_build.reset_launches()
    out = {"device": torch.cuda.get_device_name(),
           "triangles": scene.num_triangles, "lanes": int(idx.numel()),
           "resources": shade_ops.resources()}
    rep0, st1, alive = bounce_both(scene, config, st, idx, ids, key, True)
    rep1, _, _ = bounce_both(scene, config, st1, idx[alive], ids,
                             fold_in(key, 1), False)
    out.update(depth0=rep0, depth1=rep1,
               exact=exact(rep0) and exact(rep1))

    # the kernels alone at the bounce-0 lanes, from one K1/K2 answer
    o_k, d_k = st.o[idx], st.d[idx]
    every = torch.ones((idx.numel(),), dtype=torch.bool, device=o.device)
    hit = integrator._closest(scene, o_k, d_k, every, config)
    p, wi, query, rec = shade_ops.shade(scene, idx, o_k, d_k, hit, st.eta,
                                        ids, key, True)
    occ = integrator._occluded(scene, p, wi, query, config)
    scratch = clone_state(st)
    out["shade_ms"] = _time(lambda: shade_ops.shade(
        scene, idx, o_k, d_k, hit, st.eta, ids, key, True), reps)
    out["resolve_ms"] = _time(lambda: shade_ops.resolve(
        idx, rec, p, occ, query, scratch, True, scene.has_catcher), reps)
    out["plain_bounce_ms"] = _time(lambda: integrator.plain_bounce(
        scene, clone_state(st), idx, ids, key, True, config), 3)
    out["least_bytes"] = least_bytes(rep0, scene.has_textures, True)
    out["bound_ms"] = {k: v / HBM_BYTES_S * 1e3
                       for k, v in out["least_bytes"].items()}
    out["launches"] = {k: v for k, v in kernel_build.LAUNCHES.items() if v}
    return out


def main(argv=None) -> int:
    from fovpathtracing_optixcodelatest_tpu_torch.config import (
        FoveationSchedule,
        RenderConfig,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.tools.kernel_times import (
        frame_rays,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--city", type=int, default=148)
    ap.add_argument("--texture-size", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    scene, cam = bench_scene(args.city, args.texture_size)
    config = RenderConfig(width=960, height=540)
    camera = dataclasses.replace(cam, aspect=960 / 540)
    rays = frame_rays(scene, camera, config,
                      FoveationSchedule.reference_32_16_8())
    line = json.dumps(check_frame(scene, config, rays["primary"], args.reps))
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
