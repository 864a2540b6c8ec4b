"""Hold the live-lane compaction (``csrc/lanes.cu``, ``ops/lanes.py``) and
the kernel path's wavefront that rests on it to what they replace, and
time the kernel.

``check_compaction`` compacts a frame's primary lanes (ray generation's
mask over the identity) and then bounce 0's survivors (the plain bounce's
alive mask over that list) on the card, and compares each list, its
length, its rays and the per-depth count with ``torch.nonzero`` /
``idx[alive]`` and the gathers ``o[idx]``, ``d[idx]``, bit for bit.
``check_paths`` traces the same wavefront through ``trace_paths``' kernel
path (``integrator.kernel_paths``: the lane lists on the card) and through
the same kernels over host lists (``host_list_paths``, the narrowing by
``nonzero`` and ``idx[alive]`` that path replaced), and compares radiance,
alpha, normal, albedo and ``traces`` bit for bit and the lanes of each
depth; it also runs one kernel-path wavefront under
``torch.cuda.set_sync_debug_mode("error")``, which raises on any call that
waits for the device.

On the card, from the repository's root:

    python3 -m fovpathtracing_optixcodelatest_tpu_torch.tools.lanes_check \\
        [--city 148] [--texture-size 1024] [--reps 20] [--out FILE]

builds ``box_city_fast(city)`` as ``tools/shade_check.py`` does, takes the
960x540 ``reference_32_16_8`` frame's lanes, runs both checks and times
``compact_kernel`` on bounce 0's survivors (CUDA events, median of
``--reps``) beside the time its least bytes take at 3.35 TB/s, with its
registers, local memory and blocks per SM.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

HBM_BYTES_S = 3.35e12  # the H100 SXM's HBM3
# the least bytes a compaction moves: a position's mask byte; a kept lane's
# list entry read (none for the identity) and written, its rays read and
# written; a tile's status word and the ticket
POSITION_BYTES = 1
KEPT_BYTES = 8 + 24 + 24
LIST_BYTES = 8
STATUS_BYTES = 4


def least_bytes(positions: int, kept: int, identity: bool) -> int:
    """The least bytes of one compaction of ``positions`` positions below
    the length, ``kept`` of them kept."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import lanes

    return (positions * POSITION_BYTES
            + kept * (KEPT_BYTES + (0 if identity else LIST_BYTES))
            + lanes.tile_words(positions) * STATUS_BYTES)


def reference(mask, idx, count: int, o, d):
    """What a compaction replaces: ``nonzero`` on the mask below the length
    (over the identity) or ``idx[alive]``, and the gathers -> (lanes, rays
    o, d)."""
    keep = mask[:count]
    lanes = torch.nonzero(keep).squeeze(1) if idx is None \
        else idx[:count][keep]
    return lanes, o[lanes], d[lanes]


def _compare(out, want) -> dict:
    lanes, o, d = want
    k = lanes.numel()
    got = int(out["count_out"][0])
    same = got == k
    if same:
        same = (torch.equal(out["idx_out"][:k], lanes)
                and torch.equal(out["o_out"][:k].view(torch.int32),
                                o.view(torch.int32))
                and torch.equal(out["d_out"][:k].view(torch.int32),
                                d.view(torch.int32)))
    return {"lanes": k, "count": got, "lanes_per_depth": int(out["lanes"][0]),
            "exact": bool(same) and int(out["lanes"][0]) == k}


def compact_once(mask, idx, count, o, d):
    """One compaction into fresh outputs (``ops/lanes.py`` ``outputs``)."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import lanes

    out = lanes.outputs(mask.shape[0], mask.device)
    lanes.compact(mask, idx, count, o, d, out)
    return out


def check_compaction(primary, alive0, reps: int = 20) -> dict:
    """The compaction against ``nonzero`` / ``idx[alive]`` and the gathers
    on a frame's ``primary`` lanes (origin, direction, active, ray ids of
    ``kernel_times.frame_rays``) and on bounce 0's survivors (``alive0``,
    the plain bounce's mask over the primary list), then at lengths 0, 1,
    a tile, a tile and one, and the capacity over a random mask; the
    survivors' compaction timed (median ms of ``reps``)."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import lanes
    from fovpathtracing_optixcodelatest_tpu_torch.tools.shade_check import (
        _time,
    )

    o, d, act, _ = primary
    n, dev = act.shape[0], act.device
    out = {"device": torch.cuda.get_device_name(), "capacity": n}
    first = compact_once(act, None, None, o, d)
    out["depth0"] = _compare(first, reference(act, None, n, o, d))
    k0 = out["depth0"]["lanes"]
    # bounce 0's mask over the first list, past its length left stale
    mask = torch.ones((n,), dtype=torch.bool, device=dev)
    mask[:k0] = alive0
    second = compact_once(mask, first["idx_out"], first["count_out"], o, d)
    out["depth1"] = _compare(second, reference(mask, first["idx_out"], k0,
                                               o, d))
    g = torch.Generator(device=dev).manual_seed(7)
    noise = torch.rand((n,), generator=g, device=dev) < 0.5
    ids = torch.randperm(n, generator=g, device=dev)
    ragged = {}
    for k in (0, 1, lanes.TILE, lanes.TILE + 1, n):
        cnt = torch.tensor([k], dtype=torch.int32, device=dev)
        ragged[k] = _compare(compact_once(noise, ids, cnt, o, d),
                             reference(noise, ids, k, o, d))
    out["ragged"] = ragged
    out["exact"] = (out["depth0"]["exact"] and out["depth1"]["exact"]
                    and all(r["exact"] for r in ragged.values()))

    # the survivors' compaction alone: fresh zeroed scratch a launch
    outs = [lanes.outputs(n, dev) for _ in range(reps + 1)]
    calls = iter(outs)
    out["compact_ms"] = _time(lambda: lanes.compact(
        mask, first["idx_out"], first["count_out"], o, d, next(calls)), reps)
    out["least_bytes"] = {
        "depth0": least_bytes(n, k0, True),
        "depth1": least_bytes(k0, out["depth1"]["lanes"], False)}
    out["bound_ms"] = out["least_bytes"]["depth1"] / HBM_BYTES_S * 1e3
    out["resources"] = lanes.resources()
    return out


def host_list_paths(scene, origin, direction, active, key, config,
                    ray_ids):
    """The kernel path's bounces over host lane lists, as ``trace_paths``
    ran them before the lists moved to the card: ``nonzero`` on the mask,
    then ``idx[alive]`` after each bounce -> (state, lanes a depth)."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import fold_in
    from fovpathtracing_optixcodelatest_tpu_torch.render import integrator

    st = integrator.PathState.start(
        origin, direction, torch.ones_like(origin))
    ids = ray_ids.to(torch.int64).contiguous()
    idx = torch.nonzero(active).squeeze(1)
    counts = []
    for depth in range(config.max_depth):
        counts.append(idx.numel())
        if idx.numel() == 0:
            continue
        wave = integrator.CardWave.from_indices(idx, st, scene.bvh.instanced)
        alive = integrator.kernel_bounce(scene, st, wave, 0, ids,
                                         fold_in(key, depth), depth == 0,
                                         config)
        idx = idx[alive]
    return st, counts


def check_paths(scene, config, primary) -> dict:
    """A wavefront through the kernel path against the same kernels over
    host lists: every output bit for bit, ``traces``, and the lanes a
    depth; and one kernel-path wavefront under the sync debug mode's
    "error"."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import (
        fold_in,
        prng_key,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render import integrator
    from fovpathtracing_optixcodelatest_tpu_torch.utils import tracing

    o, d, act, ids = primary
    key = fold_in(fold_in(prng_key(0), 0), 1)
    assert integrator.shades_on_kernels(scene, config, o.device)
    before = tracing.snapshot()
    got = integrator.trace_paths(scene, o, d, act, key, config, ray_ids=ids)
    seen = tracing.diff(before, tracing.snapshot())  # folds the lanes in
    st, counts = host_list_paths(scene, o, d, act, key, config, ids)
    want = {"radiance": st.radiance, "alpha": st.alpha,
            "normal": st.normal, "albedo": st.albedo}
    out = {f"{f}_bits_differ": int((got[f].view(torch.int32)
                                    != w.view(torch.int32)).sum())
           for f, w in want.items()}
    out.update(traces=[int(got["traces"]), int(st.traces)],
               lanes=[seen["lanes"].get(k, 0) for k in range(len(counts))],
               host_lanes=counts, syncs=seen["syncs"],
               lane_list=seen["lane_list"])
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        integrator.trace_paths(scene, o, d, act, key, config, ray_ids=ids)
        out["sync_free"] = True
    except RuntimeError as e:
        out["sync_free"] = False
        out["sync_error"] = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    out["exact"] = (all(out[f"{f}_bits_differ"] == 0 for f in want)
                    and out["traces"][0] == out["traces"][1]
                    and out["lanes"] == counts and out["syncs"] == {}
                    and out["sync_free"])
    return out


def check_frame(scene, config, rays: dict, reps: int = 20) -> dict:
    """``check_compaction`` and ``check_paths`` on a frame's rays
    (``kernel_times.frame_rays``)."""
    return {"compaction": check_compaction(rays["primary"],
                                           rays["bounce0"]["alive"], reps),
            "paths": check_paths(scene, config, rays["primary"])}


def main(argv=None) -> int:
    from fovpathtracing_optixcodelatest_tpu_torch.config import (
        FoveationSchedule,
        RenderConfig,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.tools.kernel_times import (
        frame_rays,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.tools.shade_check import (
        bench_scene,
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
    rep = check_frame(scene, config, rays, args.reps)
    line = json.dumps(rep)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if rep["compaction"]["exact"] and rep["paths"]["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
