#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--profile table.txt]

Builds the port's CUDA kernels from ``fovpathtracing_optixcodelatest_tpu_torch/
csrc/`` (into ``build/torch_kernels/``), builds the bench scene (box_city
n=24, seed 0, gradient sky probe: 6,924 triangles), then:

1. checks the closest-hit (K1) and occlusion (K2) kernels against their plain
   PyTorch versions on the frame's full primary-ray batch (1,923,984 lanes
   of the 960x540 reference_32_16_8 schedule): hit, tri_id and occlusion
   must match exactly and t/u/v bit for bit (0 ulp);
2. computes bounce 0's NEE shadow rays through the port's integrator and
   drives the packet-occlusion path (K3, the counterpart of the JAX
   package's Pallas kernel) on them, checking K3 against its plain version
   and against K2 on the same rays; checks K1 against its plain version
   again on bounce 0's incoherent continuation rays;
3. drives the main path, ``Renderer.render`` on ``FRAMES`` 960x540 frames
   after one warm-up frame, counting the
   kernel launches of those frames only, and checks the frame;
4. renders a small frame on the GPU and on the CPU (the plain versions) and
   requires 99% of the pixels within 1 LSB.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``. Any failed check
raises and exits non-zero; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

FRAMES = 4  # timed frames of the main path, after one warm-up frame
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# H100 SXM float32 outside the tensor cores is 67e12 flop/s counting a
# fused multiply-add as two; the kernels are built with --fmad=false, so
# every add, multiply, min or max is one issued instruction at half that.
F32_OPS_PER_S = 67e12 / 2
RAY_BYTES = 3 * 4 + 3 * 4  # origin and direction, read for active lanes only
MASK_BYTES = 1  # the active mask, read for every lane
SLAB_OPS = 21  # per child box: 6 subtracts, 6 multiplies, 6 min/max, 3 tests
MT_OPS = 40  # per triangle: the Möller-Trumbore arithmetic and range tests
RAY_SHAPE = "960x540 reference_32_16_8, box_city n=24 seed 0"


def _line(msg: str) -> None:
    print(msg, flush=True)


def _events_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _plain_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _bound(stats: dict, table, arity: int, leaf_size: int, n_rays: int,
           n_active: int, out_bytes: int):
    """Least time for the work: the bytes the call must move (the table, the
    mask of every lane and the ray of each active lane read once, each
    lane's result written once) at the HBM rate vs the
    float32 operations this run's rays need (every fetched node row's
    ``arity`` slab tests and every fetched leaf row's ``leaf_size``
    triangle tests) at the float32 peak. Returns (ms, "bytes"|"operations",
    row-fetch bytes)."""
    byte_ms = (table.numel() * 4 + n_active * RAY_BYTES
               + n_rays * (MASK_BYTES + out_bytes)) / HBM_BYTES_PER_S * 1e3
    ops = (stats["node_rows"] * arity * SLAB_OPS
           + stats["leaf_rows"] * leaf_size * MT_OPS)
    op_ms = ops / F32_OPS_PER_S * 1e3
    fetch = (stats["node_rows"] + stats["leaf_rows"]) * table.shape[1] * 4
    if byte_ms >= op_ms:
        return byte_ms, "bytes", fetch
    return op_ms, "operations", fetch


def _profile_frames(renderer, path: str, results: dict) -> None:
    """``FRAMES`` more frames under torch.profiler. Per frame: the device's
    busy time (the sum of its kernels' times), the wall time of the same
    profiled frames (host clock, ending in a synchronize), the idle share
    of one in the other, the kernel launches, and the ops that take the
    most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            renderer.render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    events = prof.key_averages()
    dev_ms = lambda e: e.self_device_time_total / 1e3 / FRAMES  # noqa: E731
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_ms(e) for e in kernels)
    ours_ms = sum(dev_ms(e) for e in kernels
                  if e.key.startswith(("closest_hit_kernel",
                                       "occluded_kernel")))
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.key.startswith("aten::")]
    top = sorted(ops, key=dev_ms, reverse=True)[:8]
    launches = sum(e.count for e in kernels) / FRAMES
    idle = 1 - busy_ms / wall_ms
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=80))
    results["profile"] = {
        "frames": FRAMES, "device_busy_ms": busy_ms, "frame_ms": wall_ms,
        "idle_share": idle, "traversal_kernels_ms": ours_ms,
        "device_launches": launches,
        "top_ops": [(e.key, dev_ms(e), e.count / FRAMES) for e in top],
    }
    _line(f"profile ({FRAMES} frames, per frame): device busy {busy_ms:.1f} "
          f"ms of a {wall_ms:.1f} ms profiled frame (idle share {idle:.2f}); "
          f"K1+K2 {ours_ms:.2f} ms; {launches:.0f} device launches; top ops: "
          + "; ".join(f"{e.key} {dev_ms(e):.2f} ms x{e.count / FRAMES:.0f}"
                      for e in top))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measured number to this JSON file")
    ap.add_argument("--profile", default=None,
                    help="profile FRAMES more frames; write the op table "
                    "here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fovpathtracing_optixcodelatest_tpu_torch.config import (
        FoveationPass,
        FoveationSchedule,
        RenderConfig,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
    from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
        gradient_sky_probe,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
        scene_arrays,
        scene_from_arrays,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops import (
        kernel_build,
        packet_traverse,
        traverse,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import (
        fold_in,
        prng_key,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render import (
        integrator,
        raygen,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import Renderer

    results = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: device -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    _line(f"device: {kind} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()}")
    results["device"] = {"nvidia_smi": smi, "kind": kind}

    # -- phase 2: kernel build ---------------------------------------------
    t0 = time.perf_counter()
    kernel_build.library("traverse")
    build_s = time.perf_counter() - t0
    ptxas = [
        ln.strip() for log in kernel_build.BUILD_INFO["log"].values()
        for ln in log.splitlines() if "registers" in ln or "spill" in ln
    ]
    _line(f"build: {build_s:.1f} s for {len(kernel_build.SOURCES)} sources "
          f"(nvcc {kernel_build.BUILD_INFO['seconds']:.1f} s); "
          + " | ".join(ptxas))
    results["build_s"] = build_s

    # -- phase 3: scene ----------------------------------------------------
    w, h = 960, 540
    meshes, cam = scenes.box_city(n=24, seed=0)
    t0 = time.perf_counter()
    arrays = scene_arrays(meshes, gradient_sky_probe(), legacy8=True)
    scene = scene_from_arrays(arrays, device="cuda")
    bvh, leg = scene.bvh, scene.legacy
    _line(f"scene: {scene.num_triangles} tris; packed {bvh.num_rows} rows x "
          f"{bvh.table.shape[1]} cols, stack_depth {bvh.stack_depth}; legacy8 "
          f"{leg.num_rows} rows x {leg.table.shape[1]} cols, stack_depth "
          f"{leg.stack_depth}; host build {time.perf_counter() - t0:.1f} s")
    assert scene.num_triangles == 24 * 24 * 12 + 12
    config = RenderConfig(width=w, height=h)
    schedule = FoveationSchedule.reference_32_16_8()
    camera = dataclasses.replace(cam, aspect=w / h)
    camp = camera.device_params("cuda")

    # the first frame's primary rays (subframe 0 of seed 0)
    frame_key = fold_in(prng_key(0), 0)
    rays = [raygen.generate_pass_rays(camp, p, w, h, w // 2, h // 2,
                                      fold_in(frame_key, 0))
            for p in schedule.passes]
    o = torch.cat([r["origin"] for r in rays]).contiguous()
    d = torch.cat([r["direction"] for r in rays]).contiguous()
    act = torch.cat([r["active"] for r in rays]).contiguous()
    ids = torch.cat([r["ray_ids"] for r in rays])
    n = o.shape[0]
    assert n == 1_923_984, n
    tmin, tmax = config.tmin, config.tmax
    kargs = (tmin, tmax, bvh.stack_depth, bvh.arity, bvh.leaf_size)
    kernels = []

    # -- phase 4: K1 / K2 against their plain versions on primary rays -------
    k1 = traverse.closest_hit(bvh.table, o, d, act, *kargs)
    st1 = {}
    p1, p1_ms = _plain_ms(lambda: traverse.closest_hit_plain(
        bvh.table, o, d, act, *kargs, stats=st1))
    hit_eq = bool(torch.equal(k1["hit"], p1["hit"]))
    tri_eq = bool(torch.equal(k1["tri_id"], p1["tri_id"]))
    hm = p1["hit"]
    ulp = max(
        int((k1[c][hm].view(torch.int32) - p1[c][hm].view(torch.int32))
            .abs().max().item()) if hm.any() else 0
        for c in ("t", "u", "v")
    )
    err1 = max(float((k1[c][hm] - p1[c][hm]).abs().max().item())
               for c in ("t", "u", "v"))
    k1_ms = _events_ms(lambda: traverse.closest_hit(bvh.table, o, d, act,
                                                    *kargs), 5)
    n_act = int(act.sum().item())
    _line(f"K1 closest_hit: {n} lanes ({n_act} active, {int(hm.sum())} hits); "
          f"kernel {k1_ms:.3f} ms, plain {p1_ms:.1f} ms; hit equal {hit_eq}, "
          f"tri_id equal {tri_eq}, t/u/v max {ulp} ulp; rows fetched {st1}")
    assert hit_eq and tri_eq and ulp == 0, "K1 disagrees with its plain version"

    k2p = traverse.occluded(bvh.table, o, d, act, *kargs)
    p2p = traverse.occluded_plain(bvh.table, o, d, act, *kargs)
    mism2p = int((k2p != p2p).sum().item())
    _line(f"K2 occluded on primary rays: {mism2p} mismatches of {n}")
    assert mism2p == 0, "K2 disagrees with its plain version (primary rays)"

    # -- phase 5: bounce-0 shadow rays; the packet-occlusion path (K3) -------
    idx = torch.nonzero(act).squeeze(1)
    b0 = integrator.bounce(
        scene, o[idx], d[idx],
        torch.ones((idx.numel(), 3), dtype=torch.float32, device="cuda"),
        torch.ones((idx.numel(),), dtype=torch.float32, device="cuda"),
        ids[idx], fold_in(fold_in(frame_key, 1), 0), True, config,
    )
    so, sd, sq = b0["shadow_origin"], b0["shadow_dir"], b0["shadow_query"]
    ns, nq = so.shape[0], int(sq.sum().item())
    lt = leg.table
    largs = (tmin, tmax, leg.stack_depth, leg.leaf_size)
    kernel_build.reset_launches()
    k3 = packet_traverse.occluded_packets(lt, so, sd, sq, *largs)
    torch.cuda.synchronize()
    k3_launches = kernel_build.LAUNCHES["occluded_packets"]
    assert k3_launches >= 1, "the packet path did not launch K3"
    st3 = {}
    p3, p3_ms = _plain_ms(lambda: packet_traverse.occluded_packets_plain(
        lt, so, sd, sq, *largs, stats=st3))
    k2 = traverse.occluded(bvh.table, so, sd, sq, *kargs)
    st2 = {}
    p2, p2_ms = _plain_ms(lambda: traverse.occluded_plain(
        bvh.table, so, sd, sq, *kargs, stats=st2))
    mism3, mism32 = int((k3 != p3).sum().item()), int((k3 != k2).sum().item())
    mism2 = int((k2 != p2).sum().item())
    # a boolean answer's largest absolute error is 1 if any ray disagrees
    err2, err3 = float(min(mism2, 1)), float(min(mism3, 1))
    k3_ms = _events_ms(
        lambda: packet_traverse.occluded_packets(lt, so, sd, sq, *largs), 5)
    k2_ms = _events_ms(
        lambda: traverse.occluded(bvh.table, so, sd, sq, *kargs), 5)
    _line(f"shadow rays (bounce 0): {ns} lanes, {nq} queried, "
          f"{int(k2.sum())} occluded")
    _line(f"K2 occluded: kernel {k2_ms:.3f} ms, plain {p2_ms:.1f} ms, "
          f"{mism2} mismatches; rows fetched {st2}")
    _line(f"K3 occluded_packets: kernel {k3_ms:.3f} ms, plain {p3_ms:.1f} ms, "
          f"{mism3} mismatches vs plain, {mism32} vs K2; rows fetched {st3}; "
          f"path launches {k3_launches}")
    assert mism2 == 0, "K2 disagrees with its plain version (shadow rays)"
    assert mism3 == 0, "K3 disagrees with its plain version"
    assert mism32 == 0, "K3 disagrees with K2 on the same rays"
    del p1, p2, p3, p2p, k2p

    # K1 again on bounce 0's continuation rays: incoherent, off-camera
    alive = b0["alive"]
    bo = b0["origin"][alive].contiguous()
    bd = b0["direction"][alive].contiguous()
    bact = torch.ones(bo.shape[0], dtype=torch.bool, device="cuda")
    k1b = traverse.closest_hit(bvh.table, bo, bd, bact, *kargs)
    p1b = traverse.closest_hit_plain(bvh.table, bo, bd, bact, *kargs)
    hmb = p1b["hit"]
    hit_eq_b = bool(torch.equal(k1b["hit"], hmb))
    tri_eq_b = bool(torch.equal(k1b["tri_id"], p1b["tri_id"]))
    ulp_b = max(
        int((k1b[c][hmb].view(torch.int32) - p1b[c][hmb].view(torch.int32))
            .abs().max().item()) if hmb.any() else 0
        for c in ("t", "u", "v")
    )
    err1 = max([err1] + [float((k1b[c][hmb] - p1b[c][hmb]).abs().max().item())
                         for c in ("t", "u", "v") if hmb.any()])
    _line(f"K1 closest_hit on bounce-0 continuation rays: {bo.shape[0]} "
          f"lanes, {int(hmb.sum())} hits; hit equal {hit_eq_b}, tri_id equal "
          f"{tri_eq_b}, t/u/v max {ulp_b} ulp")
    assert hit_eq_b and tri_eq_b and ulp_b == 0, \
        "K1 disagrees with its plain version (bounce-0 continuation rays)"
    del k1b, p1b

    # -- phase 6: the main path ----------------------------------------------
    renderer = Renderer(scene, config, schedule, device="cuda")
    renderer.set_camera(camera)
    renderer.render()  # warm-up frame
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_build.reset_launches()
    frame_ms, traces = [], []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        frame = renderer.render()
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        traces.append(renderer.stats["traces"])
    launches = dict(kernel_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    lin = renderer.linear_frame()
    finite = bool(torch.isfinite(torch.from_numpy(lin)).all())
    mean_ms = sum(frame_ms) / len(frame_ms)
    mrays = sum(traces) / (sum(frame_ms) / 1e3) / 1e6
    _line(f"main path: {FRAMES} frames {w}x{h} after 1 warm-up; ms/frame "
          + ", ".join(f"{x:.1f}" for x in frame_ms)
          + f" (mean {mean_ms:.1f}); traces/frame {traces[-1]}; "
          f"{mrays:.2f} Mrays/s; peak {peak / 2**30:.2f} GiB; frame mean "
          f"{frame.mean():.3f}; finite {finite}; launches {launches}")
    assert frame.shape == (h, w, 3) and finite
    assert 0 < frame.mean() < 255
    assert launches["closest_hit"] > 0, "main path never launched K1"
    assert launches["occluded"] > 0, "main path never launched K2"

    if args.profile:
        _profile_frames(renderer, args.profile, results)

    # -- phase 7: GPU against the CPU plain versions on a small frame ---------
    sw, sh = 64, 48
    small_sched = FoveationSchedule(passes=(
        FoveationPass(factor=4, spp=2, r_inner=8.0, r_outer=1e9, redraw=False),
        FoveationPass(factor=1, spp=4, r_inner=0.0, r_outer=9.0, redraw=True,
                      launch_w=18, launch_h=18, centered=True,
                      center_offset=9),
    ))
    small = scenes.box_city(n=4, seed=0)
    small_arrays = scene_arrays(small[0], gradient_sky_probe(64, 32))
    frames = {}
    for dev in ("cuda", "cpu"):
        r = Renderer(scene_from_arrays(small_arrays, device=dev),
                     RenderConfig(width=sw, height=sh), small_sched,
                     device=dev)
        r.set_camera(dataclasses.replace(small[1], aspect=sw / sh))
        frames[dev] = [r.render() for _ in range(2)]
    share = min(
        float(((a.astype(int) - b.astype(int)).__abs__().max(-1) <= 1).mean())
        for a, b in zip(frames["cuda"], frames["cpu"])
    )
    _line(f"small frame {sw}x{sh}, 2 subframes: GPU vs CPU pixels within "
          f"1 LSB {share:.4f}")
    assert share >= 0.99, "GPU frame disagrees with the CPU reference"

    # -- phase 8: the kernels line ---------------------------------------------
    per_frame = lambda k: launches[k] / FRAMES  # noqa: E731
    b1, b1_by, f1 = _bound(st1, bvh.table, bvh.arity, bvh.leaf_size, n,
                           n_act, 16)
    b2, b2_by, f2 = _bound(st2, bvh.table, bvh.arity, bvh.leaf_size, ns, nq, 1)
    b3, b3_by, f3 = _bound(st3, leg.table, 8, leg.leaf_size, ns, nq, 1)
    _line(f"row fetches (L2 traffic): K1 {f1 / 1e6:.1f} MB, K2 "
          f"{f2 / 1e6:.1f} MB, K3 {f3 / 1e6:.1f} MB")
    src = "fovpathtracing_optixcodelatest_tpu_torch/csrc/"
    jax_ops = "fovpathtracing_optixcodelatest_tpu/ops/"
    kernels = [
        {"name": "closest_hit", "route": "cuda", "source": src + "traverse.cu",
         "replaces": jax_ops + "traverse8.py:795", "launches":
         launches["closest_hit"], "max_abs_err": err1, "ms": k1_ms,
         "plain_ms": p1_ms, "bound_ms": b1, "bound_by": b1_by,
         "library_ms": None},
        {"name": "occluded", "route": "cuda", "source": src + "traverse.cu",
         "replaces": jax_ops + "traverse8.py:1367", "launches":
         launches["occluded"], "max_abs_err": err2, "ms": k2_ms,
         "plain_ms": p2_ms, "bound_ms": b2, "bound_by": b2_by,
         "library_ms": None},
        {"name": "occluded_packets", "route": "cuda",
         "source": src + "packet_traverse.cu",
         "replaces": jax_ops + "pallas_traverse.py:53", "launches":
         k3_launches, "max_abs_err": err3, "ms": k3_ms,
         "plain_ms": p3_ms, "bound_ms": b3, "bound_by": b3_by,
         "library_ms": None},
    ]
    results.update(
        kernels=kernels, frame_ms=frame_ms, traces=traces, mrays_s=mrays,
        peak_bytes=peak, launches_per_frame={k: per_frame(k) for k in launches},
        rows={"k1": st1, "k2": st2, "k3": st3},
        row_fetch_bytes={"k1": f1, "k2": f2, "k3": f3},
        shadow_rays={"lanes": ns, "queried": nq}, small_share=share,
        workload=RAY_SHAPE,
    )
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    _line(smi)
    _line(json.dumps({"kernels": kernels}))
    _line(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
