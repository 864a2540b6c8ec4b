"""Foveation sweep (counterpart of the JAX package's
``apps/benchmark_sweep.py``, after the reference's archived benchmark
suite): the spp schedules ``32_2_1`` ... ``32_16_8`` and a uniform
full-resolution baseline, each timed over ``--frames`` frames, written as
one TSV a schedule (the triangle count tag on its first line) and the
``frame_rate.dat`` / ``rendering_time.dat`` summaries.

    python -m fovpathtracing_optixcodelatest_tpu_torch.apps.benchmark_sweep \\
        --scene box_city --width 480 --height 270 --frames 4 --out-dir out

It renders on ``cuda`` unless ``--device cpu`` is given; times are host
clock up to a device synchronize, after two frames not timed. The JAX
sweep gives its uniform baseline ``traversal_phase1_cap=0``, a knob of the
TPU's traversal that the port has no counterpart of (``config.py``): here
both run the same config.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

SWEEPS = ["32_2_1", "32_4_2", "32_8_4", "32_16_8"]


def run_config(scene, cam, config, schedule, frames: int, seed: int = 0,
               device="cuda"):
    """-> (fps, ms a frame, traces) over ``frames`` frames."""
    import torch

    from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import (
        fold_in,
        prng_key,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render import film
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        render_frame,
    )

    dev = torch.device(device)
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    w, h = config.width, config.height
    camp = dataclasses.replace(cam, aspect=w / h).device_params(dev)
    pad = film.schedule_padding(schedule, w, h)
    canvas = film.new_canvas(w, h, pad, dev)
    gx, gy = w // 2, h // 2
    key = prng_key(seed)
    for i in range(2):  # the kernels' build at first use, then one more
        canvas, frame, stats = render_frame(
            scene, camp, gx, gy, i, canvas, fold_in(key, 100 + i), config,
            schedule)
    sync()
    t0 = time.perf_counter()
    traces = 0
    for i in range(frames):
        canvas, frame, stats = render_frame(
            scene, camp, gx, gy, i + 1, canvas, fold_in(key, i + 1), config,
            schedule)
        traces = traces + stats["traces"]
    traces = int(traces)  # reads the device: the frames are done
    sync()
    dt = time.perf_counter() - t0
    return frames / dt, 1000.0 * dt / frames, traces


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="box_city",
                    choices=["box_city", "cornell"])
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--uniform-spp", type=int, default=32,
                    help="full-resolution baseline spp (reference: 32)")
    ap.add_argument("--skip-uniform", action="store_true",
                    help="skip the (slow) uniform full-spp baseline")
    ap.add_argument("--scale-rings", action="store_true",
                    help="scale the 74/241 ring radii from their 960x540 "
                         "design resolution to --height")
    ap.add_argument("--out-dir", default="bench_out")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    args = ap.parse_args(argv)

    from fovpathtracing_optixcodelatest_tpu_torch.config import (
        FoveationSchedule,
        RenderConfig,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
    from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
        gradient_sky_probe,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
        build_scene,
    )

    os.makedirs(args.out_dir, exist_ok=True)
    meshes, cam = (scenes.box_city() if args.scene == "box_city"
                   else scenes.cornell())
    scene = build_scene(meshes, gradient_sky_probe(), device=args.device)
    config = RenderConfig(width=args.width, height=args.height)
    print(f"{args.scene}: {scene.num_triangles} tris", file=sys.stderr)

    if args.scale_rings:
        scale = args.height / 540.0
        inner, outer = max(int(74 * scale), 4), max(int(241 * scale), 12)
    else:
        inner, outer = 74, 241
    results = {}
    for name in SWEEPS:
        f, a, p = (int(x) for x in name.split("_"))
        sched = FoveationSchedule.sweep(f, a, p, inner=inner, outer=outer)
        fps, ms, traces = run_config(scene, cam, config, sched, args.frames,
                                     device=args.device)
        results[f"fov_{name}"] = (fps, ms, traces)
        print(f"fov {name}: {fps:.2f} fps, {ms:.0f} ms/frame",
              file=sys.stderr)
        with open(os.path.join(args.out_dir,
                               f"{args.scene}_fov_{name}.tsv"), "w") as fh:
            fh.write(f"{scene.num_triangles:.0e}\n")
            fh.write("config\tfps\tms_per_frame\ttraces\n")
            fh.write(f"{name}\t{fps:.3f}\t{ms:.1f}\t{traces}\n")

    if not args.skip_uniform:
        sched_u = FoveationSchedule.uniform(args.uniform_spp)
        fps, ms, traces = run_config(scene, cam, config, sched_u,
                                     args.frames, device=args.device)
        results["uniform"] = (fps, ms, traces)
        print(f"uniform {args.uniform_spp}spp: {fps:.2f} fps, {ms:.0f} ms",
              file=sys.stderr)

    with open(os.path.join(args.out_dir, "frame_rate.dat"), "w") as fh:
        fh.write("\t".join(results.keys()) + "\n")
        fh.write("\t".join(f"{v[0]:.3f}" for v in results.values()) + "\n")
    with open(os.path.join(args.out_dir, "rendering_time.dat"), "w") as fh:
        fh.write("\t".join(results.keys()) + "\n")
        fh.write("\t".join(f"{v[1]:.1f}" for v in results.values()) + "\n")
    if "uniform" in results:
        base = results["uniform"][1]
        for k, v in results.items():
            if k != "uniform":
                print(f"speedup {k} vs uniform: {base / v[1]:.1f}x",
                      file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
