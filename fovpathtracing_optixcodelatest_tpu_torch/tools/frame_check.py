"""Hold the frame's ray generation and film kernels (``csrc/frame.cu``,
through ``ops/frame.py``) to their plain versions
(``renderer.plain_frame_rays``; ``renderer.plain_composite_passes`` with
``film.finalize``) and time each alone.

On the card, from the repository's root:

    python3 -m fovpathtracing_optixcodelatest_tpu_torch.tools.frame_check \\
        [--size 960 540] [--size 1800 1920] [--reps 20] [--out FILE]

For each frame size (default: the mono cells' 960x540 and the headset's
1800x1920 eye) at ``reference_32_16_8`` with the gaze at the centre, under
the cells' 256x128 gradient sky: ``raygen`` against the plain rays
(``rays_exact``: origin, direction, active, ray ids and rings bit for bit)
and ``film`` against the plain film over subframes 0, 1 and 7, on slot
values of six decades (``film_exact``) and on the frame's own, traced on
the scene (``film_exact_traced``: canvas and frame bit for bit); then
each kernel alone (its struct built once, ``raygen_ms``, ``film_ms``), each
through its wrapper as a frame calls it (``*_call_ms``: the host's packing
shows where it outlasts the kernel) and its plain version, timed with CUDA
events (median ms of ``--reps``, the plain versions of 3), beside the time
their least bytes take at the HBM's 3.35 TB/s (``bound_ms``), and the
kernels' registers, local memory and blocks per SM. The least bytes:
raygen writes each ray's origin, direction, active flag and id (33 B) and
each launch pixel's ring flag; the film reads each ray's radiance and
alpha (24 B) and each canvas pixel of its box (12 B), writes each pixel of
the passes' regions (12 B) and each frame pixel (3 B).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys

import torch

HBM_BYTES_S = 3.35e12  # the H100 SXM's HBM3


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


def check_size(scene, cam, width: int, height: int, reps: int) -> dict:
    """The kernels against their plain versions and timed at one size."""
    import numpy as np

    from fovpathtracing_optixcodelatest_tpu_torch.config import (
        FoveationSchedule,
        RenderConfig,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops import frame as fo
    from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
    from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import (
        fold_in,
        prng_key,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render import (
        film,
        renderer,
    )

    sched = FoveationSchedule.reference_32_16_8()
    config = RenderConfig(width=width, height=height)
    camp = dataclasses.replace(cam, aspect=width / height).device_params(
        "cuda")
    gx, gy = width // 2, height // 2
    frame_key = fold_in(prng_key(0), 1)
    key = fold_in(frame_key, 0)
    out = {"size": [width, height]}

    rays_k, merged_k = renderer.kernel_frame_rays(camp, gx, gy, key, config,
                                                  sched)
    rays_p, merged_p = renderer.plain_frame_rays(camp, gx, gy, key, config,
                                                 sched)
    out["rays"] = n = merged_k["ray_ids"].numel()
    out["rays_exact"] = all(
        torch.equal(merged_k[k], merged_p[k])
        for k in ("origin", "direction", "active", "ray_ids")) and all(
        torch.equal(a["ring"], b["ring"]) for a, b in zip(rays_k, rays_p))
    launch_px = sum(r["ring"].numel() for r in rays_k)

    pad = film.schedule_padding(sched, width, height)
    g = torch.Generator(device="cuda").manual_seed(3)
    vals = []
    for p, r in zip(sched.passes, rays_p):
        shape = (r["launch"][0] * r["launch"][1], p.spp, 3)
        vals.append({
            "radiance": torch.exp(torch.empty(shape, device="cuda").uniform_(
                -7.0, 7.0, generator=g)),
            "alpha": torch.rand(shape, device="cuda", generator=g)})
    # the frame's own slot values: its wavefront traced on the scene
    traced_rays, traced, offsets = renderer.frame_wavefront(
        scene, camp, gx, gy, frame_key, config, sched)
    frame_vals = renderer.pass_slot_values(traced_rays, traced, offsets,
                                           ("radiance", "alpha"))

    def films_agree(values) -> bool:
        canvas_p = film.new_canvas(width, height, pad, "cuda")
        canvas_k = canvas_p.clone()
        exact = True
        for sub in (0, 1, 7):
            renderer.plain_composite_passes(scene, camp, gx, gy, sub,
                                            canvas_p, rays_p, values, config,
                                            sched)
            frame_p = film.finalize(canvas_p, pad, config)
            frame_k = renderer.kernel_film(scene, camp, gx, gy, sub,
                                           canvas_k, values, config, sched)
            exact &= torch.equal(canvas_k, canvas_p) and torch.equal(
                frame_k, frame_p)
        return bool(exact)

    out["film_exact"] = films_agree(vals)
    out["film_exact_traced"] = films_agree(frame_vals)

    grids = renderer.pass_grids(sched, width, height, gx, gy)
    x0, y0, x1, y1 = fo.film_box(grids, pad, width, height)
    region = np.zeros((y1 - y0, x1 - x0), dtype=bool)
    for gr in grids:
        sx, sy = pad + gr.ox - x0, pad + gr.oy - y0
        region[sy: sy + gr.lh * gr.factor, sx: sx + gr.lw * gr.factor] = True
    box_px = (x1 - x0) * (y1 - y0)
    least = {"raygen": n * 33 + launch_px,
             "film": n * 24 + box_px * 12 + int(region.sum()) * 12
             + width * height * 3}
    out.update(box_pixels=box_px, region_pixels=int(region.sum()),
               least_bytes=least,
               bound_ms={k: v / HBM_BYTES_S * 1e3 for k, v in least.items()})
    # the kernels alone: their structs built once, then launched
    canvas = film.new_canvas(width, height, pad, "cuda")
    rargs = fo.raygen_inputs(camp, grids, width, height, gx, gy, key,
                             True)[0]
    fargs = fo.film_inputs(**renderer.film_arguments(
        scene, camp, gx, gy, 1, canvas, vals, config, sched))[0]
    out["raygen_ms"] = _time(lambda: kernel_build.launch(
        "frame", "fov_raygen", "raygen", rargs), reps)
    out["film_ms"] = _time(lambda: kernel_build.launch(
        "frame", "fov_film", "film", fargs), reps)
    # with their wrappers, as a frame calls them
    out["raygen_call_ms"] = _time(lambda: renderer.kernel_frame_rays(
        camp, gx, gy, key, config, sched), reps)
    out["film_call_ms"] = _time(lambda: renderer.kernel_film(
        scene, camp, gx, gy, 1, canvas, vals, config, sched), reps)
    out["plain_raygen_ms"] = _time(lambda: renderer.plain_frame_rays(
        camp, gx, gy, key, config, sched), 3)

    def plain_film():
        renderer.plain_composite_passes(scene, camp, gx, gy, 1, canvas,
                                        rays_p, vals, config, sched)
        film.finalize(canvas, pad, config)

    out["plain_film_ms"] = _time(plain_film, 3)
    out["exact"] = (out["rays_exact"] and out["film_exact"]
                    and out["film_exact_traced"])
    return out


def main(argv=None) -> int:
    from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
    from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
        gradient_sky_probe,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
        build_scene,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops import frame as fo

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, nargs=2, action="append",
                    metavar=("W", "H"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    meshes, cam = scenes.box_city_fast(n=4, seed=0)
    scene = build_scene(meshes, gradient_sky_probe(width=256, height=128),
                        device="cuda")
    report = {"device": torch.cuda.get_device_name(),
              "resources": fo.resources(),
              "sizes": [check_size(scene, cam, w, h, args.reps)
                        for w, h in args.size or ((960, 540), (1800, 1920))]}
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if all(s["exact"] for s in report["sizes"]) else 1


if __name__ == "__main__":
    sys.exit(main())
