"""Command-line frame loop (counterpart of the JAX package's
``apps/main.py``, with the same flags and defaults): a procedural scene or
an OBJ under a constant or HDR probe, ``--frames`` foveated frames, the
last one written with ``--out``, optional AOVs, denoising, per-frame TSV
telemetry and checkpoints.

    python -m fovpathtracing_optixcodelatest_tpu_torch.apps.main \\
        --scene box_city --width 960 --height 540 --frames 8 --out frame.png

It renders on ``cuda`` unless ``--device cpu`` is given; ``--spectral``
(with ``--dispersion``) renders the hero-wavelength spectral path;
``--demand-textures`` pages an OBJ's textures in through a ``DemandLoader``
of ``--demand-pages`` 64x64 tiles as the frames request them;
``--multichip samples|scene`` splits every frame's samples over every
visible card (on ``--device cpu``, the one CPU), ``scene`` also the
triangle table (``parallel/``); ``--viewer`` serves the browser viewer
(``apps/viewer.py``) instead of the frame loop.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import numpy as np

def parse_args(argv=None):
    p = argparse.ArgumentParser(description="foveated path tracer (PyTorch)")
    p.add_argument("--scene", default="cornell",
                   choices=["cornell", "box_city", "furnace"],
                   help="procedural scene preset")
    p.add_argument("--obj", default=None, help="OBJ file to render instead")
    p.add_argument("--hdr", default=None,
                   help="lat-long HDR/PFM/EXR/PNG environment probe")
    p.add_argument("--ambient", type=float, default=2.5,
                   help="solid ambient probe radiance")
    p.add_argument("--probe-prefilter", action="store_true",
                   help="3x3 Gaussian-prefiltered environment CDF")
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=270)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--schedule", default="32_16_8",
                   help="'uniform:N' or foveated sweep 'F_A_P' spp triple")
    p.add_argument("--gaze-mode", default="static", choices=["static", "orbit"],
                   help="static centre or animated gaze")
    p.add_argument("--camera-mode", default="static",
                   choices=["static", "per_frame", "per_time"],
                   help="camera motion: per-frame orbit or wall-clock dolly")
    p.add_argument("--no-accumulate", action="store_true")
    p.add_argument("--out", default=None, help="output image path (last frame)")
    p.add_argument("--aov-out", default=None,
                   help="NPZ path for accum/normal/albedo AOVs")
    p.add_argument("--denoise", action="store_true",
                   help="apply the a-trous denoiser to the final frame")
    p.add_argument("--tsv", default=None, help="per-frame TSV telemetry path")
    p.add_argument("--checkpoint", default=None, help="checkpoint NPZ path")
    p.add_argument("--resume", default=None, help="resume from checkpoint NPZ")
    p.add_argument("--config-json", default=None,
                   help="JSON file overriding RenderConfig fields")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sampler", default="random",
                   choices=["random", "stratified", "blue_noise"],
                   help="AA sample generator")
    p.add_argument("--spectral", action="store_true",
                   help="hero-wavelength spectral path tracing (dispersive "
                   "refraction, CIE-integrated to sRGB)")
    p.add_argument("--dispersion", type=float, default=4200.0,
                   help="Cauchy B coefficient (nm^2) for --spectral")
    p.add_argument("--viewer", action="store_true",
                   help="serve the interactive browser viewer (cursor = "
                   "gaze, drag = orbit, wheel = zoom) instead of the frame "
                   "loop")
    p.add_argument("--viewer-port", type=int, default=8000)
    p.add_argument("--viewer-host", default="127.0.0.1",
                   help="viewer bind address (loopback by default: the "
                   "stream and control endpoints are unauthenticated; pass "
                   "0.0.0.0 to expose them on purpose)")
    p.add_argument("--viewer-schedules", default="",
                   help="comma-separated schedule specs ('F_A_P' or "
                   "'uniform:N') the viewer's 's' key cycles through after "
                   "the launch schedule")
    p.add_argument("--demand-textures", action="store_true",
                   help="page textures on demand (64-texel tile atlas + "
                   "request feedback)")
    p.add_argument("--demand-pages", type=int, default=1024,
                   help="demand-texture atlas capacity in 64x64 tiles")
    p.add_argument("--multichip", default=None, choices=["samples", "scene"],
                   help="render across every visible card (the one CPU "
                   "with --device cpu): 'samples' splits each pass's "
                   "samples, 'scene' also cuts the triangle table into a "
                   "row block a card; both give the single-device frame")
    p.add_argument("--no-progressive", action="store_true",
                   help="no progressive viewer start: by default the first "
                   "frames come at quarter resolution while the first "
                   "full-resolution frame, which waits on the CUDA "
                   "kernels' build at first use, renders in the background")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    return p.parse_args(argv)


def build_schedule(spec: str):
    from fovpathtracing_optixcodelatest_tpu_torch.config import (
        FoveationSchedule,
    )

    if spec.startswith("uniform"):
        spp = int(spec.split(":")[1]) if ":" in spec else 4
        return FoveationSchedule.uniform(spp)
    f, a, per = (int(x) for x in spec.split("_"))
    return FoveationSchedule.sweep(f, a, per)


def main(argv=None) -> int:
    args = parse_args(argv)

    from fovpathtracing_optixcodelatest_tpu_torch.config import RenderConfig
    from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
    from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera
    from fovpathtracing_optixcodelatest_tpu_torch.models.demand import (
        DemandLoader,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.obj_loader import (
        load_obj,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
        build_cdf,
        constant_probe,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
        build_scene,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        Renderer,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.utils import (
        checkpoint as ckpt,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.utils.image import (
        load_hdr_probe,
        save_image,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.utils.metrics import (
        FrameTimers,
        TsvLogger,
    )

    # ---- scene ----
    textures = []
    if args.obj:
        meshes, textures = load_obj(args.obj)
        lo = min(float(m.vertex.min()) for m in meshes if len(m.vertex))
        hi = max(float(m.vertex.max()) for m in meshes if len(m.vertex))
        span = float(hi - lo) or 1.0
        cam = Camera(eye=(span, span * 0.4, span), lookat=(0.0, 0.0, 0.0),
                     fov_y=45.0, aspect=args.width / args.height)
    elif args.scene == "cornell":
        meshes, cam = scenes.cornell()
    elif args.scene == "box_city":
        meshes, cam = scenes.box_city()
    else:
        meshes, cam = scenes.furnace_sphere()
    cam = dataclasses.replace(cam, aspect=args.width / args.height)

    # ---- lighting ----
    if args.hdr:
        data = load_hdr_probe(args.hdr)
        if data is None:
            print(f"failed to load probe {args.hdr}", file=sys.stderr)
            return 1
        probe = build_cdf(data, prefilter=args.probe_prefilter)
    else:
        probe = constant_probe((args.ambient,) * 3)

    overrides = {}
    if args.config_json:
        with open(args.config_json) as fh:
            overrides = json.load(fh)
    config = RenderConfig(**{
        "width": args.width, "height": args.height,
        "accumulate": not args.no_accumulate, "sampler": args.sampler,
        "spectral": args.spectral, "dispersion": args.dispersion,
        **overrides,
    })
    schedule = build_schedule(args.schedule)

    demand_loader = demand = None
    if args.demand_textures and textures:
        # the textures page in through the loader as frames sample them
        demand_loader = DemandLoader(max_pages=args.demand_pages,
                                     device=args.device)
        for img in textures:
            demand_loader.create_texture(img)
        textures = []  # no resident copies
        demand = demand_loader.launch_prepare()
    scene = build_scene(meshes, probe=probe, texture_images=textures,
                        device=args.device, demand=demand)
    print(f"scene: {scene.num_triangles} tris, bvh rows {scene.bvh.num_rows}",
          file=sys.stderr)
    renderer = Renderer(scene, config=config, schedule=schedule,
                        seed=args.seed, device=args.device,
                        demand_loader=demand_loader, multichip=args.multichip)
    renderer.set_camera(cam)
    if args.resume:
        ckpt.resume_renderer(renderer, args.resume)

    if args.viewer:
        from fovpathtracing_optixcodelatest_tpu_torch.apps import viewer
        from fovpathtracing_optixcodelatest_tpu_torch.models.camera import (
            Trackball,
        )

        tb = Trackball(camera=cam)
        tb.reinitialize_from_camera()
        extra = [(s, build_schedule(s))
                 for s in args.viewer_schedules.split(",") if s]
        viewer.serve(renderer, tb, port=args.viewer_port,
                     host=args.viewer_host,
                     progressive=not args.no_progressive, schedules=extra)
        return 0

    timers = FrameTimers()
    tsv = TsvLogger(args.tsv) if args.tsv else None
    try:
        _frame_loop(args, renderer, cam, timers, tsv, save_image, ckpt)
        if args.aov_out or args.denoise:
            _aov_and_denoise(args, renderer, config, schedule)
    finally:
        if tsv:
            tsv.close()
    return 0


def _frame_loop(args, renderer, cam, timers, tsv, save_image, ckpt) -> None:
    base_eye = np.asarray(cam.eye)
    for i in range(args.frames):
        timers.begin("state_update")
        gaze = None
        if args.gaze_mode == "orbit":
            ang = 2 * math.pi * i / max(args.frames, 1)
            gaze = (
                int(args.width / 2 + 0.25 * args.width * math.cos(ang)),
                int(args.height / 2 + 0.25 * args.height * math.sin(ang)),
            )
        if args.camera_mode == "per_frame":
            ang = 2 * math.pi * i / max(args.frames, 1) * 0.05
            eye = (
                float(base_eye[0] * math.cos(ang) - base_eye[2] * math.sin(ang)),
                float(base_eye[1]),
                float(base_eye[0] * math.sin(ang) + base_eye[2] * math.cos(ang)),
            )
            renderer.set_camera(dataclasses.replace(cam, eye=eye))
        elif args.camera_mode == "per_time":
            import time

            radius = float(np.linalg.norm(base_eye - np.asarray(cam.lookat)))
            eye = (float(base_eye[0]), float(base_eye[1]),
                   float(math.cos(time.perf_counter()) * radius))
            renderer.set_camera(dataclasses.replace(cam, eye=eye))
        timers.end("state_update")

        timers.begin("render")
        frame = renderer.render(gaze=gaze)  # a host array: the frame is done
        if renderer.demand_loader is not None:
            n_req = renderer.process_demand_requests()
            if n_req:
                print(f"demand: +{n_req} tiles "
                      f"({renderer.demand_loader.num_tiles_loaded} loaded, "
                      f"{renderer.demand_loader.num_tiles_evicted} evicted)",
                      file=sys.stderr)
        timers.end("render")

        timers.begin("display")
        if args.out and i == args.frames - 1:
            # row 0 is the bottom of the image (V up): flip for display
            if args.out.lower().endswith((".exr", ".pfm")):
                save_image(args.out, renderer.linear_frame()[::-1])
            else:
                save_image(args.out, frame[::-1])
        timers.end("display")
        timers.frame_done()
        if tsv:
            tsv.log(timers, gaze=gaze or (args.width // 2, args.height // 2),
                    subframe=renderer.subframe)
        print(timers.stats_line(gaze or (0, 0), renderer.subframe),
              file=sys.stderr)
        if args.checkpoint:
            ckpt.checkpoint_renderer(renderer, args.checkpoint, camera=cam)


def _aov_and_denoise(args, renderer, config, schedule) -> None:
    """One more frame through ``render_frame_aov`` on a copy of the canvas
    (the renderer's own state is left as the frame loop left it): the AOVs
    to ``--aov-out``, the denoised frame beside ``--out``."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import tonemap
    from fovpathtracing_optixcodelatest_tpu_torch.ops.denoise import (
        atrous_denoise,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import prng_key
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        render_frame_aov,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.utils.image import (
        save_npz_frame,
        save_png,
    )

    _, _, aovs, _ = render_frame_aov(
        renderer.scene, renderer.camera_params, args.width // 2,
        args.height // 2, renderer.subframe, renderer.canvas.clone(),
        prng_key(args.seed + 999), config, schedule,
    )
    if args.aov_out:
        save_npz_frame(args.aov_out,
                       **{k: v.cpu().numpy() for k, v in aovs.items()})
    if args.denoise and args.out:
        clean = atrous_denoise(aovs["accum"], aovs["normal"], aovs["albedo"])
        u8 = tonemap.postprocess(
            clean, exposure_stops=config.exposure_stops, white=config.white,
            exposure_on=config.exposure_correction,
            tonemap_on=config.tone_mapping,
        )
        save_png(args.out.replace(".png", "_denoised.png"),
                 u8.cpu().numpy()[::-1])


if __name__ == "__main__":
    raise SystemExit(main())
