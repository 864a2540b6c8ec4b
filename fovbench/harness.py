"""One run of one cell: set-up, warm-up, the measured window, the traced
frames (``trace``), then the check against the reference.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``); its per-layer metrics are ``metrics/<name>.py``
and its limits ``limits/<cell>.json``. The port is imported inside
``run_cell``, so that this module loads where the port is absent.

A generator may return an instance table (``fovbench/instances.py``):
the program then builds its unique meshes two-level
(``build_scene_instanced``) and the reference renders the flattened world.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from fovbench import check, instances as instances_mod, peaks, \
    traffic as traffic_mod
from fovbench.trace import FRAME_SPAN, Trace

# top-level modules no run may hold once its window has closed
BANNED_MODULES = ("jax", "jaxlib", "flax", "fovpathtracing_optixcodelatest_tpu")
TRACED_FRAMES = {"mono": 4, "stereo": 2}


@dataclasses.dataclass
class Context:
    """What the per-layer metric readers read."""

    trace: Trace | None
    frame_s: float  # the untraced window's seconds a displayed frame
    spans: dict
    traced_traces: float | None  # ``traces`` summed over the traced frames
    triangles: int  # the table's: an instanced scene's unique meshes'
    eyes: int
    peaks: dict


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def banned_modules(modules) -> list:
    """The names in ``modules`` whose top-level name (before the first dot)
    is one of ``BANNED_MODULES``, compared whole."""
    return sorted(m for m in modules if m.split(".")[0] in BANNED_MODULES)


def load_metric(root: str, name: str):
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"fovbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_of(root: str, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            repo = os.path.dirname(root)
            return load_json(os.path.join(repo, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def generate_with_table(cfg: dict):
    """(meshes, camera, texture images, probe image, instance table) from
    the frozen generators the configuration names. A generator that returns
    a table returns its unique object-space meshes; a flat one returns the
    world's meshes and no table (None)."""
    geo = dict(cfg["geometry"])
    gen = importlib.import_module(f"fovbench.scenes.{geo.pop('generator')}")
    tex = cfg["textures"]
    meshes, camera, images, *table = gen.generate(
        **geo, texture_size=tex["size"] if tex else None)
    pr = dict(cfg["probe"])
    probe = importlib.import_module(
        f"fovbench.scenes.{pr.pop('generator')}").generate(**pr)
    return meshes, camera, images, probe, table[0] if table else None


def generate_scene(cfg: dict):
    """(world meshes, camera, texture images, probe image): the world that
    the reference renders, an instance table flattened."""
    meshes, camera, images, probe, table = generate_with_table(cfg)
    if table is not None:
        meshes = instances_mod.flatten(meshes, table)
    return meshes, camera, images, probe


def traffic_of(root: str, cfg: dict, mix: str, seed: int, camera: dict):
    """The cell's traffic, its saccades sized by the camera's field of
    view where the mix gives none."""
    return traffic_mod.Traffic(traffic_mod.load(root, mix), seed,
                               cfg["width"], cfg["height"], camera["fov_y"])


def pin_thread() -> int:
    """Pin the calling thread, which launches the frames' work, to one CPU
    (the last it may use), so that it does not move between cores. Threads
    started earlier (the CUDA driver's) keep their own set."""
    cpu = max(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cpu})
    return cpu


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


class _Program:
    """The port, driven through its public entry points."""

    def __init__(self, cfg, tr, meshes, camera, images, probe_image, seed,
                 device, instances=None):
        from fovpathtracing_optixcodelatest_tpu_torch.config import (
            FoveationPass, FoveationSchedule, RenderConfig)
        from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera
        from fovpathtracing_optixcodelatest_tpu_torch.models.material import (
            Material)
        from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import HostMesh
        from fovpathtracing_optixcodelatest_tpu_torch.models.probe import build_cdf
        from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
            build_scene, build_scene_instanced)

        host = [HostMesh(vertex=m["vertex"], index=m["index"],
                         normal=m["normal"], texcoord=m["texcoord"],
                         material=Material(**m["material"]),
                         diffuse_texture_id=m["texture_id"]) for m in meshes]
        probe = build_cdf(probe_image)
        if instances is None:
            build = functools.partial(build_scene, host,
                                      leaf_size=cfg["bvh"]["leaf_size"],
                                      arity=cfg["bvh"]["arity"])
        else:
            from fovpathtracing_optixcodelatest_tpu_torch.models.instance import (
                Instance, InstancedScene)

            if (cfg["bvh"]["leaf_size"], cfg["bvh"]["arity"]) != (None, None):
                raise ValueError("an instanced scene is built at the port's "
                                 "default table; name no BVH layout")
            build = functools.partial(build_scene_instanced, InstancedScene(
                unique=host, textures=list(images),
                instances=[Instance(mesh_ids=tuple(i["mesh_ids"]),
                                    transform=np.asarray(i["transform"],
                                                         np.float64))
                           for i in instances]))
        t = time.perf_counter()
        with torch.profiler.record_function("fovbench.build_scene"):
            self.scene = build(probe=probe, texture_images=images or None,
                               device=device)
        self.build_s = time.perf_counter() - t
        r = cfg["render"]
        config = RenderConfig(
            width=cfg["width"], height=cfg["height"],
            max_depth=cfg["max_depth"], tmin=r["tmin"], tmax=r["tmax"],
            exposure_stops=r["exposure_stops"], white=r["white"],
            accumulate=r["accumulate"], sampler=r["sampler"])
        schedule = FoveationSchedule(passes=tuple(
            FoveationPass(**p) for p in cfg["schedule"]["passes"]))
        aspect = cfg["width"] / cfg["height"]
        self.tr = tr
        if tr.display == "stereo":
            from fovpathtracing_optixcodelatest_tpu_torch.parallel.stereo import (
                StereoRenderer, eye_cameras_from_pose)

            fwd = np.asarray(camera["lookat"]) - np.asarray(camera["eye"])
            self.eyes = eye_cameras_from_pose(
                camera["eye"], tuple(fwd), camera["up"],
                ipd=tr.spec["ipd"], fov_y=tr.spec["fov_y"], aspect=aspect)
            self.r = StereoRenderer(self.scene, config, schedule,
                                    device=device)
        else:
            from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
                Renderer)

            self.r = Renderer(self.scene, config, schedule, seed=seed,
                              device=device)
            self.r.set_camera(Camera(eye=camera["eye"], lookat=camera["lookat"],
                                     up=camera["up"], fov_y=camera["fov_y"],
                                     aspect=aspect))

    def render(self, frame: int) -> np.ndarray:
        """Displayed frame ``frame`` -> (eyes, H, W, 3) uint8 host pixels."""
        gaze = self.tr.gaze(frame)
        if self.tr.display == "stereo":
            return self.r.render(*self.eyes, gaze)
        return self.r.render(gaze)[None]

    def traces(self) -> int:
        return int(self.r.stats["traces"])


def cameras_of(cfg, tr, camera):
    """The reference's cameras: (eye, lookat, up) a display eye, and fov."""
    from fovbench.reference.render import eye_cameras

    if tr.display == "stereo":
        fwd = np.asarray(camera["lookat"]) - np.asarray(camera["eye"])
        return eye_cameras(camera["eye"], fwd, camera["up"], tr.spec["ipd"],
                           tr.spec["fov_y"], cfg["width"] / cfg["height"]), \
            tr.spec["fov_y"]
    return [(camera["eye"], camera["lookat"], camera["up"])], camera["fov_y"]


def _traced_frames(prog, first: int, count: int, acts, keep):
    """``count`` displayed frames under the profiler recording ``acts`` (one
    more before them warms it up; each frame goes to ``keep``) -> (Trace,
    their traces, the host clock's seconds over them)."""
    from torch.profiler import profile, schedule

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    traces = 0
    try:
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=count),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for i in range(count + 1):
                if i == 1:
                    start = time.perf_counter()
                with torch.profiler.record_function(FRAME_SPAN):
                    keep.add(first + i, prog.render(first + i))
                if i:
                    traces += prog.traces()
                if i == count:
                    wall = time.perf_counter() - start
                prof.step()
        with open(path) as f:
            tr = Trace(json.load(f), frames=count, window_s=wall)
    finally:
        os.remove(path)
    return tr, traces, wall


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t0: float | None = None):
    """Run cell ``workload`` of the ``BENCHMARK.json`` beside ``root`` (a
    ``fovbench/`` directory of data files) once -> (the result line's
    dict: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
    ``breakdown`` when traced, ``checks`` last; the ``info`` dict)."""
    t0 = time.perf_counter() if t0 is None else t0
    repo = os.path.dirname(root)
    bench = load_json(os.path.join(repo, "BENCHMARK.json"))
    cell = find_cell(bench, workload)
    cfg = config_of(root, bench, cell["config"])
    limits = load_json(os.path.join(root, "limits", f"{workload}.json"))
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    meshes, camera, images, probe_image, table = generate_with_table(cfg)
    tr = traffic_of(root, cfg, cell["traffic"], seed, camera)
    prog = _Program(cfg, tr, meshes, camera, images, probe_image, seed, dev,
                    table)
    for f in range(tr.warmup):
        prog.render(f)
    setup_s = time.perf_counter() - t0

    # the window: displayed frames back to back; of them only the sample
    # that the check reads is kept
    keep = check.Reservoir(seed, limits["sample"]["frames"] - 1)
    cpu = pin_thread() if cuda else None
    stamps = []
    f = tr.warmup
    start = time.perf_counter()
    while True:
        keep.add(f, prog.render(f))
        stamps.append(time.perf_counter())
        f += 1
        if stamps[-1] - start >= seconds:
            break
    window_traces = prog.traces()
    durations = np.diff(np.asarray([start] + stamps))
    n = len(stamps)
    metrics = {
        "frame_ms": (stamps[-1] - start) * 1e3 / n,
        "frame_ms_p95": float(np.percentile(durations * 1e3, 95)),
        "setup_s": setup_s,
    }
    tr_obj, traced_traces, labelled, traced_ms = None, None, None, {}
    if trace:
        # device metrics from a trace of the device's activity alone, which
        # slows the host least; idle gaps labelled from one with host ops
        from torch.profiler import ProfilerActivity

        count = TRACED_FRAMES[tr.display]
        acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        tr_obj, traced_traces, wall = _traced_frames(prog, f, count, acts,
                                                     keep)
        traced_ms["device_only"] = wall * 1e3 / count
        f += count + 1
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        labelled, _, wall = _traced_frames(prog, f, count, acts, keep)
        traced_ms["with_host_ops"] = wall * 1e3 / count
        f += count + 1
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    triangles = sum(len(m["index"]) for m in meshes)
    build_s = prog.build_s
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the check: chosen pixels of chosen displayed frames, after the window
    from fovbench.reference.render import Reference

    t_ref = time.perf_counter()
    world = meshes if table is None else instances_mod.flatten(meshes, table)
    kept = keep.frames()
    checks = check.draw(cfg, tr, seed, kept, limits["sample"])
    prog_px = np.stack([kept[s][e, y, x] for e, s, x, y in checks])
    cams, fov = cameras_of(cfg, tr, camera)
    ref = Reference(cfg, world, images, probe_image, cams, fov, dev)
    ref_px = check.reference_pixels(ref, cfg, tr, seed, checks)
    numbers = check.compare(prog_px, ref_px)
    lim = limits["limits"]
    correct = all(numbers[k] <= lim[k] for k in lim)
    by_frame = {}
    for c, (_, s, _, _) in enumerate(checks):
        by_frame.setdefault(s, []).append(c)
    failed = sum(
        any(v > lim[k] for k, v in check.compare(prog_px[i], ref_px[i]).items())
        for i in by_frame.values())
    ref_s = time.perf_counter() - t_ref

    ctx = Context(trace=tr_obj, frame_s=metrics["frame_ms"] * 1e-3,
                  spans={"build_scene": build_s},
                  traced_traces=traced_traces, triangles=triangles,
                  eyes=tr.eyes, peaks=peaks.H100_SXM)
    out_metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            v = load_metric(root, m["name"]).read(ctx)
            if v is not None:
                out_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if workload in m.get("workloads", [workload]):
                out_metrics[m["name"]] = {"value": float(metrics[m["name"]]),
                                          "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": cell["chips"],
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": bool(correct), "attempted": f - tr.warmup,
              "failed": int(failed), "metrics": out_metrics,
              "device": device_info}
    if tr_obj is not None:
        device_info["busy_s"] = tr_obj.busy_s
        device_info["window_s"] = tr_obj.window_s
        result["breakdown"] = {"device_ops": tr_obj.device_ops(),
                               "idle_gaps": labelled.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim[k]}
                        for k, v in numbers.items()}
    info = {
        "workload": workload, "seed": seed, "window_frames": n,
        "window_s": stamps[-1] - start, "frame_ms": metrics["frame_ms"],
        "frame_ms_quantiles": dict(zip(
            ("min", "p25", "p50", "p75", "max"),
            np.percentile(durations * 1e3, [0, 25, 50, 75, 100]).tolist())),
        "frame_ms_by_fifth": [
            float(np.mean(part)) * 1e3
            for part in np.array_split(durations, min(5, n))],
        "frame_ms_p95": metrics["frame_ms_p95"], "setup_s": setup_s,
        "traced_frame_ms": traced_ms, "window_cpu": cpu,
        "scene_build_s": build_s, "triangles": triangles,
        "world_triangles": sum(len(m["index"]) for m in world),
        "instances": 0 if table is None else len(table),
        "traces_per_frame": window_traces, "eyes": tr.eyes,
        "checked_pixels": len(checks), "checked_frames": len(by_frame),
        "reference_s": ref_s, "memory_peak_bytes": int(peak),
        "card": power_limit() if cuda else "cpu",
    }
    return result, info
