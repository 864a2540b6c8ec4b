#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--profile table.txt]

Builds the port's CUDA kernels from ``fovpathtracing_optixcodelatest_tpu_torch/
csrc/`` (into ``build/torch_kernels/``), builds the bench scene (box_city
n=24, seed 0, gradient sky probe: 6,924 triangles), then:

1. checks the closest-hit (K1) and occlusion (K2, K3) kernels against their
   plain PyTorch versions on the frame's full primary-ray batch (1,923,984
   lanes of the 960x540 reference_32_16_8 schedule): hit, tri_id and
   occlusion must match exactly and t/u/v bit for bit (0 ulp); K3's
   disagreements with K2 there are reported (they walk different trees);
2. computes bounce 0's NEE shadow rays through the port's integrator and
   drives the packet-occlusion path (K3, the masked warp-packet walk that
   replaces the JAX package's Pallas kernel) on them, checking K3 against
   its plain version and against K2 on the same rays and reading the
   packets and rows K3 fetched; checks and times K1 again on bounce 0's
   incoherent continuation rays, the shape of three of its four launches a
   frame;
3. drives the main path, ``Renderer.render`` on ``FRAMES`` 960x540 frames
   after one warm-up frame, counting the
   kernel launches of those frames only, and checks the frame;
   every bounce's shading runs in ``csrc/shade.cu``'s two kernels (one
   ``shade`` and one ``resolve`` launch a K1), which are held to the plain
   bounce on the frame's primary lanes at depth 0 and its survivors at
   depth 1 (masks exact, every float output bit for bit) and timed there;
   each frame generates its rays in one ``raygen`` launch and composites
   and tone-maps its passes in one ``film`` launch (``csrc/frame.cu``),
   which are held to their plain versions at the frame's size and gaze
   (rays, rings, canvas and uint8 frame bit for bit, over subframes 0, 1
   and 7, on slot values of six decades and on the frame's own traced
   values) and timed there beside their byte bounds
   (``tools/frame_check.py`` ``check_size``); each wavefront keeps its
   live lanes on the card (``csrc/lanes.cu``'s compaction, one launch a
   bounce but the last and one of ray generation's mask), held to
   ``torch.nonzero`` / ``idx[alive]`` and the gathers bit for bit on the
   frame's lanes and timed there, and the kernel path to the same kernels
   over host lane lists bit for bit, without a sync
   (``tools/lanes_check.py``);
4. renders a small frame on the GPU and on the CPU (the plain versions) and
   requires 99% of the pixels within 1 LSB;

and then the other paths a user drives, each with the launch counts set to
0 just before it and read just after (K1 and K2 must have run):

a. the textured bench frame (``box_city_textured`` n=24: the same geometry,
   eight 256x256 procedural textures), timed like the main path; the
   texture sampler on the card against its CPU run on bounce 0's hits
   (within 1e-6); its subframe 0 differs from the untextured frame's only
   on pixels where a primary ray hit;
b. the bench scene under a 4096x2048 procedural HDR probe (NEE through the
   per-field alias arrays: no sample rows at that size); finite;
c. the textured cornell box with a shadow catcher (``catcher_cornell``), 2
   subframes through ``render_aov`` on the GPU and on the CPU: 99% of the
   pixels within 1 LSB, each AOV and the denoised image within
   ``AOV_RTOL`` of the CPU's relative to its largest value;
d. the CLI (``apps/main.py``) in this process at 960x540 with every output
   (PNG, AOV NPZ, denoised PNG, TSV); prints the TSV's render times;
e. render-time instancing: the 1,000-instance sphere field
   (``kernel_times.instance_field``: one 320-triangle icosphere, 320,000
   world triangles) on its two-level table, timed like the main path at
   960x540 ``reference_32_16_8``; the instanced K1 and K2 against their
   plain versions on that frame's primary and bounce-0 shadow lanes (hit,
   tri_id, inst, occlusion equal, t/u/v 0 ulp), timed there beside the
   single-level K1 and K2 on the same rays against the flattened table;
   the same subframe from the flattened single-level scene within the JAX
   package's instancing gate (mean radiance within rtol 0.05, 90% of
   pixels within 1e-3); the field's two-level tables at (32, 12) and
   (32, 24) (``tlas.build_instanced(leaf_size=, arity=)``): the instanced
   K1 and K2 compiled there against their plain versions on the same
   lanes (exact), timed, with bounds and resources, and the frames at each
   layout (launches under the layout's names) within 1 LSB of the (16, 6)
   frame on 99% of the pixels; the same for the city field
   (``kernel_times.city_field``: 8 instances of one 1,500-triangle BLAS,
   whose wide BLAS rows are many leaves), at (16, 6), (32, 12) and
   (32, 24), 2 timed frames each;
f. spectral: the untextured bench frame with ``spectral=True``, timed like
   the main path; the dispersive glass sphere (``glass_sphere``,
   ``dispersion`` 25000) on the card against the CPU at a small size (99%
   of the pixels within 1 LSB); the CLI with ``--spectral`` at 960x540.
g. deep scenes: ``box_city_fast`` n=180 (388,812 triangles, 4 timed
   frames) and n=913 (10,002,840 triangles, 2 timed frames) at 960x540
   ``reference_32_16_8``, each in its default (16, 6) table and in one of
   the JAX package's wide packings (``DEEP_SCENES``: the Python-collapsed
   (32, 24) at n=180, the native (32, 12) at n=913, both in pack order,
   ``dfs=False``: a named L12/A32 build at 10M is phase p's DFS and
   treelet table): the host build phase
   by phase, the warm start from the npz BVH cache the cold build wrote
   (bit-identical table), the scene's memory report; for each table the
   timed frames (peak device memory, launches: the wide frames launch only
   the wide instantiations) and as many under the profiler (device busy
   ms, idle share), K1, K2 and the non-culling K2 at the table's stack
   depth against their plain versions on 65,536 lanes of the frame's
   primary and bounce-0 shadow rays (exact), timed there and on all the
   frame's lanes beside the (16, 6) table's kernels on the same rays, with
   bounds for both (the frame's from the subset's work a lane), the rows a
   lane the plain walks fetch, each kernel's design (lanes a ray, how rows
   are read, the stack's home) and resources at that depth; the two tables
   agree (K1's hit and t equal, tri_id apart only at exact ties that brute
   force confirms, the frames on 99% of the pixels within 1 LSB);
h. the brute-force oracle and the golden images on the card: cornell
   64x48 ``uniform(4)`` through K1/K2 against ``traversal="oracle"`` (SSIM
   >= 0.98, mean abs < 5e-3; a stack cut to depth 1 must fall below SSIM
   0.9), the open scene against ``tests/golden/open_scene_48x36_u4.npz``
   (SSIM > 0.98, mean < 4 LSB), the equal-spp fovea against the uniform
   frame (bit-identical), and the 04 raycast (``render/simple.py``), whose
   shadow rays launch K2's non-culling instantiation: the JAX test's
   assertions, every pixel within 1 LSB of the CPU's, and that kernel exact
   against its plain version on the raycast's and on the bench's bounce-0
   shadow rays; the raycast from the scene's (32, 12) and (32, 24) tables
   launches those layouts' non-culling K2 and gives the same frame; the
   README's library example, ``Renderer(meshes=scenes.cornell()[0], ...)``
   at 960x540, builds its scene on the card and renders a frame;
i. demand-loaded textures: ``box_city_textured`` n=24 through a
   ``DemandLoader`` at ``max_pages`` 1024 (every tile fits: requests, loads,
   none open, none left by frame 3) and 64 (the LRU evicts, at most 64
   resident), three frames each; a small frame after paging in, card
   against CPU (every pixel within 1 LSB); the CLI with
   ``--demand-textures`` on a textured OBJ;
j. stereo: ``StereoRenderer`` on the bench scene, 960x540 an eye, the
   eyes from ``eye_cameras_from_pose`` at the bench camera (IPD 0.064 m),
   one warm-up pair and ``STEREO_PAIRS`` timed pairs (ms, Mrays/s, kernel
   launches a pair); each eye of the warm-up pair equals a mono
   ``render_frame`` with the same camera and key, bit for bit;
k. the multi-device paths on the one card: ``render_frame_sharded`` over
   the mesh [cuda:0, cuda:0], ``render_frame_scene_sharded`` with
   ``tri_pack`` padded and cut in two blocks, ``Renderer(multichip=
   "samples")`` on its default mesh; each one's subframe 0 equals the
   single-device frame and canvas bit for bit (the share of pixels equal,
   within 1 LSB and the canvas's largest difference are printed), then 2
   frames timed; each block's bytes against the table's;
l. ``multihost.worker`` in two processes on the one card (gloo at a free
   port, a timeout each), 2 bench frames: the ranks' frames equal, and
   equal ``reference_frame`` bit for bit;
m. the browser viewer: ``serve`` at 960x540 on a free port, progressive,
   driven by a client thread (the page, two stream JPEGs, the stats; a
   gaze move, an orbit and a zoom, which restart the accumulation, the
   denoised view, the next schedule): the swap to full resolution, fps
   and render ms;
n. ``benchmark_sweep.main`` on box_city at 480x270, 2 frames (its files
   and ms/frame a schedule); ``bsdf_test_image`` on the card against the
   CPU (within ``BSDF_RTOL``); ``save_gif`` of phase j's pairs, read back;
o. the legacy oracles on the bench scene's lanes of phases 4-5: the
   threaded BVH (``ops/bvh.py``) built on the host and moved to the card,
   its per-ray walk (``ops/traverse_threaded.py``) against K1 on the
   primary and continuation lanes (hit equal, the triangle on 99.9% of
   the hits, t within rtol 1e-5 on the same triangle; brute force sides
   with K1 where the walk found a farther one) and against K2 on the
   shadow lanes (99.9% equal), the packet walk (``ops/traverse_packet.py``,
   256 rays a packet) against the threaded walk (equal but on at most
   0.1% of the lanes, where brute force sides with the packet walk: it is
   a union walk), each walk timed once with CUDA events, each lane where
   two answers differ reported with brute force's answer and its ray's
   bits; K1 and K2 on the (16, 6) table of the
   pure-Python builder and K3 on its legacy table against their plain
   versions (exact), K1/K2 on the native table (hit and occlusion equal)
   and K2 on every queried lane (K3, exact); ``torch.argmin``'s tie
   order; ``probe_sample_cdf`` on the card against the CPU (texels equal,
   within 1e-6). The host seconds of the threaded, the Python and the
   native wide builds.

p. (after phase g) JAX's default deep scene: ``box_city_fast`` n=400
   (1,920,012 triangles) at 960x540 ``reference_32_16_8``, ``max_depth``
   4, in three tables (``JAX_TABLES``): the port's default (16, 6), JAX's
   plain L12/A32 (``dfs=False``) and JAX's default for a named L12/A32
   layout (``build_scene(meshes, leaf_size=12, arity=32)``: DFS rows,
   small siblings grouped under 35 synthetic rows, treelets of 8,192
   rows); for each, the host build cold and warm (from the npz cache it
   wrote, bit for bit), 4 timed frames and 4 profiled (device busy,
   launches), K1, K2 and the non-culling K2 against their plain versions
   on 65,536 lanes of the frame's primary and shadow rays (exact) and
   timed on all of them; the default table's frame within 1 LSB of the
   plain L12/A32 frame on 99% of the pixels (the bit-identical share
   printed), every table's within 1 LSB of the (16, 6) frame, K1's hits
   and t equal on every table (another triangle only at an exact tie).

q. (after phase p) a two-level table larger than the L2: 4 instances, on
   a 2x2 grid, of phase p's scene merged into one 1,920,012-triangle BLAS
   (``kernel_times.deep_field``: 7,680,048 world triangles) at 960x540
   ``reference_32_16_8``, in the (16, 6) two-level table and at (32, 12)
   (``tlas.build_instanced(leaf_size=12, arity=32)``: about 122 MB of
   rows, 2.4 times the L2): each table's host build seconds, rows, bytes
   and stack depth; the instanced K1 and K2 against their plain versions
   on 65,536 lanes of the frame's primary and bounce-0 shadow rays
   (exact), timed on all of them with bounds and resources; 2 timed
   frames a table, the (32, 12) frame within 1 LSB of the (16, 6) frame
   on 99% of the pixels and launching only that layout's kernels.

r. (after phase o) the 04 raycast of a render-time-instanced scene: phase
   e's 1,000-instance field built by ``build_scene_instanced(...,
   shading_normals=True)`` and rendered by ``render/simple.raycast`` at
   960x540 from its (16, 6) two-level table and from its tables at
   (32, 12) and (32, 24), whose shadow rays launch the two-level K2's
   non-culling instantiation (``occluded_nocull_instanced``): at each
   layout that kernel against its plain version on every queried shadow
   lane (0 lanes differ), timed with CUDA events beside the culling
   two-level K2 on the same lanes, its bound and resources; the frame the
   kernels render byte for byte equal to the frame the plain versions
   render on the card; no single-level kernel launched.

Kernel times are CUDA events over ``kernel_times.REPS`` launches on each
of those shapes (``tools/kernel_times.py``, which times another checkout's
kernels the same way). Prints the card's name and power limit, one
``{"kernels": [...]}`` line (with each kernel's registers, local memory and
resident blocks per SM; the wide layouts' instantiations as
``closest_hit_a32_l12`` and so on, with their phase-g times, the
two-level ones as ``closest_hit_instanced_a32_l12`` and so on, with their
phase-e times and, at (16, 6) and (32, 12), their phase-q times under
``deep_field``; K1, K2 and the non-culling K2 with their phase-p times
under ``jax_tables``; the non-culling two-level K2 at each layout with its
phase-r times), and as its
last line ``{"ok": true, "device":
{...}}``. Any failed check raises and exits non-zero; there is no CPU
fallback.

``--profile`` adds ``FRAMES`` frames of the main path, and as many of the
textured, the instanced, the spectral and the paged-in demand frames and
of the stereo pairs, under ``torch.profiler``, and writes the op tables of
phase g's and phase p's profiled frames, which are profiled in every run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
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
# per instance row entered: the object-space origin (9 multiplies, 9 adds)
# and direction (9 multiplies, 6 adds), and the direction's safe inverse
# (a compare, two selects and a divide per axis)
INST_OPS = 45
RAY_SHAPE = "960x540 reference_32_16_8, box_city n=24 seed 0"
KERNEL_SRC = "fovpathtracing_optixcodelatest_tpu_torch/csrc/"
JAX_OPS = "fovpathtracing_optixcodelatest_tpu/ops/"
JAX_RENDER = "fovpathtracing_optixcodelatest_tpu/render/"
# the kernels the main path launches: closest hit (K1) and occlusion (K2),
# both on the packed table, and their two-level variants on an instanced
# scene's
PATH_KERNELS = ("closest_hit", "occluded")
INSTANCED_KERNELS = ("closest_hit_instanced", "occluded_instanced")
# phase g's deep scenes: (box_city_fast n, timed frames after one warm-up,
# the wide (arity, leaf_size) table built beside the (16, 6) one): 388,812
# triangles with the Python-collapsed L24/A32 table (about 12 s on the
# host), 10,002,840 with the native L12/A32 one (about 16 s)
DEEP_SCENES = ((180, 4, (32, 24)), (913, 2, (32, 12)))
# phase p's scene: box_city_fast n=400, 1,920,012 triangles, the size of
# the JAX package's default deep scene (models/scenes.py box_city_fast)
JAX_SCENE_N = 400
# phase q's field: DEEP_FIELD_COUNT instances of the BLAS of box_city_fast
# n=JAX_SCENE_N, in the (16, 6) two-level table and at these layouts
# ((32, 24) is left out: its Python collapse of 1.92M triangles takes
# minutes)
DEEP_FIELD_COUNT = 4
DEEP_FIELD_LAYOUTS = ((32, 12),)
DEEP_FIELD_FRAMES = 2


def _line(msg: str) -> None:
    print(msg, flush=True)


def catcher_cornell():
    """The port's cornell box with checkerboard textures on the floor and
    the back wall and a shadow-catcher plane under the sphere -> (meshes,
    camera, texture images). Phase (c)'s scene; the CPU tests render it
    through both packages."""
    from fovpathtracing_optixcodelatest_tpu_torch.models import (
        scenes,
        texture,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.material import (
        MATERIAL_FLAG_SHADOW_CATCHER,
        Material,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import make_quad

    meshes, cam = scenes.cornell()
    images = [texture.checkerboard(64, 8),
              texture.checkerboard(96, 6, c0=(0.9, 0.6, 0.4),
                                   c1=(0.3, 0.2, 0.1))]
    meshes[0] = dataclasses.replace(meshes[0], diffuse_texture_id=0)
    meshes[2] = dataclasses.replace(meshes[2], diffuse_texture_id=1)
    y = -1.98
    meshes.append(make_quad(
        (-1.9, y, 1.8), (0.4, y, 1.8), (0.4, y, -1.6), (-1.9, y, -1.6),
        Material(color=(1.0, 1.0, 1.0), emission=(0.0, 0.0, 0.0),
                 metallic=0.0, specular=0.0, roughness=1.0,
                 transmission=0.0, flags=MATERIAL_FLAG_SHADOW_CATCHER)))
    return meshes, cam, images


def glass_sphere():
    """The JAX package's dispersive glass example (a glass icosphere,
    subdivision 3, under a sky with a soft sun) -> (meshes, probe,
    camera). Phase (f)'s dispersive scene."""
    from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera
    from fovpathtracing_optixcodelatest_tpu_torch.models.material import (
        Material,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
        make_icosphere,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
        gradient_sky_probe,
    )

    glass = Material(color=(1, 1, 1), emission=(0, 0, 0), metallic=0.0,
                     roughness=0.05, transmission=1.0, eta=1.5)
    return ([make_icosphere((0, 0, 0), 1.0, 3, glass)],
            gradient_sky_probe(sun_power=30.0, sun_sharpness=40.0),
            Camera(eye=(0, 0.4, 3.4), lookat=(0, 0, 0), fov_y=42.0))


def _share_within_1lsb(a, b) -> float:
    """The share of pixels of two uint8 frames within 1 LSB in every
    channel."""
    return float((abs(a.astype(int) - b.astype(int)).max(-1) <= 1).mean())


def _plain_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _kernel_of(name: str):
    """Which of the port's kernels a device function belongs to, from its
    name as the profiler or ptxas gives it (plain, templated, namespaced or
    mangled): "closest_hit", "occluded", "occluded_packets",
    "closest_hit_instanced", "occluded_instanced", "occluded_nocull",
    "occluded_nocull_instanced" or None."""
    for kernel in ("occluded_packets", "closest_hit_instanced",
                   "occluded_nocull_instanced", "occluded_instanced",
                   "occluded_nocull", "closest_hit", "occluded"):
        # the wide layouts' group walks: "closest_hit_group_kernel", ...
        if f"{kernel}_kernel" in name or f"{kernel}_group_kernel" in name:
            return kernel
    return None


def _ptxas_spills(log: str) -> dict:
    """Spill-store bytes per kernel from an ``nvcc -Xptxas -v`` log; a
    wide layout's instantiation under its ``traverse.layout_name``."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse

    out, current = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for", 1)[1]
            current = _kernel_of(fn)
            lay = re.search(r"_kernelILi(\d+)ELi(\d+)E", fn)
            if current and lay:
                current = traverse.layout_name(current, int(lay[1]),
                                                   int(lay[2]))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and current:
            out[current] = int(m.group(1))
    return out


def _k1_agreement(k: dict, p: dict):
    """K1's answer against its plain version's: (hit equal, tri_id equal,
    largest t/u/v difference in ulp and in absolute value on the hits)."""
    import torch

    hm = p["hit"]
    hit_eq = bool(torch.equal(k["hit"], hm))
    tri_eq = bool(torch.equal(k["tri_id"], p["tri_id"]))
    if not hm.any():
        return hit_eq, tri_eq, 0, 0.0
    ulp = max(int((k[c][hm].view(torch.int32) - p[c][hm].view(torch.int32))
                  .abs().max().item()) for c in ("t", "u", "v"))
    err = max(float((k[c][hm] - p[c][hm]).abs().max().item())
              for c in ("t", "u", "v"))
    return hit_eq, tri_eq, ulp, err


def _bound(stats: dict, table, n_rays: int, n_active: int, out_bytes: int,
           scale: float = 1.0):
    """Least time for the work: the bytes the call must move (each distinct
    table row this run's rays fetch, the mask of every lane and the ray of
    each active lane read once, each lane's result written once; rows no
    ray needs are not counted, so a subset of lanes is not charged the
    whole table) at the HBM rate vs the float32 operations
    this run's rays need (a slab test of each non-empty child of every
    fetched node row, a triangle test of each real triangle of every fetched
    leaf row and, on a two-level table, the object-space ray of each
    instance row entered, as the plain version counted them in ``stats``)
    at the float32 peak. ``scale`` multiplies the operations: a bound for
    more lanes than ``stats`` counted, from a subset's work a lane (its
    distinct rows are kept: the larger call fetches at least those).
    Returns (ms, "bytes"|"operations", row-fetch bytes; an instance row's
    13 words are four 16-byte loads)."""
    byte_ms = (stats["distinct_rows"] * table.shape[1] * 4
               + n_active * RAY_BYTES
               + n_rays * (MASK_BYTES + out_bytes)) / HBM_BYTES_PER_S * 1e3
    inst = stats.get("inst_rows", 0)
    ops = (stats["child_tests"] * SLAB_OPS + stats["tri_tests"] * MT_OPS
           + inst * INST_OPS) * scale
    op_ms = ops / F32_OPS_PER_S * 1e3
    fetch = ((stats["node_rows"] + stats["leaf_rows"]) * table.shape[1] * 4
             + inst * 64)
    if byte_ms >= op_ms:
        return byte_ms, "bytes", fetch
    return op_ms, "operations", fetch


def _profile_frames(renderer, path, results: dict, name: str = "profile",
                    path_kernels=PATH_KERNELS, frames: int = FRAMES) -> None:
    """``frames`` more frames under torch.profiler, the op table written to
    ``path`` (None: not written). Per frame: the device's
    busy time (the sum of its kernels' times), the wall time of the same
    profiled frames (host clock, ending in a synchronize), the idle share
    of one in the other, the kernel launches, the device time and launches
    of each of ``path_kernels`` (and its time a launch, which is a bounce),
    and the ops that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(frames):
            renderer.render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    events = prof.key_averages()
    dev_ms = lambda e: e.self_device_time_total / 1e3 / frames  # noqa: E731
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_ms(e) for e in kernels)
    path_ms = {k: sum(dev_ms(e) for e in kernels if _kernel_of(e.key) == k)
               for k in path_kernels}
    path_n = {k: sum(e.count for e in kernels if _kernel_of(e.key) == k)
              / frames for k in path_kernels}
    # a renamed kernel must fail here, not read as 0 ms
    assert all(v > 0 for v in path_ms.values()), \
        f"a main-path kernel is missing from the profile: {path_ms}"
    ours_ms = sum(path_ms.values())
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.key.startswith("aten::")]
    top = sorted(ops, key=dev_ms, reverse=True)[:8]
    launches = sum(e.count for e in kernels) / frames
    idle = 1 - busy_ms / wall_ms
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(events.table(sort_by="self_device_time_total",
                                 row_limit=80))
    results[name] = {
        "frames": frames, "device_busy_ms": busy_ms, "frame_ms": wall_ms,
        "idle_share": idle, "traversal_kernels_ms": ours_ms,
        "kernel_ms": path_ms, "kernel_launches": path_n,
        "kernel_ms_per_launch": {k: path_ms[k] / path_n[k] for k in path_ms},
        "device_launches": launches,
        "top_ops": [(e.key, dev_ms(e), e.count / frames) for e in top],
    }
    _line(f"{name} ({frames} frames, per frame): device busy {busy_ms:.1f} "
          f"ms of a {wall_ms:.1f} ms profiled frame (idle share {idle:.2f}); "
          f"traversal kernels {ours_ms:.3f} ms ("
          + ", ".join(f"{k} {v:.3f} in {path_n[k]:.0f} launches"
                      for k, v in path_ms.items()) + "); "
          f"{launches:.0f} device launches; top ops: "
          + "; ".join(f"{e.key} {dev_ms(e):.2f} ms x{e.count / frames:.0f}"
                      for e in top))


def timed_frames(renderer, frames: int, warm_up: bool = True) -> dict:
    """``frames`` frames of ``renderer`` (after one warm-up frame), each
    timed on the host clock up to a device synchronize, with the kernel
    launches and the peak device memory of those frames only."""
    import torch

    from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build

    if warm_up:
        renderer.render()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_build.reset_launches()
    frame_ms, traces = [], []
    for _ in range(frames):
        t0 = time.perf_counter()
        frame = renderer.render()
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        traces.append(renderer.stats["traces"])
    launches = kernel_build.LAUNCHES.copy()
    lin = renderer.linear_frame()
    return {
        "frame": frame, "frame_ms": frame_ms, "traces": traces,
        "launches": launches, "peak": torch.cuda.max_memory_allocated(),
        "finite": bool(torch.isfinite(torch.from_numpy(lin)).all()),
        "mean_ms": sum(frame_ms) / len(frame_ms),
        "mrays": sum(traces) / (sum(frame_ms) / 1e3) / 1e6,
    }


def _frames_line(name: str, t: dict) -> str:
    return (f"{name}: ms/frame " + ", ".join(f"{x:.1f}" for x in t["frame_ms"])
            + f" (mean {t['mean_ms']:.1f}); traces/frame {t['traces'][-1]}; "
            f"{t['mrays']:.2f} Mrays/s; peak {t['peak'] / 2**30:.2f} GiB; "
            f"frame mean {t['frame'].mean():.3f}; finite {t['finite']}; "
            f"launches {t['launches']}")


def shade_phase(scene, config, rays: dict) -> dict:
    """(6b) The bounce's shading kernels (``csrc/shade.cu``) against the
    plain bounce on the bench frame's primary lanes at depth 0 and on its
    survivors at depth 1 (masks exact, every float output bit for bit), and
    ``shade`` / ``resolve`` timed at depth 0's lanes with their resources
    (``tools/shade_check.py`` ``check_frame``)."""
    from fovpathtracing_optixcodelatest_tpu_torch.tools import shade_check

    return shade_check.check_frame(scene, config, rays["primary"])


def frame_phase(scene, config, rays: dict) -> dict:
    """(6c) The frame's ray generation and film kernels (``csrc/frame.cu``)
    against their plain versions at the bench frame's size, schedule and
    camera, the gaze at the centre (rays, rings, canvas and uint8 frame
    bit for bit over subframes 0, 1 and 7), each timed alone beside its
    byte bound, with their resources (``tools/frame_check.py``)."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import frame as fo
    from fovpathtracing_optixcodelatest_tpu_torch.tools import (
        frame_check,
        kernel_times,
    )

    out = frame_check.check_size(scene, rays["camera"], config.width,
                                 config.height, kernel_times.REPS)
    out["resources"] = fo.resources()
    return out


def lanes_phase(scene, config, rays: dict) -> dict:
    """(6d) The live-lane compaction (``csrc/lanes.cu``) against
    ``torch.nonzero`` / ``idx[alive]`` and the gathers on the bench frame's
    primary lanes and bounce 0's survivors and at ragged lengths, bit for
    bit, timed on the survivors beside its byte bound; and ``trace_paths``'
    kernel path against the same kernels over host lane lists (radiance,
    alpha, normal, albedo, ``traces`` bit for bit, the lanes a depth), one
    wavefront of it without a sync (``tools/lanes_check.py``)."""
    from fovpathtracing_optixcodelatest_tpu_torch.tools import lanes_check

    return lanes_check.check_frame(scene, config, rays)


def textured_phase(untextured_scene, n: int, schedule, width: int,
                   height: int, frames: int, device="cuda") -> dict:
    """(a) The textured bench frame: ``box_city_textured(n, seed 0)`` under
    the gradient sky, timed like the main path. Holds the texture sampler
    on ``device`` against its CPU run on bounce 0's hit batch (within
    1e-6), and requires the subframe-0 frame to differ from the untextured
    scene's only on pixels where a primary ray hit geometry."""
    import torch

    from fovpathtracing_optixcodelatest_tpu_torch.config import RenderConfig
    from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
    from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
        gradient_sky_probe,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
        scene_arrays,
        scene_from_arrays,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.texture import (
        TextureArray,
        hit_uv,
        sample_bilinear_wrap,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse
    from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import (
        fold_in,
        prng_key,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render import raygen
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        Renderer,
    )

    meshes, cam, images = scenes.box_city_textured(n=n, seed=0)
    scene = scene_from_arrays(
        scene_arrays(meshes, gradient_sky_probe(), images), device)
    tex = scene.textures
    config = RenderConfig(width=width, height=height)
    camera = dataclasses.replace(cam, aspect=width / height)
    renderer = Renderer(scene, config, schedule, device=device)
    renderer.set_camera(camera)
    out = timed_frames(renderer, frames)
    assert out["frame"].shape == (height, width, 3) and out["finite"]
    out.update(triangles=scene.num_triangles,
               texel_bytes=tex.data.numel() * 4,
               textures=tuple(tex.data.shape))

    # the texture sampler on bounce 0's hits of frame 0's primary rays
    camp = camera.device_params(device)
    key = fold_in(fold_in(prng_key(0), 0), 0)
    rays = [raygen.generate_pass_rays(camp, p, width, height, width // 2,
                                      height // 2, key)
            for p in schedule.passes]
    act = torch.cat([r["active"] for r in rays])
    o = torch.cat([r["origin"] for r in rays])[act].contiguous()
    d = torch.cat([r["direction"] for r in rays])[act].contiguous()
    bvh = scene.bvh
    hit = traverse.closest_hit(bvh.table, o, d, torch.ones_like(act[act]),
                               config.tmin, config.tmax, bvh.stack_depth,
                               bvh.arity, bvh.leaf_size)
    attr = scene.tri_pack[hit["tri_id"][hit["hit"]].to(torch.int64)]
    tex_id = attr[:, 10].contiguous().view(torch.int32)
    uv = hit_uv(attr, hit["u"][hit["hit"]], hit["v"][hit["hit"]])
    on_dev = sample_bilinear_wrap(tex, tex_id, uv)
    on_cpu = sample_bilinear_wrap(
        TextureArray(data=tex.data.cpu(), sizes=tex.sizes.cpu()),
        tex_id.cpu(), uv.cpu())
    out["sampler_err"] = float((on_dev.cpu() - on_cpu).abs().max())
    out["sampler_hits"] = int(tex_id.numel())
    assert int((tex_id >= 0).sum()) == tex_id.numel() > 0
    assert out["sampler_err"] <= 1e-6, \
        f"texture sampler on {device} vs CPU: {out['sampler_err']}"

    # subframe 0 of both scenes: the frames may differ only where a primary
    # ray of the pixel's pass hit (its normal AOV is not 0)
    shots = {}
    for name, sc in (("textured", scene), ("untextured", untextured_scene)):
        r = Renderer(sc, config, schedule, device=device)
        r.set_camera(camera)
        frame, aovs = r.render_aov()
        shots[name] = (frame, aovs["normal"].cpu().numpy())
    (ft, nt), (fu, nu) = shots["textured"], shots["untextured"]
    assert (nt == nu).all(), "the two scenes' geometry differs"
    geometry = (nu != 0).any(axis=-1)
    differs = (ft != fu).any(axis=-1)
    out["geometry_pixels"] = int(geometry.sum())
    out["differing_pixels"] = int(differs.sum())
    out["differing_off_geometry"] = int((differs & ~geometry).sum())
    assert out["differing_off_geometry"] == 0, \
        "textures changed pixels where no primary ray hit"
    assert out["differing_pixels"] > 0.3 * out["geometry_pixels"] > 0
    out["renderer"] = renderer
    return out


def large_probe_phase(renderer, width: int, height: int, frames: int) -> dict:
    """(b) The renderer's scene under a ``width`` x ``height`` procedural HDR
    probe, too large for the 13-column sample rows, so NEE samples it
    through the per-field alias arrays. Times ``frames`` frames (no warm-up:
    the probe is new); the frame must be finite."""
    from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
        gradient_sky_probe,
    )

    t0 = time.perf_counter()
    probe = gradient_sky_probe(width, height)
    build_s = time.perf_counter() - t0
    assert probe.sample_rows is None, "the probe kept its sample rows"
    renderer.set_probe(probe)
    assert renderer.scene.probe.sample_rows is None
    out = timed_frames(renderer, frames, warm_up=False)
    assert out["finite"]
    out.update(host_build_s=build_s,
               texel_bytes=renderer.scene.probe.data.numel() * 4)
    return out


# the card's AOVs and denoised image against the CPU's, relative to the
# CPU image's largest value (measured on an H100: at most 4.4e-6, the
# albedo AOV; the per-pixel sums over samples reduce in another order)
AOV_RTOL = 2e-5


def catcher_phase(width: int, height: int, schedule, device="cuda") -> dict:
    """(c) The textured cornell box with a shadow catcher (``catcher_cornell``):
    2 subframes through ``Renderer.render_aov`` on ``device`` and on the CPU.
    At least 99% of the pixels within 1 LSB; each AOV and the
    ``atrous_denoise`` of the second subframe within ``AOV_RTOL``."""
    import torch

    from fovpathtracing_optixcodelatest_tpu_torch.config import RenderConfig
    from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
        gradient_sky_probe,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
        scene_arrays,
        scene_from_arrays,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops.denoise import (
        atrous_denoise,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        Renderer,
    )

    meshes, cam, images = catcher_cornell()
    arrays = scene_arrays(meshes, gradient_sky_probe(64, 32), images)
    got = {}
    for dev in (device, "cpu"):
        scene = scene_from_arrays(arrays, device=dev)
        assert scene.has_catcher and scene.has_textures
        r = Renderer(scene, RenderConfig(width=width, height=height),
                     schedule, device=dev)
        r.set_camera(dataclasses.replace(cam, aspect=width / height))
        frames = []
        for _ in range(2):
            frame, aovs = r.render_aov()
            frames.append(frame)
        aovs["denoised"] = atrous_denoise(aovs["accum"], aovs["normal"],
                                          aovs["albedo"])
        got[dev] = (frames, {k: v.cpu() for k, v in aovs.items()},
                    r.stats["traces"])
    (fd, ad, td), (fc, ac, tc) = got[device], got["cpu"]
    share = min(_share_within_1lsb(a, b) for a, b in zip(fd, fc))
    err = {k: float((ad[k] - ac[k]).abs().max() / ac[k].abs().max())
           for k in ac}
    assert share >= 0.99, f"catcher frame on {device} vs CPU: {share}"
    for k, e in err.items():
        assert e <= AOV_RTOL and torch.isfinite(ad[k]).all(), \
            f"{k} on {device} vs CPU: {e} relative"
    return {"share": share, "rel_err": err, "traces": (td, tc)}


def cli_phase(width: int, height: int, schedule: str, device="cuda",
              spectral: bool = False) -> dict:
    """(d) The command-line entry point in this process, with every output
    it has: PNG, AOV NPZ, the denoised PNG and the TSV, in a temporary
    directory; (f) with ``--spectral``, the PNG and the TSV. Returns the
    TSV's per-frame render times."""
    import tempfile

    from fovpathtracing_optixcodelatest_tpu_torch.apps import main as cli

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "frame.png")
        tsv = os.path.join(tmp, "run.tsv")
        argv = ["--device", device, "--scene", "box_city", "--width",
                str(width), "--height", str(height), "--frames", "2",
                "--schedule", schedule, "--out", out, "--tsv", tsv]
        files = [out, tsv]
        if spectral:
            argv += ["--spectral"]
        else:
            files += [os.path.join(tmp, "aov.npz"),
                      os.path.join(tmp, "frame_denoised.png")]
            argv += ["--sampler", "blue_noise", "--aov-out", files[2],
                     "--denoise"]
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall_s = time.perf_counter() - t0
        assert rc == 0, f"the CLI returned {rc}"
        sizes = {os.path.basename(f): os.path.getsize(f) for f in files}
        assert all(v > 0 for v in sizes.values()), sizes
        with open(tsv) as fh:
            rows = [ln.rstrip("\n").split("\t") for ln in fh]
    render_ms = [float(r[rows[0].index("render_ms")]) for r in rows[1:]]
    assert len(render_ms) == 2
    return {"argv": " ".join(argv).replace(tmp, "<tmp>"),
            "render_ms": render_ms, "files": sizes, "wall_s": wall_s}


# the instanced frame against the flattened one (the JAX package's
# instancing gate): mean radiance per channel within rtol 0.05 / atol 0.01,
# and this share of pixels within rtol / atol 1e-3 in every channel
FLAT_MEAN_RTOL, FLAT_PIXEL_TOL, FLAT_SHARE = 0.05, 1e-3, 0.90


def _field_layouts(rays: dict, frames: int, ref_frame, device,
                   profile: bool = False) -> dict:
    """(e) The field ``rays`` on its two-level tables at the wide layouts
    (``rays["wide"]``): for each, the instanced K1 and K2 against their
    plain versions on the frame's primary and bounce-0 shadow lanes
    (exact), their times (CUDA events), bounds and resources at the
    table's depth, and ``frames`` timed frames (launches under the
    layout's names) whose last frame lies within 1 LSB of ``ref_frame``
    (the (16, 6) table's) on 99% of the pixels; with ``profile`` as many
    frames under the profiler (``profile``: the instanced kernels' device
    time a launch). Keyed by ``traverse.layout_name("field", arity,
    leaf_size)``."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        Renderer,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.tools import kernel_times

    config = rays["config"]
    o, d, act, _ = rays["primary"]
    so, sd, sq = rays["shadow"]
    n, n_act, ns, nq = o.shape[0], int(act.sum()), so.shape[0], int(sq.sum())
    calls = kernel_times.field_calls(rays)
    out = {}
    for lay, b in rays["wide"].items():
        kargs = (config.tmin, config.tmax, *b.walk_args)
        kw = b.instance_kwargs
        st1, st2 = {}, {}
        p1, p1_ms = _plain_ms(lambda: traverse.closest_hit_plain(
            b.table, o, d, act, *kargs, stats=st1, **kw))
        p2, p2_ms = _plain_ms(lambda: traverse.occluded_plain(
            b.table, so, sd, sq, *kargs, stats=st2, **kw))
        mism = kernel_times.field_mismatches(rays, calls, plain=(p1, p2),
                                             layout=lay)
        mism2 = mism.pop("occluded")
        assert not any(mism.values()), \
            f"instanced K1 at {lay} disagrees with its plain version: {mism}"
        assert mism2 == 0, f"instanced K2 at {lay} disagrees with its plain version"
        assert int(p1["hit"].sum()) > 0 and int(p2.sum()) > 0
        names = {k: traverse.layout_name(k, *lay) for k in
                 ("ik1_primary", "ik2_shadow", *traverse.INSTANCED_KERNELS)}
        times = dict.fromkeys(names.values())
        if device == "cuda":  # else a rehearsal: no device time
            times = kernel_times.time_kernels(
                {names[k]: calls[names[k]] for k in ("ik1_primary",
                                                     "ik2_shadow")})
        b1, b1_by, f1 = _bound(st1, b.table, n, n_act, 20)
        b2, b2_by, f2 = _bound(st2, b.table, ns, nq, 1)
        rec = {"layout": lay, "rows": b.num_rows, "stack_depth": b.stack_depth,
               "inst_base": b.inst_base, "blas_base": b.blas_base,
               "table_bytes": b.table.numel() * 4,
               "host_build_s": rays["wide_build_s"][lay]}
        rec["k1"] = {"lanes": n, "active": n_act,
                     "hits": int(p1["hit"].sum()), "mismatches": mism,
                     "max_abs_err": float(min(sum(mism.values()), 1)),
                     "ms": times[names["ik1_primary"]], "plain_ms": p1_ms,
                     "bound_ms": b1, "bound_by": b1_by, "fetch_bytes": f1,
                     "work": st1}
        rec["k2"] = {"lanes": ns, "queried": nq, "occluded": int(p2.sum()),
                     "mismatches": mism2, "max_abs_err": float(min(mism2, 1)),
                     "ms": times[names["ik2_shadow"]], "plain_ms": p2_ms,
                     "bound_ms": b2, "bound_by": b2_by, "fetch_bytes": f2,
                     "work": st2}
        del p1, p2
        rec["resources"] = None
        if device == "cuda":
            res = traverse.resources(b.stack_depth)
            rec["resources"] = {k: res[names[k]]
                                for k in traverse.INSTANCED_KERNELS}
        renderer = Renderer(dataclasses.replace(rays["scene"], bvh=b),
                            config, rays["schedule"], device=device)
        renderer.set_camera(rays["camera"])
        rec.update(timed_frames(renderer, frames))
        rec["profile"] = None
        if profile:
            prof = {}
            _profile_frames(renderer, None, prof, name=f"field {lay}",
                            path_kernels=INSTANCED_KERNELS, frames=frames)
            rec["profile"] = prof.popitem()[1]
        del renderer
        frame = rec.pop("frame")
        rec["frame_mean"] = float(frame.mean())
        rec["frame_share"] = _share_within_1lsb(frame, ref_frame)
        assert rec["frame_share"] >= 0.99, \
            f"the field's {lay} frame differs from the (16, 6) frame's"
        for k in traverse.INSTANCED_KERNELS:
            assert rec["launches"][names[k]] == rec["launches"][k] > 0 \
                or device != "cuda", \
                f"the {lay} field frame did not launch only {names[k]}"
        out[traverse.layout_name("field", *lay)] = rec
    return out


def city_field_phase(schedule, width: int, height: int, frames: int,
                     device="cuda") -> dict:
    """(e) The city field (``kernel_times.city_field``: 8 instances of one
    1,500-triangle BLAS) on its (16, 6) two-level table, ``frames`` timed
    frames, its instanced K1 and K2 against their plain versions on the
    frame's lanes (exact), and the same at the wide layouts
    (``_field_layouts``)."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        Renderer,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.tools import kernel_times

    rays = kernel_times.field_rays(device, width=width, height=height,
                                   schedule=schedule,
                                   layouts=traverse.WIDE_LAYOUTS,
                                   field=kernel_times.city_field())
    b = rays["scene"].bvh
    calls = kernel_times.field_calls(rays)
    mism = kernel_times.field_mismatches(rays, calls)
    assert not any(mism.values()), \
        f"instanced K1/K2 at (16, 6) disagree on the city field: {mism}"
    # the (16, 6) kernels on the same lanes, beside the wide ones' times
    times = dict.fromkeys(("ik1_primary", "ik2_shadow"))
    if device == "cuda":
        times = kernel_times.time_kernels({k: calls[k] for k in times})
    renderer = Renderer(rays["scene"], rays["config"], schedule,
                        device=device)
    renderer.set_camera(rays["camera"])
    out = timed_frames(renderer, frames)
    del renderer
    assert out["finite"] and 0 < out["frame"].mean() < 255
    out.update(instances=b.num_instances, rows=b.num_rows,
               stack_depth=b.stack_depth,
               world_triangles=rays["field"].num_world_triangles,
               unique_triangles=rays["scene"].num_triangles,
               mismatches=mism, k1_ms=times["ik1_primary"],
               k2_ms=times["ik2_shadow"])
    out["wide"] = _field_layouts(rays, frames, out["frame"], device)
    return out


def instanced_phase(schedule, width: int, height: int, frames: int,
                    device="cuda", count: int = 1000, profile=None,
                    results=None) -> dict:
    """(e) The instance field (``kernel_times.instance_field``) on its
    two-level table: ``frames`` timed frames through ``Renderer.render``
    (with ``profile``, ``FRAMES`` more under the profiler); the instanced
    K1 and K2 against their plain versions on the frame's primary lanes
    and bounce-0 shadow lanes (exact), timed with CUDA events on
    ``device``, and the single-level K1 and K2 timed on the same rays
    against the flattened single-level table; subframe 0 against the same
    subframe of the flattened scene (the gate above); the flattened
    scene's frames timed the same way; the field's tables at the wide
    layouts (``_field_layouts``, under ``wide``)."""
    import numpy as np

    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        Renderer,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.tools import kernel_times

    rays = kernel_times.field_rays(device, count, width, height, schedule,
                                   layouts=traverse.WIDE_LAYOUTS)
    scene, flat, sc = rays["scene"], rays["flat"], rays["field"]
    config, camera = rays["config"], rays["camera"]
    b = scene.bvh
    assert b.num_instances == count and scene.num_triangles == 320
    assert flat.num_triangles == 320 * count and not flat.bvh.instanced
    renderer = Renderer(scene, config, schedule, device=device)
    renderer.set_camera(camera)
    out = timed_frames(renderer, frames)
    assert out["frame"].shape == (height, width, 3) and out["finite"]
    if profile:
        root, ext = os.path.splitext(profile)
        _profile_frames(renderer, f"{root}_instanced{ext}", results,
                        name="profile_instanced",
                        path_kernels=INSTANCED_KERNELS)
    del renderer
    nbytes = lambda sc_: sc_.bvh.table.numel() * 4  # noqa: E731
    out.update(instances=count, world_triangles=sc.num_world_triangles,
               host_build_s=rays["build_s"],
               flat_host_build_s=rays["flat_build_s"],
               table_bytes=nbytes(scene), flat_table_bytes=nbytes(flat),
               tri_pack_bytes=scene.tri_pack.numel() * 4,
               flat_tri_pack_bytes=flat.tri_pack.numel() * 4,
               stack_depth=b.stack_depth, rows=b.num_rows,
               flat_stack_depth=flat.bvh.stack_depth,
               inst_base=b.inst_base, blas_base=b.blas_base)

    # the instanced kernels against their plain versions on the frame's
    # rays; the single-level kernels on the same rays, flattened
    o, d, act, _ = rays["primary"]
    so, sd, sq = rays["shadow"]
    kargs = (config.tmin, config.tmax, *b.walk_args)
    kw = b.instance_kwargs
    calls = {k: v for k, v in kernel_times.field_calls(rays).items()
             if not k.endswith(("_l12", "_l24"))}
    st1, st2 = {}, {}
    p1, p1_ms = _plain_ms(lambda: traverse.closest_hit_plain(
        b.table, o, d, act, *kargs, stats=st1, **kw))
    p2, p2_ms = _plain_ms(lambda: traverse.occluded_plain(
        b.table, so, sd, sq, *kargs, stats=st2, **kw))
    mism = kernel_times.field_mismatches(rays, calls, plain=(p1, p2))
    mism2 = mism.pop("occluded")
    assert not any(mism.values()), \
        f"instanced K1 disagrees with its plain version: {mism}"
    assert mism2 == 0, "instanced K2 disagrees with its plain version"
    assert int(p1["hit"].sum()) > 0 and int(p2.sum()) > 0
    n, n_act, ns, nq = o.shape[0], int(act.sum()), so.shape[0], int(sq.sum())
    if device == "cuda":
        times = kernel_times.time_kernels(calls)
    else:  # a rehearsal: no device time
        times = dict.fromkeys(calls)
    b1, b1_by, f1 = _bound(st1, b.table, n, n_act, 20)
    b2, b2_by, f2 = _bound(st2, b.table, ns, nq, 1)
    out["k1"] = {"lanes": n, "active": n_act, "hits": int(p1["hit"].sum()),
                 "mismatches": mism,
                 "max_abs_err": float(min(mism["t"] + mism["u"] + mism["v"],
                                          1)),
                 "ms": times["ik1_primary"],
                 "flat_ms": times["flat_k1_primary"], "plain_ms": p1_ms,
                 "bound_ms": b1, "bound_by": b1_by, "fetch_bytes": f1,
                 "work": st1}
    out["k2"] = {"lanes": ns, "queried": nq, "occluded": int(p2.sum()),
                 "mismatches": mism2, "max_abs_err": float(min(mism2, 1)),
                 "ms": times["ik2_shadow"],
                 "flat_ms": times["flat_k2_shadow"], "plain_ms": p2_ms,
                 "bound_ms": b2, "bound_by": b2_by, "fetch_bytes": f2,
                 "work": st2}
    del p1, p2, calls
    out["wide"] = _field_layouts(rays, frames, out["frame"], device,
                                 profile=bool(profile))
    del rays

    # subframe 0 against the flattened scene's
    lin = {}
    for name, sc_ in (("instanced", scene), ("flattened", flat)):
        r = Renderer(sc_, config, schedule, device=device)
        r.set_camera(camera)
        r.render()
        lin[name] = r.linear_frame().reshape(-1, 3)
    li, lf = lin["instanced"], lin["flattened"]
    mean_i, mean_f = li.mean(0), lf.mean(0)
    close = np.isclose(li, lf, rtol=FLAT_PIXEL_TOL,
                       atol=FLAT_PIXEL_TOL).all(1).mean()
    out.update(mean_radiance=mean_i.tolist(),
               flat_mean_radiance=mean_f.tolist(), close_share=float(close))
    assert np.allclose(mean_i, mean_f, rtol=FLAT_MEAN_RTOL, atol=0.01), \
        f"instanced mean {mean_i} vs flattened {mean_f}"
    assert close >= FLAT_SHARE, f"instanced vs flattened pixels: {close}"
    flat_renderer = Renderer(flat, config, schedule, device=device)
    flat_renderer.set_camera(camera)
    out["flattened"] = {k: v for k, v in timed_frames(
        flat_renderer, frames).items() if k != "frame"}
    return out


def spectral_phase(scene, config, schedule, camera, frames: int,
                   small: int, device="cuda") -> dict:
    """(f) The hero-wavelength path: ``scene``'s frame with
    ``spectral=True``, timed like the main path; the dispersive glass
    sphere (``dispersion`` 25000) at ``small`` x ``small``, 2 subframes of
    ``uniform(4)`` on ``device`` and on the CPU (99% of the pixels within
    1 LSB)."""
    from fovpathtracing_optixcodelatest_tpu_torch.config import (
        FoveationSchedule,
        RenderConfig,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
        scene_arrays,
        scene_from_arrays,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        Renderer,
    )

    renderer = Renderer(scene, dataclasses.replace(config, spectral=True),
                        schedule, device=device)
    renderer.set_camera(camera)
    out = timed_frames(renderer, frames)
    assert out["frame"].shape == (config.height, config.width, 3)
    assert out["finite"] and 0 < out["frame"].mean() < 255

    meshes, probe, cam = glass_sphere()
    arrays = scene_arrays(meshes, probe)
    glass_cfg = RenderConfig(width=small, height=small, spectral=True,
                             dispersion=25000.0)
    frames_of = {}
    for dev in (device, "cpu"):
        r = Renderer(scene_from_arrays(arrays, device=dev), glass_cfg,
                     FoveationSchedule.uniform(4), device=dev)
        r.set_camera(dataclasses.replace(cam, aspect=1.0))
        frames_of[dev] = [r.render() for _ in range(2)]
    share = min(_share_within_1lsb(a, b)
                for a, b in zip(frames_of[device], frames_of["cpu"]))
    out["glass_share"] = share
    assert share >= 0.99, f"dispersive glass on {device} vs CPU: {share}"
    out["renderer"] = renderer
    return out


def deep_phase(city_n: int, frames: int, schedule, width: int, height: int,
               device="cuda", subset: int = 65536, profile=None,
               wide=(32, 12)) -> dict:
    """(g) A deep scene, ``box_city_fast(city_n)`` under the gradient sky,
    in two tables of the same triangles: the default (16, 6) one and the
    ``wide`` (arity, leaf_size) one. The host build phase by phase (scene,
    triangles, collapse, pack, the npz cache's write) and the (16, 6)
    table's warm start from that cache (key, load and upload of the table;
    bit-identical to the cold build), then for each table: ``frames``
    timed frames after one warm-up and as many under the profiler (device
    busy ms and idle share; with ``profile``, the op table is written
    there), and K1, K2 and the non-culling K2 on ``subset`` lanes of the
    frame's primary and bounce-0 shadow rays against their plain versions
    (exact), timed there and on all of the frame's lanes, with the rows a
    lane the plain walks fetch and the kernels' resources at the table's
    stack depth. The two tables must agree: K1's hit and t equal on the
    subset, tri_id apart only at exact ties (both triangles hit at the
    brute-force t), the last timed frames on 99% of the pixels within
    1 LSB. The (16, 6) table's results are the top-level keys, the wide
    one's ``wide``."""
    import tempfile

    import numpy as np
    import torch

    from fovpathtracing_optixcodelatest_tpu_torch.config import RenderConfig
    from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
    from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
        host_triangles,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
        gradient_sky_probe,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
        DeviceBVH,
        scene_arrays,
        scene_from_arrays,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops import (
        bvh_native,
        traverse,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        Renderer,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.tools import kernel_times

    out = {"city_n": city_n}
    t0 = time.perf_counter()
    meshes, cam = scenes.box_city_fast(n=city_n, seed=0)
    out["scene_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tris = host_triangles(meshes)
    out["triangles_s"] = time.perf_counter() - t0
    saved = os.environ.get("FOVTPU_BVH_CACHE")
    wide_build = {}
    with tempfile.TemporaryDirectory() as cache:
        os.environ["FOVTPU_BVH_CACHE"] = cache
        try:
            cold, warm = {}, {}
            t0 = time.perf_counter()
            bvh = bvh_native.build(tris, timings=cold)
            out["cold_build_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            again = bvh_native.build(tris, timings=warm)
            table = torch.tensor(again.table, device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            out["warm_start_s"] = time.perf_counter() - t0
            out["cache_files"] = len(os.listdir(cache))
            # the wide table, cold (and written to the cache, as a user's
            # build would be)
            t0 = time.perf_counter()
            # dfs=False: the plain wide table (a named L12/A32 layout at
            # 10M would be JAX's DFS and treelet table: phase p's)
            wbvh = bvh_native.build(tris, leaf_size=wide[1], arity=wide[0],
                                    dfs=False, timings=wide_build)
            wide_build_s = time.perf_counter() - t0
        finally:
            if saved is None:
                del os.environ["FOVTPU_BVH_CACHE"]
            else:
                os.environ["FOVTPU_BVH_CACHE"] = saved
    out.update(cold=cold, warm=warm)
    bits = lambda a: a.view(np.uint32)  # noqa: E731 (ids are NaN floats)
    assert np.array_equal(bits(again.table), bits(bvh.table)) and \
        np.array_equal(again.leaf_perm, bvh.leaf_perm) and \
        again.stack_depth == bvh.stack_depth, \
        "the cached table differs from the cold build"
    del again, table
    t0 = time.perf_counter()
    arrays = scene_arrays(meshes, gradient_sky_probe(), bvh=bvh)
    out["arrays_s"] = time.perf_counter() - t0
    del meshes, tris
    t0 = time.perf_counter()
    scene = scene_from_arrays(arrays, device)
    if device == "cuda":
        torch.cuda.synchronize()
    out["upload_s"] = time.perf_counter() - t0
    del arrays
    wscene = dataclasses.replace(scene, bvh=DeviceBVH.upload(wbvh, device))
    del bvh, wbvh
    b = scene.bvh
    out.update(triangles=scene.num_triangles, rows=b.num_rows,
               table_bytes=b.table.numel() * 4, stack_depth=b.stack_depth,
               memory=scene.memory_bytes())
    config = RenderConfig(width=width, height=height, max_depth=4)
    camera = dataclasses.replace(cam, aspect=width / height)
    w = {"layout": wide, "build_s": wide_build_s, "build": wide_build,
         "rows": wscene.bvh.num_rows,
         "table_bytes": wscene.bvh.table.numel() * 4,
         "stack_depth": wscene.bvh.stack_depth}
    root, ext = os.path.splitext(profile) if profile else (None, None)
    for rec, sc in ((out, scene), (w, wscene)):
        lay = (sc.bvh.arity, sc.bvh.leaf_size)
        name = traverse.layout_name(f"deep{city_n}", *lay)
        renderer = Renderer(sc, config, schedule, device=device)
        renderer.set_camera(camera)
        rec.update(timed_frames(renderer, frames))
        rec["mean_radiance"] = float(renderer.linear_frame().mean())
        assert rec["frame"].shape == (height, width, 3) and rec["finite"]
        assert rec["mean_radiance"] > 0, "the deep frame is black"
        prof = {}
        _profile_frames(renderer, profile and f"{root}_{name}{ext}", prof,
                        name=f"deep n={city_n} {lay}",
                        frames=frames)
        rec["profile"] = prof.popitem()[1]
        del renderer
    out["memory_report"] = scene.memory_report(
        n_rays=kernel_times.PRIMARY_LANES)
    w["frame_share"] = _share_within_1lsb(out["frame"], w["frame"])
    assert w["frame_share"] >= 0.99, \
        f"the {wide} table's frame differs from the (16, 6) one's"

    # K1, K2 and the non-culling K2 on both tables with the same rays:
    # exact on a lane subset, timed there and on the whole frame's lanes
    rays = kernel_times.frame_rays(scene, camera, config, schedule, device)
    o, d, act, _ = rays["primary"]
    so, sd, sq = rays["shadow"]
    sel1 = kernel_times.subset_lanes(act, subset)
    sel2 = kernel_times.subset_lanes(sq, subset)
    ones = lambda x: torch.ones((x.numel(),), dtype=torch.bool,  # noqa
                                device=device)
    sub = ((o[sel1].contiguous(), d[sel1].contiguous(), ones(sel1)),
           (so[sel2].contiguous(), sd[sel2].contiguous(), ones(sel2)))
    bvhs = (scene.bvh, wscene.bvh)
    calls = kernel_times.table_calls(bvhs, config, *sub)
    frame_calls = kernel_times.table_calls(bvhs, config, (o, d, act),
                                           (so, sd, sq))
    times = frame_times = None
    if device == "cuda":
        times = kernel_times.time_kernels(calls)
        frame_times = kernel_times.time_kernels(frame_calls)
    got = [_walk_records(rec, b, calls, sub, config, times, frame_times,
                         o.shape[0], so.shape[0], int(act.sum()),
                         int(sq.sum()), device)
           for rec, b in ((out, scene.bvh), (w, wscene.bvh))]
    # the two tables of one scene: the same hits at the same t; another
    # triangle only at an exact tie
    a, c = got[0][0], got[1][0]
    w["hit_equal"] = bool(torch.equal(a["hit"], c["hit"]))
    w["t_equal"] = bool(torch.equal(a["t"], c["t"]))
    lanes = torch.nonzero(a["tri_id"] != c["tri_id"]).squeeze(1)
    w["ties"] = _ties(scene, *sub[0][:2], lanes, a, c, config.tmin,
                      config.tmax)
    w["occluded_mismatches"] = int((got[0][1] != got[1][1]).sum())
    w["nocull_mismatches"] = int((got[0][2] != got[1][2]).sum())
    assert w["hit_equal"] and w["t_equal"], \
        f"the {wide} table's K1 hits differ from the (16, 6) table's"
    assert w["ties"]["ties"] == w["ties"]["lanes"] == lanes.numel(), \
        f"the two tables' triangles differ beyond ties: {w['ties']}"
    out["wide"] = w
    return out


def _walk_records(rec: dict, b, calls: dict, sub, config, times,
                  frame_times, n_frame: int, n_shadow: int, n_active: int,
                  n_queried: int, device) -> tuple:
    """K1, K2 and the non-culling K2 of the table ``b`` on phase g's lane
    subset ``sub`` against their plain versions (exact): their records
    (``k1``, ``k2``, ``k2_nocull``: times on the subset and on the frame's
    lanes, plain time, bound, rows a lane) and the table's resources go
    into ``rec``; returns the kernels' answers (K1, K2, non-culling K2).
    The frame's lanes (``n_active`` of the ``n_frame`` primary lanes
    active, ``n_queried`` of the ``n_shadow`` shadow lanes queried) get a
    bound too, ``frame_bound_ms``: the subset's operations a lane times the
    frame's walked lanes (the subset is spread evenly over them; the plain
    walk of every frame lane would take minutes), at least the subset's
    distinct rows."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse
    from fovpathtracing_optixcodelatest_tpu_torch.tools import kernel_times

    (po, pd, ones1), (qo, qd, ones2) = sub
    kargs = (config.tmin, config.tmax, *b.walk_args)
    layout = (b.arity, b.leaf_size)
    # the records' keys and the instantiations' names
    names = {key: kernel_times.table_name(k, b) for key, k in
             zip(("k1", "k2", "k2_nocull"), traverse.LAYOUT_KERNELS)}
    got1 = calls[names["k1"]]()
    got2 = calls[names["k2"]]()
    got3 = calls[names["k2_nocull"]]()
    st1, st2, st3 = {}, {}, {}
    p1, p1_ms = _plain_ms(lambda: traverse.closest_hit_plain(
        b.table, po, pd, ones1, *kargs, stats=st1))
    p2, p2_ms = _plain_ms(lambda: traverse.occluded_plain(
        b.table, qo, qd, ones2, *kargs, stats=st2))
    p3, p3_ms = _plain_ms(lambda: traverse.occluded_plain(
        b.table, qo, qd, ones2, *kargs, stats=st3, cull_backface=False))
    hit_eq, tri_eq, ulp, err1 = _k1_agreement(got1, p1)
    mism2 = int((got2 != p2).sum().item())
    mism3 = int((got3 != p3).sum().item())
    assert hit_eq and tri_eq and ulp == 0, \
        f"K1 at {layout} disagrees with its plain version"
    assert mism2 == 0, f"K2 at {layout} disagrees with its plain version"
    assert mism3 == 0, \
        f"the non-culling K2 at {layout} disagrees with its plain version"
    assert int(p1["hit"].sum()) > 0 and int(p2.sum()) > 0
    n1, n2 = po.shape[0], qo.shape[0]
    ms = lambda k, t: None if t is None else t[names[k]]  # noqa: E731
    for key, st, p_ms, mism, n_out in (("k1", st1, p1_ms, 0, 16),
                                       ("k2", st2, p2_ms, mism2, 1),
                                       ("k2_nocull", st3, p3_ms, mism3, 1)):
        n_sub = n1 if key == "k1" else n2
        bound, by, fetch = _bound(st, b.table, n_sub, n_sub, n_out)
        walked = n_active if key == "k1" else n_queried
        frame_bound, frame_by, _ = _bound(
            st, b.table, n_frame if key == "k1" else n_shadow, walked, n_out,
            scale=walked / n_sub)
        rec[key] = {
            "lanes": n1 if key == "k1" else n2, "ms": ms(key, times),
            "frame_ms": ms(key, frame_times),
            "frame_lanes": n_frame if key == "k1" else n_shadow,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
            "frame_bound_ms": frame_bound, "frame_bound_by": frame_by,
            "fetch_bytes": fetch, "work": st,
            "max_abs_err": err1 if key == "k1" else float(min(mism, 1)),
            "rows_per_lane": (st["node_rows"] / (n1 if key == "k1" else n2),
                              st["leaf_rows"] / (n1 if key == "k1" else n2))}
    rec["k1"].update(hits=int(p1["hit"].sum()), hit_equal=hit_eq,
                     tri_id_equal=tri_eq, ulp=ulp)
    rec["k2"].update(occluded=int(p2.sum()), mismatches=mism2,
                     frame_queried=n_queried)
    rec["k2_nocull"].update(occluded=int(p3.sum()), mismatches=mism3,
                            frame_queried=n_queried)
    rec["resources"] = None
    if device == "cuda":
        res = traverse.resources(b.stack_depth)
        rec["resources"] = {k: res[traverse.layout_name(k, *layout)]
                            for k in traverse.LAYOUT_KERNELS}
    return got1, got2, got3


# phase p's tables of JAX's default deep scene: (label, the build's
# arguments): the port's default, JAX's plain L12/A32 and JAX's default
# table for a named L12/A32 layout (from 1M triangles: DFS rows, grouped
# treelets of DEEP_TREELET_BUDGET rows)
JAX_TABLES = (("(16, 6)", {}),
              ("L12/A32 plain", {"leaf_size": 12, "arity": 32, "dfs": False}),
              ("JAX default", {"leaf_size": 12, "arity": 32}))


def jax_tables_phase(city_n: int, frames: int, schedule, width: int,
                     height: int, device="cuda", subset: int = 65536,
                     profile=None) -> dict:
    """(p) JAX's default deep scene, ``box_city_fast(city_n)`` (n=400:
    1,920,012 triangles) under the gradient sky, in each of
    ``JAX_TABLES``:
    the host build cold and warm (from the npz cache it wrote; bit for
    bit), the table's rows and stacks; for each table ``frames`` timed
    frames after one warm-up and as many under the profiler (device busy
    ms, launches; with ``profile``, the op tables), and K1, K2 and the
    non-culling K2 on ``subset`` lanes of the (16, 6) frame's primary and
    bounce-0 shadow rays against their plain versions (exact), timed there
    and on all of the frame's lanes (``_walk_records``). The last table's
    frame must lie within 1 LSB of the second's on 99% of the pixels (its
    bit-identical share is reported), and every table's within 1 LSB of
    the first's; K1 must give the same hits at the same t on every table,
    another triangle only at an exact tie. -> {label: record}."""
    import tempfile

    import numpy as np
    import torch

    from fovpathtracing_optixcodelatest_tpu_torch.config import RenderConfig
    from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
    from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
        host_triangles,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
        gradient_sky_probe,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
        DeviceBVH,
        scene_arrays,
        scene_from_arrays,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops import bvh_native
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        Renderer,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.tools import kernel_times

    tables = JAX_TABLES
    t0 = time.perf_counter()
    meshes, cam = scenes.box_city_fast(n=city_n, seed=0)
    tris = host_triangles(meshes)
    scene_s = time.perf_counter() - t0
    recs, bvhs = {}, []
    saved = os.environ.get("FOVTPU_BVH_CACHE")
    bits = lambda a: a.view(np.uint32)  # noqa: E731 (ids are NaN floats)
    with tempfile.TemporaryDirectory() as cache:
        os.environ["FOVTPU_BVH_CACHE"] = cache
        try:
            for label, kw in tables:
                cold, warm = {}, {}
                t0 = time.perf_counter()
                b = bvh_native.build(tris, timings=cold, **kw)
                cold_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                again = bvh_native.build(tris, timings=warm, **kw)
                warm_s = time.perf_counter() - t0
                assert np.array_equal(bits(again.table), bits(b.table)) \
                    and np.array_equal(again.leaf_perm, b.leaf_perm) and \
                    again.stack_depth == b.stack_depth and \
                    again.top_rows == b.top_rows, \
                    f"the cached {label} table differs from the cold build"
                del again
                recs[label] = {
                    "build": kw, "cold_s": cold_s, "cold": cold,
                    "warm_s": warm_s, "warm": warm, "rows": b.num_rows,
                    "layout": (b.arity, b.leaf_size), "dfs": b.dfs,
                    "top_rows": b.top_rows, "top_stack": b.top_stack,
                    "treelet_stack": b.treelet_stack,
                    "stack_depth": b.stack_depth,
                    "table_bytes": b.table.nbytes}
                bvhs.append(b)
            files = len(os.listdir(cache))
        finally:
            if saved is None:
                del os.environ["FOVTPU_BVH_CACHE"]
            else:
                os.environ["FOVTPU_BVH_CACHE"] = saved
    assert files == len(tables), f"{files} cache files for {len(tables)} tables"
    scene = scene_from_arrays(scene_arrays(meshes, gradient_sky_probe(),
                                           bvh=bvhs[0]), device)
    del meshes, tris
    scs = [scene] + [dataclasses.replace(scene, bvh=DeviceBVH.upload(b,
                                                                     device))
                     for b in bvhs[1:]]
    del bvhs
    config = RenderConfig(width=width, height=height, max_depth=4)
    camera = dataclasses.replace(cam, aspect=width / height)
    root, ext = os.path.splitext(profile) if profile else (None, None)
    for (label, _), sc in zip(tables, scs):
        rec = recs[label]
        rec.update(triangles=sc.num_triangles, scene_s=scene_s)
        renderer = Renderer(sc, config, schedule, device=device)
        renderer.set_camera(camera)
        rec.update(timed_frames(renderer, frames))
        rec["mean_radiance"] = float(renderer.linear_frame().mean())
        assert rec["frame"].shape == (height, width, 3) and rec["finite"]
        assert rec["mean_radiance"] > 0, f"the {label} frame is black"
        name = kernel_times.table_name(f"jax{city_n}", sc.bvh)
        prof = {}
        _profile_frames(renderer, profile and f"{root}_{name}{ext}", prof,
                        name=f"p n={city_n} {label}", frames=frames)
        rec["profile"] = prof.popitem()[1]
        del renderer
    first, plain, last = (recs[label] for label, _ in
                          (tables[0], tables[1], tables[-1]))
    last["plain_share"] = _share_within_1lsb(last["frame"], plain["frame"])
    last["plain_identical"] = float(
        (last["frame"] == plain["frame"]).all(-1).mean())
    assert last["plain_share"] >= 0.99, \
        f"the {tables[-1][0]} frame differs from the {tables[1][0]} one's"
    for rec in recs.values():
        rec["first_share"] = _share_within_1lsb(rec["frame"], first["frame"])
        assert rec["first_share"] >= 0.99, \
            "a table's frame differs from the (16, 6) one's"

    rays = kernel_times.frame_rays(scene, camera, config, schedule, device)
    o, d, act, _ = rays["primary"]
    so, sd, sq = rays["shadow"]
    sel1 = kernel_times.subset_lanes(act, subset)
    sel2 = kernel_times.subset_lanes(sq, subset)
    ones = lambda x: torch.ones((x.numel(),), dtype=torch.bool,  # noqa
                                device=device)
    sub = ((o[sel1].contiguous(), d[sel1].contiguous(), ones(sel1)),
           (so[sel2].contiguous(), sd[sel2].contiguous(), ones(sel2)))
    dbvhs = [sc.bvh for sc in scs]
    calls = kernel_times.table_calls(dbvhs, config, *sub)
    frame_calls = kernel_times.table_calls(dbvhs, config, (o, d, act),
                                           (so, sd, sq))
    times = frame_times = None
    if device == "cuda":
        times = kernel_times.time_kernels(calls)
        frame_times = kernel_times.time_kernels(frame_calls)
    got = [_walk_records(recs[label], b, calls, sub, config, times,
                         frame_times, o.shape[0], so.shape[0],
                         int(act.sum()), int(sq.sum()), device)
           for (label, _), b in zip(tables, dbvhs)]
    a = got[0][0]
    for (label, _), g in zip(tables[1:], got[1:]):
        rec, c = recs[label], g[0]
        rec["hit_equal"] = bool(torch.equal(a["hit"], c["hit"]))
        rec["t_equal"] = bool(torch.equal(a["t"], c["t"]))
        lanes = torch.nonzero(a["tri_id"] != c["tri_id"]).squeeze(1)
        rec["ties"] = _ties(scene, *sub[0][:2], lanes, a, c, config.tmin,
                            config.tmax)
        rec["occluded_mismatches"] = int((got[0][1] != g[1]).sum())
        rec["nocull_mismatches"] = int((got[0][2] != g[2]).sum())
        assert rec["hit_equal"] and rec["t_equal"], \
            f"the {label} table's K1 hits differ from the (16, 6) table's"
        assert rec["ties"]["ties"] == rec["ties"]["lanes"] == lanes.numel(), \
            f"the {label} table's triangles differ beyond ties"
    # the same tree in two row orders: the same triangles too
    last["plain_tri_id_apart"] = int((got[1][0]["tri_id"]
                                      != got[-1][0]["tri_id"]).sum())
    del scs, scene, rays, calls, frame_calls
    return recs


def _jax_tables_lines(name: str, recs: dict) -> None:
    """Phase p's lines: each table's build, then ``_table_lines``."""
    for label, rec in recs.items():
        c, w = rec["cold"], rec["warm"]
        _line(f"{name} {label}: {rec['triangles']} tris, {rec['layout']} "
              f"table, dfs {rec['dfs']}, {rec['rows']} rows, "
              f"{rec['table_bytes'] / 1e6:.1f} MB, stack_depth "
              f"{rec['stack_depth']}, top_rows {rec['top_rows']}, top_stack "
              f"{rec['top_stack']}, treelet_stack {rec['treelet_stack']}; "
              f"host build cold {rec['cold_s']:.2f} s ("
              + ", ".join(f"{k} {v:.2f}" for k, v in c.items())
              + f"), warm {rec['warm_s']:.2f} s ("
              + ", ".join(f"{k} {v:.2f}" for k, v in w.items())
              + f"); frame within 1 LSB of the (16, 6) frame "
              f"{rec['first_share']:.4f}"
              + (f"; K1 hit equal {rec['hit_equal']}, t equal "
                 f"{rec['t_equal']}, tri_id apart on {rec['ties']['lanes']} "
                 f"lanes ({rec['ties']['ties']} exact ties), occlusion apart "
                 f"on {rec['occluded_mismatches']} (non-culling "
                 f"{rec['nocull_mismatches']})" if "ties" in rec else ""))
        _table_lines(f"{name} {label}", rec, rec)
    last = list(recs.values())[-1]
    _line(f"{name} {list(recs)[-1]} against {list(recs)[1]}: frame pixels "
          f"within 1 LSB {last['plain_share']:.4f}, bit-identical "
          f"{last['plain_identical']:.4f}; K1 tri_id apart on "
          f"{last['plain_tri_id_apart']} subset lanes")


def deep_field_phase(city_n: int, frames: int, schedule, width: int,
                     height: int, device="cuda", subset: int = 65536,
                     count: int = 4) -> dict:
    """(q) A two-level table larger than the L2: ``count`` instances of
    ``box_city_fast(city_n)``'s BLAS (``kernel_times.deep_field``: at
    n=400 four of 1,920,012 triangles) under the gradient sky, in its
    (16, 6) two-level table and at each of ``DEEP_FIELD_LAYOUTS``
    (``tlas.build_instanced(leaf_size=, arity=)``): each table's host build
    seconds, rows, bytes and stack depth; the instanced K1 and K2 against
    their plain versions on ``subset`` lanes of the (16, 6) frame's primary
    and bounce-0 shadow rays (exact), timed there and on all of the
    frame's lanes, with bounds (the frame's from the subset's work a lane,
    as ``_walk_records``) and resources; ``frames`` timed frames a table,
    each wide frame within 1 LSB of the (16, 6) frame on 99% of the pixels
    and launching only its layout's instantiations. Keyed by
    ``traverse.layout_name("deep_field", arity, leaf_size)``."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        Renderer,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.tools import kernel_times

    rays = kernel_times.field_rays(
        device, width=width, height=height, schedule=schedule,
        layouts=DEEP_FIELD_LAYOUTS, flat=False,
        field=kernel_times.deep_field(city_n, count))
    sc, config = rays["field"], rays["config"]
    sub = kernel_times.field_subset(rays, subset)
    calls, sub_calls = (kernel_times.field_calls(r) for r in (rays, sub))
    times = frame_times = dict.fromkeys(calls)
    if device == "cuda":  # else a rehearsal: no device time
        times, frame_times = (kernel_times.time_kernels(c)
                              for c in (sub_calls, calls))
    o, d, act, _ = rays["primary"]
    so, _, sq = rays["shadow"]
    n, n_act, ns, nq = o.shape[0], int(act.sum()), so.shape[0], int(sq.sum())
    po, pd, ones1, _ = sub["primary"]
    qo, qd, ones2 = sub["shadow"]
    n1, n2 = po.shape[0], qo.shape[0]
    out, ref_frame = {}, None
    for lay in ((16, 6), *DEEP_FIELD_LAYOUTS):
        b = rays["scene"].bvh if lay == (16, 6) else rays["wide"][lay]
        kargs = (config.tmin, config.tmax, *b.walk_args)
        kw = b.instance_kwargs
        st1, st2 = {}, {}
        p1, p1_ms = _plain_ms(lambda: traverse.closest_hit_plain(
            b.table, po, pd, ones1, *kargs, stats=st1, **kw))
        p2, p2_ms = _plain_ms(lambda: traverse.occluded_plain(
            b.table, qo, qd, ones2, *kargs, stats=st2, **kw))
        mism = kernel_times.field_mismatches(sub, sub_calls, plain=(p1, p2),
                                             layout=lay)
        mism2 = mism.pop("occluded")
        assert not any(mism.values()), \
            f"the deep field's instanced K1 at {lay} disagrees with its " \
            f"plain version: {mism}"
        assert mism2 == 0, \
            f"the deep field's instanced K2 at {lay} disagrees with its " \
            "plain version"
        assert int(p1["hit"].sum()) > 0 and 0 < int(p2.sum()) < n2
        names = {k: traverse.layout_name(k, *lay) for k in
                 ("ik1_primary", "ik2_shadow",
                  *traverse.INSTANCED_KERNELS)}
        rec = {"layout": lay, "rows": b.num_rows,
               "stack_depth": b.stack_depth, "inst_base": b.inst_base,
               "blas_base": b.blas_base, "table_bytes": b.table.numel() * 4,
               "host_build_s": rays["build_s"] if lay == (16, 6)
               else rays["wide_build_s"][lay]}
        for key, st, p_ms, nsub, nframe, walked, n_out, name in (
                ("k1", st1, p1_ms, n1, n, n_act, 20, "ik1_primary"),
                ("k2", st2, p2_ms, n2, ns, nq, 1, "ik2_shadow")):
            bound, by, fetch = _bound(st, b.table, nsub, nsub, n_out)
            frame_bound, frame_by, _ = _bound(st, b.table, nframe, walked,
                                              n_out, scale=walked / nsub)
            rec[key] = {"lanes": nsub, "frame_lanes": nframe,
                        "ms": times[names[name]],
                        "frame_ms": frame_times[names[name]],
                        "plain_ms": p_ms,
                        "bound_ms": bound, "bound_by": by,
                        "frame_bound_ms": frame_bound,
                        "frame_bound_by": frame_by, "fetch_bytes": fetch,
                        "work": st,
                        "rows_per_lane": (st["node_rows"] / nsub,
                                          st["leaf_rows"] / nsub)}
        rec["k1"].update(hits=int(p1["hit"].sum()), mismatches=mism,
                         max_abs_err=float(min(sum(mism.values()), 1)))
        rec["k2"].update(occluded=int(p2.sum()), mismatches=mism2,
                         max_abs_err=float(min(mism2, 1)), frame_queried=nq)
        del p1, p2
        rec["resources"] = None
        if device == "cuda":
            res = traverse.resources(b.stack_depth)
            rec["resources"] = {k: res[names[k]]
                                for k in traverse.INSTANCED_KERNELS}
        renderer = Renderer(dataclasses.replace(rays["scene"], bvh=b),
                            config, rays["schedule"], device=device)
        renderer.set_camera(rays["camera"])
        rec.update(timed_frames(renderer, frames))
        del renderer
        frame = rec.pop("frame")
        rec["frame_mean"] = float(frame.mean())
        assert rec["finite"] and 0 < rec["frame_mean"] < 255
        if ref_frame is None:
            ref_frame = frame
        rec["frame_share"] = _share_within_1lsb(frame, ref_frame)
        assert rec["frame_share"] >= 0.99, \
            f"the deep field's {lay} frame differs from the (16, 6) frame's"
        for k in traverse.INSTANCED_KERNELS:
            assert rec["launches"][names[k]] == rec["launches"][k] > 0 \
                or device != "cuda", \
                f"the deep field's {lay} frame did not launch only {names[k]}"
        out[traverse.layout_name("deep_field", *lay)] = rec
    out["instances"] = len(sc.instances)
    out["unique_triangles"] = rays["scene"].num_triangles
    out["world_triangles"] = sc.num_world_triangles
    return out


def _deep_field_lines(name: str, q: dict) -> None:
    """Phase q's lines: each table's build, kernels and frames."""
    _line(f"{name}: {q['instances']} instances of one "
          f"{q['unique_triangles']}-tri BLAS ({q['world_triangles']} world "
          "tris)")
    tables = {k: v for k, v in q.items() if isinstance(v, dict)}
    for rec in tables.values():
        lay = tuple(rec["layout"])
        k1, k2 = rec["k1"], rec["k2"]
        ms = lambda x: "not timed" if x is None else f"{x:.4f} ms"  # noqa
        _line(f"{name} {lay}: table {rec['rows']} rows (instances "
              f"[{rec['inst_base']}, {rec['blas_base']})), "
              f"{rec['table_bytes'] / 1e6:.1f} MB, stack_depth "
              f"{rec['stack_depth']}, host build {rec['host_build_s']:.2f} s;"
              f" instanced K1 on {k1['lanes']} of the primary lanes "
              f"({k1['hits']} hits) mismatched lanes {k1['mismatches']}, "
              f"{ms(k1['ms'])} (plain {k1['plain_ms']:.1f} ms, bound "
              f"{k1['bound_ms']:.6f} {k1['bound_by']}), rows a lane "
              f"{k1['rows_per_lane']}; on all {k1['frame_lanes']}: "
              f"{ms(k1['frame_ms'])} (bound {k1['frame_bound_ms']:.6f} "
              f"{k1['frame_bound_by']}); instanced K2 on {k2['lanes']} "
              f"shadow lanes ({k2['occluded']} occluded) {k2['mismatches']} "
              f"mismatches, {ms(k2['ms'])} (plain {k2['plain_ms']:.1f} ms, "
              f"bound {k2['bound_ms']:.6f} {k2['bound_by']}); on all "
              f"{k2['frame_lanes']} ({k2['frame_queried']} queried): "
              f"{ms(k2['frame_ms'])} (bound {k2['frame_bound_ms']:.6f} "
              f"{k2['frame_bound_by']})")
        _line(f"{name} {lay}: {len(rec['frame_ms'])} frames after 1 "
              "warm-up: ms/frame " + ", ".join(f"{x:.1f}"
                                               for x in rec["frame_ms"])
              + f" (mean {rec['mean_ms']:.1f}); {rec['mrays']:.2f} Mrays/s; "
              f"peak {rec['peak'] / 2**30:.2f} GiB; frame mean "
              f"{rec['frame_mean']:.3f}, within 1 LSB of the (16, 6) frame "
              f"{rec['frame_share']:.4f}; launches {rec['launches']}")
        _resources_line(f"{name} {lay}", rec)


def _ties(scene, o, d, lanes, a: dict, c: dict, tmin: float,
          tmax: float) -> dict:
    """Lanes where two closest-hit answers ``a`` and ``c`` of the same rays
    name different triangles: how many, and on how many both triangles
    are hit exactly at the answers' t, which is the brute-force closest t
    over every triangle of ``scene`` (an exact tie)."""
    import torch

    from fovpathtracing_optixcodelatest_tpu_torch.ops import intersect

    out = {"lanes": lanes.numel(), "ties": 0, "records": []}
    if not lanes.numel():
        return out
    tp = scene.tri_pack
    tris = (tp[:, 36:39], tp[:, 39:42], tp[:, 42:45])
    ro, rd = o[lanes], d[lanes]
    brute = intersect.brute_force_closest_hit(*tris, ro, rd, tmin, tmax,
                                              chunk=1 << 16)
    t = a["t"][lanes]
    tie = brute["t"] == t
    for ids in (a["tri_id"][lanes], c["tri_id"][lanes]):
        ids = ids.long()
        tk, _, _, hk = intersect.ray_triangle(
            ro[:, None], rd[:, None], *(x[ids][:, None] for x in tris),
            tmin, tmax)
        tie &= hk[:, 0] & (tk[:, 0] == t)
    out["ties"] = int(tie.sum())
    bits = lambda x: x.contiguous().view(torch.int32).tolist()  # noqa: E731
    out["records"] = [
        {"lane": int(lane), "tri_ids": (int(a["tri_id"][lane]),
                                        int(c["tri_id"][lane])),
         "t": float(t[i]), "brute": (int(brute["tri_id"][i]),
                                     float(brute["t"][i])),
         "tie": bool(tie[i]), "origin_bits": bits(ro[i]),
         "direction_bits": bits(rd[i])}
        for i, lane in enumerate(lanes[:8].tolist())]
    return out


def _deep_record(g: dict, k: str, kernel: str) -> dict:
    """The kernels line's record of K1 or K2 on the deep scene ``g``'s
    (16, 6) table."""
    r = g[k]
    return {"triangles": g["triangles"], "stack_depth": g["stack_depth"],
            "lanes": r["lanes"], "ms": r["ms"], "frame_ms": r["frame_ms"],
            "frame_lanes": r["frame_lanes"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "frame_bound_ms": r["frame_bound_ms"],
            "launches": g["launches"][kernel],
            "max_abs_err": r["max_abs_err"],
            "rows_per_lane": r["rows_per_lane"], **g["resources"][kernel]}


def _wide_record(g: dict, k: str, kernel: str, replaces: str,
                 launches: int, spills: dict) -> dict:
    """The kernels line's entry of K1, K2 or the non-culling K2 (``k``:
    "k1", "k2", "k2_nocull"; ``kernel``: its ``kernel_build.LAUNCHES`` name)
    at the wide layout of the deep scene ``g``: its times on phase g's lane
    subset and on the frame's lanes beside the (16, 6) table's on the same
    rays (``narrow_ms``, ``narrow_frame_ms``), its design and resources,
    with ``launches`` from the path that ran it (the wide frames; the
    raycast for the non-culling K2)."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse

    w = g["wide"]
    r = w[k]
    name = traverse.layout_name(kernel, *w["layout"])
    return {"name": name, "route": "cuda",
            "source": KERNEL_SRC + "traverse.cu",
            "replaces": JAX_OPS + replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "triangles": g["triangles"], "stack_depth": w["stack_depth"],
            "lanes": r["lanes"], "frame_ms": r["frame_ms"],
            "frame_lanes": r["frame_lanes"],
            "frame_bound_ms": r["frame_bound_ms"],
            "narrow_ms": g[k]["ms"], "narrow_frame_ms": g[k]["frame_ms"],
            "rows_per_lane": r["rows_per_lane"],
            "spill_bytes": spills.get(name), **w["resources"][kernel]}


def _instanced_record(name: str, replaces: str, r: dict, launches: dict,
                      res: dict) -> dict:
    """The kernels line's entry of an instanced kernel: its phase-e record
    ``r`` (``flat_ms``: the single-level kernel on the same rays against
    the flattened table) with its launches in the field's timed frames and
    its resources at the field's stack depth."""
    return {"name": name, "route": "cuda",
            "source": KERNEL_SRC + "traverse.cu",
            "replaces": JAX_OPS + replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "flat_ms": r["flat_ms"], "lanes": r["lanes"], **res[name]}


def _field_record(inst: dict, city: dict, kernel: str, layout,
                  replaces: str, spills: dict) -> dict:
    """The kernels line's entry of the instanced K1 or K2 (``kernel``) at a
    wide ``layout``: its phase-e record on the 1,000-instance field's lanes
    (launches: the field's wide frames; ``narrow_ms``: the (16, 6) table's
    kernel on the same rays), and ``city``, its record on the city field
    (8 instances of a 1,500-triangle BLAS)."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse

    key = traverse.layout_name("field", *layout)
    k = "k1" if kernel == "closest_hit_instanced" else "k2"
    name = traverse.layout_name(kernel, *layout)
    w, cw = inst["wide"][key], city["wide"][key]
    r, cr = w[k], cw[k]
    return {"name": name, "route": "cuda",
            "source": KERNEL_SRC + "traverse.cu",
            "replaces": JAX_OPS + replaces, "launches": w["launches"][name],
            "max_abs_err": max(r["max_abs_err"], cr["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "lanes": r["lanes"],
            "stack_depth": w["stack_depth"], "narrow_ms": inst[k]["ms"],
            "profile_ms_per_launch": (w["profile"]["kernel_ms_per_launch"][
                kernel] if w.get("profile") else None),
            "spill_bytes": spills.get(name), **w["resources"][kernel],
            "city": {"lanes": cr["lanes"], "ms": cr["ms"],
                     "narrow_ms": city[f"{k}_ms"],
                     "plain_ms": cr["plain_ms"], "bound_ms": cr["bound_ms"],
                     "bound_by": cr["bound_by"],
                     "launches": cw["launches"][name],
                     "stack_depth": cw["stack_depth"],
                     "max_abs_err": cr["max_abs_err"]}}


def _deep_field_record(q: dict, kernel: str, layout) -> dict:
    """The kernels line's record of the instanced K1 or K2 (``kernel``) on
    phase q's table of ``layout``: its times, bounds and launches there."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse

    rec = q[traverse.layout_name("deep_field", *layout)]
    r = rec["k1" if kernel == "closest_hit_instanced" else "k2"]
    return {"lanes": r["lanes"], "frame_lanes": r["frame_lanes"],
            "ms": r["ms"], "frame_ms": r["frame_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "frame_bound_ms": r["frame_bound_ms"],
            "frame_bound_by": r["frame_bound_by"],
            "launches": rec["launches"][traverse.layout_name(kernel,
                                                                 *layout)],
            "max_abs_err": r["max_abs_err"], "stack_depth": rec["stack_depth"],
            "rows": rec["rows"], "table_bytes": rec["table_bytes"],
            "rows_per_lane": r["rows_per_lane"]}


def _jax_tables_record(p: dict, k: str, layout) -> dict:
    """The kernels line's records of K1, K2 or the non-culling K2 (``k``)
    on phase p's tables of ``layout``, keyed by table, with the frames'
    launches of the kernel's instantiation there (0 for the non-culling K2,
    which the frames do not launch)."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse

    kernel = dict(zip(("k1", "k2", "k2_nocull"),
                      traverse.LAYOUT_KERNELS))[k]
    name = traverse.layout_name(kernel, *layout)
    return {label: {"lanes": rec[k]["lanes"], "ms": rec[k]["ms"],
                    "frame_ms": rec[k]["frame_ms"],
                    "frame_lanes": rec[k]["frame_lanes"],
                    "plain_ms": rec[k]["plain_ms"],
                    "bound_ms": rec[k]["bound_ms"],
                    "bound_by": rec[k]["bound_by"],
                    "frame_bound_ms": rec[k]["frame_bound_ms"],
                    "launches": rec["launches"][name],
                    "max_abs_err": rec[k]["max_abs_err"],
                    "stack_depth": rec["stack_depth"], "rows": rec["rows"],
                    "rows_per_lane": rec[k]["rows_per_lane"]}
            for label, rec in p.items()
            if tuple(rec["layout"]) == tuple(layout)}


def _resources_line(name: str, rec: dict) -> None:
    """The line of a table's instanced kernels' design and resources at its
    stack depth, where the run measured them."""
    if rec["resources"]:
        _line(f"{name} resources at depth {rec['stack_depth']}: "
              + "; ".join(
                  f"{k} {r['group_lanes']} lane(s) a ray, stack in "
                  f"{r['stack']} memory, {r['registers']} regs, "
                  f"{r['local_bytes']} B local, {r['shared_bytes']} B "
                  f"shared/block, {r['blocks_per_sm']} blocks/SM"
                  for k, r in rec["resources"].items()))


def _field_lines(name: str, wide: dict) -> None:
    """Phase e's lines of a field's wide tables (``_field_layouts``)."""
    for rec in wide.values():
        lay = tuple(rec["layout"])
        k1, k2 = rec["k1"], rec["k2"]
        ms = lambda r: "not timed" if r["ms"] is None else (  # noqa: E731
            f"{r['ms']:.4f} ms")
        _line(f"{name} {lay}: table {rec['rows']} rows (instances "
              f"[{rec['inst_base']}, {rec['blas_base']})), stack_depth "
              f"{rec['stack_depth']}, {rec['table_bytes'] / 1e6:.3f} MB, "
              f"host build {rec['host_build_s']:.2f} s; instanced K1 on "
              f"{k1['lanes']} primary lanes ({k1['hits']} hits) mismatched "
              f"lanes {k1['mismatches']}, {ms(k1)} (plain "
              f"{k1['plain_ms']:.1f}, bound {k1['bound_ms']:.5f} "
              f"{k1['bound_by']}); instanced K2 on {k2['lanes']} shadow lanes "
              f"({k2['queried']} queried, {k2['occluded']} occluded) "
              f"{k2['mismatches']} mismatches, {ms(k2)} (plain "
              f"{k2['plain_ms']:.1f}, bound {k2['bound_ms']:.5f} "
              f"{k2['bound_by']}); frame within 1 LSB of the (16, 6) frame "
              f"{rec['frame_share']:.4f}")
        _line(f"{name} {lay}: {len(rec['frame_ms'])} frames after 1 "
              "warm-up: ms/frame " + ", ".join(f"{x:.1f}"
                                               for x in rec["frame_ms"])
              + f" (mean {rec['mean_ms']:.1f}); {rec['mrays']:.2f} Mrays/s; "
              f"peak {rec['peak'] / 2**30:.2f} GiB; frame mean "
              f"{rec['frame_mean']:.3f}; launches {rec['launches']}")
        _resources_line(f"{name} {lay}", rec)


def _table_lines(name: str, g: dict, rec: dict) -> None:
    """Phase g's lines of one table ``rec`` of the deep scene ``g``."""
    _line(_frames_line(f"{name}: {len(rec['frame_ms'])} frames after 1 "
                       "warm-up", rec)
          + f"; mean radiance {rec['mean_radiance']:.4f}")
    p = rec["profile"]
    _line(f"{name} profiled: device busy {p['device_busy_ms']:.1f} ms of a "
          f"{p['frame_ms']:.1f} ms frame (idle share {p['idle_share']:.3f}); "
          "K1/K2 " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                               p["kernel_ms"].items()))
    for k in ("k1", "k2", "k2_nocull"):
        r = rec[k]
        ms = "not timed" if r["ms"] is None else (
            f"{r['ms']:.4f} ms on the subset, {r['frame_ms']:.4f} ms on the "
            f"frame's {r['frame_lanes']} lanes")
        _line(f"{name} {k.upper()} at depth {rec['stack_depth']} on "
              f"{r['lanes']} lanes: exact vs plain; {ms}; plain "
              f"{r['plain_ms']:.1f} ms; bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), on the frame's lanes "
              f"{r['frame_bound_ms']:.5f} ms ({r['frame_bound_by']}, from "
              f"the subset's work a lane); node/leaf rows a lane "
              f"{r['rows_per_lane'][0]:.2f}/{r['rows_per_lane'][1]:.2f}")
    if rec["resources"]:
        _line(f"{name} design and resources at depth {rec['stack_depth']}: "
              + "; ".join(
                  f"{k} {r['group_lanes']} lane(s) a ray, rows by "
                  f"{r['row_copy']}, stack in {r['stack']} memory, "
                  f"{r['registers']} regs, {r['local_bytes']} B local, "
                  f"{r['shared_bytes']} B shared/block, "
                  f"{r['blocks_per_sm']} blocks/SM"
                  for k, r in rec["resources"].items()))


def _deep_lines(name: str, g: dict) -> None:
    c, w = g["cold"], g["warm"]
    _line(f"{name}: box_city_fast(n={g['city_n']}), {g['triangles']} tris, "
          f"(16, 6) table {g['rows']} rows, {g['table_bytes'] / 1e6:.1f} MB, "
          f"stack_depth {g['stack_depth']}; host build: scene "
          f"{g['scene_s']:.2f} s, triangles {g['triangles_s']:.2f} s, cold "
          f"BVH {g['cold_build_s']:.2f} s ("
          + ", ".join(f"{k} {v:.2f}" for k, v in c.items())
          + f"), scene arrays {g['arrays_s']:.2f} s, upload "
          f"{g['upload_s']:.2f} s; warm start from the npz cache "
          f"{g['warm_start_s']:.2f} s ("
          + ", ".join(f"{k} {v:.2f}" for k, v in w.items())
          + " + upload)")
    _line(f"{name} memory_report: {g['memory_report']}")
    _table_lines(f"{name} (16, 6)", g, g)
    wd = g["wide"]
    lay = tuple(wd["layout"])
    _line(f"{name} {lay} table: {wd['rows']} rows, "
          f"{wd['table_bytes'] / 1e6:.1f} MB, stack_depth "
          f"{wd['stack_depth']}; cold build {wd['build_s']:.2f} s ("
          + ", ".join(f"{k} {v:.2f}" for k, v in wd["build"].items())
          + f"); against the (16, 6) table: frame pixels within 1 LSB "
          f"{wd['frame_share']:.4f}, K1 hit equal {wd['hit_equal']}, t equal "
          f"{wd['t_equal']}, tri_id apart on {wd['ties']['lanes']} lanes "
          f"({wd['ties']['ties']} exact ties), occlusion apart on "
          f"{wd['occluded_mismatches']} (non-culling "
          f"{wd['nocull_mismatches']}) of the subset's lanes")
    _table_lines(f"{name} {lay}", g, wd)
    if g["k1"]["ms"] is not None:
        _line(f"{name} {lay} against (16, 6) on the same rays, ms on the "
              "subset; on the frame's lanes: " + "; ".join(
                  f"{k.upper()} {wd[k]['ms']:.4f} vs {g[k]['ms']:.4f}; "
                  f"{wd[k]['frame_ms']:.4f} vs {g[k]['frame_ms']:.4f} "
                  f"({wd[k]['frame_ms'] / g[k]['frame_ms']:.2f}x)"
                  for k in ("k1", "k2", "k2_nocull")))


def open_scene():
    """The JAX package's golden-image scene (``tests/test_golden.py``): an
    open-air floor, a sphere and a box under the constant ambient probe ->
    (meshes, camera). Phase (h)'s golden scene."""
    from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera
    from fovpathtracing_optixcodelatest_tpu_torch.models.material import (
        Material,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
        make_box,
        make_icosphere,
        make_quad,
    )

    def matte(c):
        return Material(color=c, emission=(0, 0, 0), metallic=0.0,
                        roughness=1.0, transmission=0.0, specular=0.3,
                        specular_tint=0.0)

    meshes = [
        make_quad((-20, 0, 20), (20, 0, 20), (20, 0, -20), (-20, 0, -20),
                  matte((0.7, 0.7, 0.7))),
        make_icosphere((0, 1.0, 0), 1.0, 1, matte((0.8, 0.3, 0.2))),
        make_box((2.5, 0.75, -1), (0.75, 0.75, 0.75), matte((0.2, 0.4, 0.8))),
    ]
    return meshes, Camera(eye=(0, 3.5, 7), lookat=(0, 0.8, 0), fov_y=45.0)


def raycast_scene():
    """The JAX package's 04 raycast scene (``tests/test_features.py``): a
    white floor and a textured red wall -> (meshes, images, camera, light
    position)."""
    from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera
    from fovpathtracing_optixcodelatest_tpu_torch.models.material import (
        Material,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import make_quad
    from fovpathtracing_optixcodelatest_tpu_torch.models.texture import (
        checkerboard,
    )

    floor = make_quad((-5, 0, 5), (5, 0, 5), (5, 0, -5), (-5, 0, -5),
                      Material(color=(1.0, 1.0, 1.0), emission=(0, 0, 0)))
    wall = make_quad((-1, 0, 0), (1, 0, 0), (1, 2, 0), (-1, 2, 0),
                     Material(color=(1.0, 0.2, 0.2), emission=(0, 0, 0)),
                     texture_id=0)
    cam = Camera(eye=(0, 3, 8), lookat=(0, 0.5, 0), fov_y=50.0, aspect=4 / 3)
    return [floor, wall], [checkerboard(16, 4)], cam, (0.0, 10.0, 2.0)


def golden_frame(scene, cam, config, schedule, seed: int = 0,
                 subframes: int = 1, fold: bool = True):
    """``subframes`` frames of ``render_frame`` at the frame centre, as the
    JAX golden tests render them: subframe ``sf`` keyed by fold_in(key(seed),
    sf), or by key(seed) itself (``fold=False``, the oracle test's one
    frame) -> the last uint8 frame (numpy)."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import (
        fold_in,
        prng_key,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render import film
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        render_frame,
    )

    w, h = config.width, config.height
    camp = dataclasses.replace(cam, aspect=w / h).device_params(scene.device)
    pad = film.schedule_padding(schedule, w, h)
    canvas = film.new_canvas(w, h, pad, scene.device)
    key = prng_key(seed)
    for sf in range(subframes):
        canvas, frame, _ = render_frame(
            scene, camp, w // 2, h // 2, sf, canvas,
            fold_in(key, sf) if fold else key, config, schedule)
    return frame.cpu().numpy()


def fovea_schedule(r: int = 12, spp: int = 16):
    """The JAX golden test's two-pass schedule: a 4x periphery at 2 spp and
    an ``spp`` fovea of radius ``r``."""
    from fovpathtracing_optixcodelatest_tpu_torch.config import (
        FoveationPass,
        FoveationSchedule,
    )

    return FoveationSchedule(passes=(
        FoveationPass(factor=4, spp=2, r_inner=float(r), r_outer=1e9,
                      redraw=False),
        FoveationPass(factor=1, spp=spp, r_inner=0.0, r_outer=float(r + 1),
                      redraw=True, launch_w=2 * (r + 1), launch_h=2 * (r + 1),
                      centered=True, center_offset=r + 1),
    ))


GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden", "open_scene_48x36_u4.npz")
# the JAX package's thresholds (tests/test_oracle_ssim.py,
# tests/test_golden.py): the BVH frame against the oracle's, the frame
# against the golden image
ORACLE_SSIM, ORACLE_MEAN_ABS = 0.98, 5e-3
GOLDEN_SSIM, GOLDEN_MEAN_LSB = 0.98, 4.0


def oracle_phase(device="cuda") -> dict:
    """(h) The brute-force oracle and the golden images on ``device``: the
    cornell box at 64x48 ``uniform(4)`` through K1/K2 against the oracle
    (SSIM and mean abs), a stack cut to depth 1 against the oracle at 48x36
    (SSIM must crater); the open scene at 48x36 ``uniform(4)`` against
    ``tests/golden/open_scene_48x36_u4.npz``; the equal-spp fovea against
    the uniform frame (bit-identical); the 04 raycast, whose shadow rays
    launch the non-culling K2, with the JAX test's assertions and against
    its CPU run (every pixel within 1 LSB), and that kernel against its
    plain version on the raycast's shadow rays (exact)."""
    import numpy as np
    import torch

    from fovpathtracing_optixcodelatest_tpu_torch.config import (
        FoveationSchedule,
        RenderConfig,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
    from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
        constant_probe,
        gradient_sky_probe,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
        build_scene,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops import (
        kernel_build,
        traverse,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render import simple
    from fovpathtracing_optixcodelatest_tpu_torch.utils.metrics import ssim

    out = {}
    meshes, cam = scenes.cornell(sphere_subdiv=1)
    scene = build_scene(meshes, gradient_sky_probe(width=64, height=32),
                        device=device)
    base = RenderConfig(width=64, height=48)
    oracle = dataclasses.replace(base, traversal="oracle")
    u4 = FoveationSchedule.uniform(4)
    img_bvh = golden_frame(scene, cam, base, u4, fold=False) / 255.0
    img_orc = golden_frame(scene, cam, oracle, u4, fold=False) / 255.0
    out["oracle_ssim"] = ssim(img_bvh, img_orc)
    out["oracle_mean_abs"] = float(np.abs(img_bvh - img_orc).mean())
    assert out["oracle_ssim"] >= ORACLE_SSIM, out
    assert out["oracle_mean_abs"] < ORACLE_MEAN_ABS, out
    small = RenderConfig(width=48, height=36)
    u2 = FoveationSchedule.uniform(2)
    broken = dataclasses.replace(
        scene, bvh=dataclasses.replace(scene.bvh, stack_depth=1))
    out["broken_ssim"] = ssim(
        golden_frame(scene, cam, dataclasses.replace(small,
                                                     traversal="oracle"),
                     u2, fold=False) / 255.0,
        golden_frame(broken, cam, small, u2, fold=False) / 255.0)
    assert out["broken_ssim"] < 0.9, "a cut stack passed the oracle check"

    meshes, cam = open_scene()
    scene = build_scene(meshes, constant_probe((2.5, 2.5, 2.5)),
                        device=device)
    frame = golden_frame(scene, cam, small, u4)
    golden = np.load(GOLDEN)["frame"]
    out["golden_ssim"] = ssim(frame / 255.0, golden / 255.0)
    out["golden_mean_lsb"] = float(
        np.abs(frame.astype(int) - golden.astype(int)).mean())
    assert out["golden_ssim"] > GOLDEN_SSIM, out
    assert out["golden_mean_lsb"] < GOLDEN_MEAN_LSB, out
    cx, cy, rr = 24, 18, 8
    fovea = golden_frame(scene, cam, small, fovea_schedule(), seed=2)
    uniform = golden_frame(scene, cam, small, FoveationSchedule.uniform(16),
                           seed=2)
    crop = np.s_[cy - rr: cy + rr, cx - rr: cx + rr]
    out["fovea_identical"] = bool(np.array_equal(fovea[crop], uniform[crop]))
    assert out["fovea_identical"], "the equal-spp fovea differs from uniform"

    meshes, images, cam, light = raycast_scene()
    frames = {}
    for dev in (device, "cpu"):
        sc = build_scene(meshes, texture_images=images, device=dev,
                         shading_normals=True)
        kernel_build.reset_launches()
        frames[dev] = simple.raycast(sc, cam.device_params(dev), 64, 48,
                                     light_pos=light).cpu().numpy()
        if dev == device:
            out["raycast_launches"] = kernel_build.LAUNCHES.copy()
            scene = sc
    frame = frames[device]
    r, g = frame[..., 0].astype(int), frame[..., 1].astype(int)
    bl = frame[..., 2].astype(int)
    assert frame.shape == (48, 64, 3) and frame.max() > 60
    assert (frame[-1] == 0).all(), "sky rows are not black"
    floor = (abs(r - g) < 3) & (abs(g - bl) < 3) & (r > 10)
    vals = r[floor].astype(float)
    out["raycast_floor_ratio"] = float(
        np.percentile(vals, 95) / max(np.percentile(vals, 5), 1.0))
    assert len(vals) > 100 and out["raycast_floor_ratio"] > 1.5
    assert ((r > g + 30) & (r > 20)).sum() > 20, "the red wall is missing"
    out["raycast_share"] = _share_within_1lsb(frame, frames["cpu"])
    assert out["raycast_share"] == 1.0, \
        f"raycast on {device} vs CPU: {out['raycast_share']}"
    # the raycast from the wide tables: their non-culling K2 on a user's path
    out["raycast_wide"] = {}
    for lay in traverse.WIDE_LAYOUTS:
        sc = build_scene(meshes, texture_images=images, device=device,
                         shading_normals=True, arity=lay[0],
                         leaf_size=lay[1])
        kernel_build.reset_launches()
        wide = simple.raycast(sc, cam.device_params(device), 64, 48,
                              light_pos=light).cpu().numpy()
        name = traverse.layout_name("occluded_nocull", *lay)
        out["raycast_wide"][name] = {
            "launches": kernel_build.LAUNCHES[name],
            "share": _share_within_1lsb(wide, frame)}
        assert out["raycast_wide"][name]["share"] == 1.0, \
            f"the raycast from the {lay} table differs from the (16, 6) one"

    so, sd, q = simple.shadow_rays(scene, cam.device_params(device), 64, 48,
                                   light_pos=light)
    b = scene.bvh
    got = traverse.occluded(b.table, so, sd, q, 1e-3, 1.0 - 1e-3,
                            *b.walk_args, cull_backface=False)
    want = traverse.occluded_plain(b.table, so, sd, q, 1e-3, 1.0 - 1e-3,
                                   *b.walk_args, cull_backface=False)
    culled = traverse.occluded_plain(b.table, so, sd, q, 1e-3, 1.0 - 1e-3,
                                     *b.walk_args)
    out["raycast_shadow"] = {
        "lanes": so.shape[0], "queried": int(q.sum()),
        "occluded": int(want.sum()), "occluded_culling": int(culled.sum()),
        "mismatches": int((got != want).sum())}
    assert out["raycast_shadow"]["mismatches"] == 0, \
        "the non-culling K2 disagrees with its plain version (raycast)"
    assert int(want.sum()) > 0
    return out


def readme_example(width: int, height: int, schedule=None,
                   device="cuda") -> dict:
    """The README's library example: ``Renderer(meshes=...)`` builds the
    cornell scene itself (on the card by default) and renders one frame at
    the centre gaze -> the frame's shape, mean, the scene's device and the
    launches."""
    from fovpathtracing_optixcodelatest_tpu_torch.config import (
        FoveationSchedule,
        RenderConfig,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
    from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        Renderer,
    )

    meshes, camera = scenes.cornell()
    kernel_build.reset_launches()
    kw = {} if device == "cuda" else {"device": device}
    r = Renderer(meshes=meshes, config=RenderConfig(width=width,
                                                    height=height),
                 schedule=schedule or FoveationSchedule.reference_32_16_8(),
                 **kw)
    r.set_camera(camera)
    frame = r.render(gaze=(width // 2, height // 2))
    _sync(device)
    return {"shape": frame.shape, "mean": float(frame.mean()),
            "device": str(r.scene.device), "traces": r.stats["traces"],
            "launches": kernel_build.LAUNCHES.copy()}


def nocull_check(bvh, so, sd, sq, tmin: float, tmax: float,
                 device="cuda") -> dict:
    """The non-culling K2 against its plain version on shadow rays (exact),
    its CUDA-event time, the plain version's time and the bound."""
    import torch

    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse
    from fovpathtracing_optixcodelatest_tpu_torch.tools import kernel_times

    kargs = (tmin, tmax, *bvh.walk_args)
    call = lambda: traverse.occluded(  # noqa: E731
        bvh.table, so, sd, sq, *kargs, cull_backface=False)
    got = call()
    st = {}
    want, plain_ms = _plain_ms(lambda: traverse.occluded_plain(
        bvh.table, so, sd, sq, *kargs, stats=st, cull_backface=False))
    culled = traverse.occluded(bvh.table, so, sd, sq, *kargs)
    mism = int((got != want).sum().item())
    assert mism == 0, "the non-culling K2 disagrees with its plain version"
    bound, by, fetch = _bound(st, bvh.table, so.shape[0], int(sq.sum()), 1)
    return {"lanes": so.shape[0], "queried": int(sq.sum()),
            "occluded": int(want.sum()),
            "occluded_culling": int(culled.sum()),
            "only_without_culling": int((want & ~culled).sum()),
            "mismatches": mism, "max_abs_err": float(min(mism, 1)),
            "ms": kernel_times.events_ms(call) if device == "cuda" else None,
            "culling_ms": (kernel_times.events_ms(
                lambda: traverse.occluded(bvh.table, so, sd, sq, *kargs))
                if device == "cuda" else None),
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "fetch_bytes": fetch, "work": st}


@contextlib.contextmanager
def _plain_walks():
    """Inside: ``ops/traverse``'s ``closest_hit`` and ``occluded`` run
    their plain versions on the tensors' device (a frame rendered by the
    plain walks on the card)."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse

    saved = traverse.closest_hit, traverse.occluded
    traverse.closest_hit = traverse.closest_hit_plain
    traverse.occluded = traverse.occluded_plain
    try:
        yield
    finally:
        traverse.closest_hit, traverse.occluded = saved


def raycast_field_phase(width: int, height: int, device="cuda",
                        count: int = 1000,
                        layouts=((16, 6), (32, 12), (32, 24))) -> dict:
    """(r) The 04 raycast of the instance field (``kernel_times.
    instance_field``, built by ``build_scene_instanced(...,
    shading_normals=True)``) at ``width`` x ``height`` from its two-level
    table at each of ``layouts`` (phase e's tables): the frame rendered
    by the kernels (launches counted) and by the plain versions on the
    same device, byte for byte; the non-culling two-level K2 against its
    plain version on every queried shadow lane, timed (CUDA events) beside
    the culling two-level K2 on the same lanes, with its bound; each
    frame's share of pixels within 1 LSB of the first layout's. Keyed by
    ``traverse.layout_name("raycast_field", arity, leaf_size)``."""
    import numpy as np

    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
        build_scene_instanced,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops import (
        kernel_build,
        traverse,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render import simple
    from fovpathtracing_optixcodelatest_tpu_torch.tools import kernel_times

    sc, cam = kernel_times.instance_field(count)
    t0 = time.perf_counter()
    scene = build_scene_instanced(sc, shading_normals=True, device=device)
    build_s = time.perf_counter() - t0
    camp = dataclasses.replace(cam, aspect=width / height).device_params(
        device)
    out, first = {}, None
    for lay in layouts:
        t0 = time.perf_counter()
        b = (scene.bvh if tuple(lay) == (16, 6)
             else kernel_times.field_table(sc, *lay, device))
        table_s = build_s if tuple(lay) == (16, 6) else (
            time.perf_counter() - t0)
        sc_lay = dataclasses.replace(scene, bvh=b)
        kernel_build.reset_launches()
        frame = simple.raycast(sc_lay, camp, width, height)
        _sync(device)
        launches = kernel_build.LAUNCHES.copy()
        t0 = time.perf_counter()
        with _plain_walks():
            plain_frame = simple.raycast(sc_lay, camp, width, height)
        _sync(device)
        plain_frame_s = time.perf_counter() - t0
        frame, plain_frame = frame.cpu().numpy(), plain_frame.cpu().numpy()
        first = frame if first is None else first

        so, sd, sq = simple.shadow_rays(sc_lay, camp, width, height)
        kargs = (1e-3, 1.0 - 1e-3, *b.walk_args)
        kw = b.instance_kwargs
        call = lambda: traverse.occluded(  # noqa: E731
            b.table, so, sd, sq, *kargs, cull_backface=False, **kw)
        culling = lambda: traverse.occluded(  # noqa: E731
            b.table, so, sd, sq, *kargs, **kw)
        got = call()
        st = {}
        want, plain_ms = _plain_ms(lambda: traverse.occluded_plain(
            b.table, so, sd, sq, *kargs, stats=st, cull_backface=False,
            **kw))
        culled = culling()
        mism = int((got != want).sum().item())
        times = dict.fromkeys(("nocull", "culling"))
        if device == "cuda":  # else a rehearsal: no device time
            times = kernel_times.time_kernels({"nocull": call,
                                               "culling": culling})
        ns, nq = so.shape[0], int(sq.sum())
        bound, by, fetch = _bound(st, b.table, ns, nq, 1)
        name = traverse.layout_name(traverse.NOCULL_INSTANCED, *lay)
        res = None
        if device == "cuda":
            res = traverse.resources(b.stack_depth)[name]
        out[traverse.layout_name("raycast_field", *lay)] = {
            "layout": list(lay), "rows": b.num_rows,
            "stack_depth": b.stack_depth, "host_build_s": table_s,
            "frame_shape": list(frame.shape),
            "lit_share": float((frame.max(-1) > 0).mean()),
            "frame_mean": float(frame.mean()),
            "plain_identical": bool(np.array_equal(frame, plain_frame)),
            "share_vs_first": _share_within_1lsb(frame, first),
            "plain_frame_s": plain_frame_s, "launches": launches,
            "kernel": name, "lanes": ns, "queried": nq,
            "occluded": int(want.sum()),
            "occluded_culling": int(culled.sum()),
            "only_without_culling": int((want & ~culled).sum()),
            "mismatches": mism, "max_abs_err": float(min(mism, 1)),
            "ms": times["nocull"], "culling_ms": times["culling"],
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "fetch_bytes": fetch, "work": st, "resources": res}
    return out


def _raycast_field_lines(rf: dict) -> None:
    """Phase r's lines (``raycast_field_phase``)."""
    for rec in rf.values():
        lay = tuple(rec["layout"])
        ms = lambda x: "not timed" if x is None else f"{x:.4f} ms"  # noqa
        _line(f"r raycast of the instance field {lay}: table {rec['rows']} "
              f"rows, stack_depth {rec['stack_depth']}, host build "
              f"{rec['host_build_s']:.2f} s; frame {rec['frame_shape']}, lit "
              f"{rec['lit_share']:.4f}, byte for byte the plain walks' frame "
              f"{rec['plain_identical']} (plain frame "
              f"{rec['plain_frame_s']:.2f} s), within 1 LSB of the first "
              f"layout's frame {rec['share_vs_first']:.4f}; {rec['kernel']} on "
              f"{rec['lanes']} shadow lanes ({rec['queried']} queried, "
              f"{rec['occluded']} occluded, {rec['occluded_culling']} by the "
              f"culling K2, {rec['only_without_culling']} only without): "
              f"{rec['mismatches']} lanes differ; {ms(rec['ms'])} (culling "
              f"two-level K2 {ms(rec['culling_ms'])}); plain "
              f"{rec['plain_ms']:.1f} ms; bound {rec['bound_ms']:.6f} ms "
              f"({rec['bound_by']}); work {rec['work']}; launches "
              f"{ {k: v for k, v in rec['launches'].items() if v} }")
        if rec["resources"]:
            r = rec["resources"]
            _line(f"r {rec['kernel']} resources at depth "
                  f"{rec['stack_depth']}: {r['registers']} regs, "
                  f"{r['local_bytes']} B local, {r['shared_bytes']} B "
                  f"shared/block, {r['blocks_per_sm']} blocks/SM")


def _check_raycast_field(rf: dict, device="cuda") -> None:
    """Phase r's gates: each layout's kernel exact on every queried lane,
    its frame the plain walks' byte for byte and within 1 LSB of the first
    layout's on 99% of the pixels, the two-level kernels (and no
    single-level one) launched, under the layout's names too."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse

    for rec in rf.values():
        lay = tuple(rec["layout"])
        assert rec["mismatches"] == 0, \
            f"the non-culling two-level K2 at {lay} disagrees with its " \
            "plain version"
        assert rec["plain_identical"], \
            f"the raycast at {lay} differs from the plain walks' frame"
        assert rec["share_vs_first"] >= 0.99, \
            f"the raycast at {lay} differs from the first layout's"
        assert rec["occluded"] > 0 and rec["lit_share"] > 0.1
        n = rec["launches"]
        if device == "cuda":
            for k in ("closest_hit_instanced", traverse.NOCULL_INSTANCED):
                name = traverse.layout_name(k, *lay)
                assert n[k] > 0 and n[name] == n[k], \
                    f"the raycast at {lay} did not launch {name}"
        for k in ("closest_hit", "occluded", "occluded_nocull",
                  "occluded_instanced"):
            assert n[k] == 0, f"the raycast at {lay} launched {k}"


def _raycast_field_record(rec: dict, spills: dict) -> dict:
    """The kernels line's entry of the non-culling two-level K2 at one
    layout: its phase-r record (launches: the raycast's)."""
    return {"name": rec["kernel"], "route": "cuda",
            "source": KERNEL_SRC + "traverse.cu",
            "replaces": JAX_OPS + "traverse8.py:1487",
            "launches": rec["launches"][rec["kernel"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
            "layout": rec["layout"], "lanes": rec["lanes"],
            "queried": rec["queried"], "stack_depth": rec["stack_depth"],
            "culling_ms": rec["culling_ms"],
            "spill_bytes": spills.get(rec["kernel"]),
            **(rec["resources"] or {})}


def _write_textured_obj(directory: str) -> str:
    """A 10 x 10 floor quad with a checkerboard ``map_Kd`` (an OBJ, its MTL
    and a PNG in ``directory``) -> the OBJ's path."""
    import numpy as np

    from fovpathtracing_optixcodelatest_tpu_torch.utils.image import save_png

    tex = np.zeros((256, 256, 3), dtype=np.float32)
    tex[(np.arange(256)[:, None] // 32 + np.arange(256)[None, :] // 32)
        % 2 == 0] = 1.0
    save_png(os.path.join(directory, "checker.png"), tex)
    with open(os.path.join(directory, "scene.mtl"), "w") as f:
        f.write("newmtl ground\nKd 1 1 1\nmap_Kd checker.png\n")
    obj = ["mtllib scene.mtl"]
    for p in [(-5, 0, 5), (5, 0, 5), (5, 0, -5), (-5, 0, -5)]:
        obj.append(f"v {p[0]} {p[1]} {p[2]}")
    obj += ["vt 0 0", "vt 1 0", "vt 1 1", "vt 0 1", "usemtl ground",
            "f 1/1 2/2 3/3 4/4"]
    path = os.path.join(directory, "scene.obj")
    with open(path, "w") as f:
        f.write("\n".join(obj))
    return path


def demand_phase(city_n: int, schedule, width: int, height: int,
                 small_size, small_schedule, pages=(1024, 64),
                 cli_size=None, cli_schedule="32_16_8", device="cuda",
                 profile=None, results=None) -> dict:
    """(i) Demand-loaded textures: ``box_city_textured(city_n)`` with its
    textures paged through a ``DemandLoader`` of each atlas size in
    ``pages``, three frames each with ``process_demand_requests`` after
    each: pages requested, tiles loaded, requests still open, resident
    pages, evictions and ms/frame. The first size must hold every tile
    (requests, then loads, then none open, none left by frame 3), the
    others must stay within their size while the LRU evicts. After the
    pages are in, a ``small_size`` frame on ``device`` against the CPU
    (every pixel within 1 LSB); the CLI with ``--demand-textures`` on an
    OBJ at ``cli_size``."""
    import tempfile

    import numpy as np
    import torch

    from fovpathtracing_optixcodelatest_tpu_torch.apps import main as cli
    from fovpathtracing_optixcodelatest_tpu_torch.config import RenderConfig
    from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
    from fovpathtracing_optixcodelatest_tpu_torch.models.demand import (
        DemandLoader,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
        gradient_sky_probe,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
        scene_arrays,
        scene_from_arrays,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        Renderer,
    )

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    meshes, cam, images = scenes.box_city_textured(n=city_n, seed=0)
    arrays = scene_arrays(meshes, gradient_sky_probe())

    def renderer(dev, max_pages, size, sched):
        loader = DemandLoader(max_pages=max_pages, device=dev)
        for img in images:
            loader.create_texture(img)
        scene = scene_from_arrays(arrays, dev, demand=loader.launch_prepare())
        r = Renderer(scene, RenderConfig(width=size[0], height=size[1]),
                     sched, device=dev, demand_loader=loader)
        r.set_camera(dataclasses.replace(cam, aspect=size[0] / size[1]))
        return r, loader

    out = {"runs": {}}
    for max_pages in pages:
        r, loader = renderer(device, max_pages, (width, height), schedule)
        rows = []
        for _ in range(3):
            kernel_build.reset_launches()
            sync()
            t0 = time.perf_counter()
            r.render()
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            launches = kernel_build.LAUNCHES.copy()
            loaded = loader.num_tiles_loaded
            req = r._stats["demand_requests"].cpu().numpy()
            requested = r.process_demand_requests()
            rows.append({
                "ms": ms, "requested": requested,
                "loaded": loader.num_tiles_loaded - loaded,
                "open": int((req & (loader.page_table < 0)).sum()),
                "resident": loader.resident_pages,
                "evicted": loader.num_tiles_evicted, "launches": launches,
                "traces": r.stats["traces"]})
            assert loader.resident_pages <= max_pages
        lin = r.linear_frame()
        assert np.isfinite(lin).all() and lin.mean() > 0
        out["runs"][max_pages] = {"total_pages": loader.total_pages,
                                  "frames": rows}
        if max_pages >= loader.total_pages:
            assert rows[0]["requested"] > 0
            assert all(x["loaded"] == x["requested"] and x["open"] == 0
                       for x in rows), rows
            assert rows[2]["requested"] == 0, rows
            if profile:
                root, ext = os.path.splitext(profile)
                _profile_frames(r, f"{root}_demand{ext}", results,
                                name="profile_demand")
        else:
            assert rows[-1]["evicted"] > 0, "the LRU never evicted"
        del r, loader

    # the card against the CPU after the pages are in: two frames page the
    # tiles in, then a fresh renderer renders subframe 0 again
    frames = {}
    for dev in (device, "cpu"):
        r, loader = renderer(dev, pages[0], small_size, small_schedule)
        for _ in range(2):
            r.render()
            r.process_demand_requests()
        fresh = Renderer(r.scene, r.config, small_schedule, device=dev,
                         demand_loader=loader)
        fresh.set_camera(dataclasses.replace(
            cam, aspect=small_size[0] / small_size[1]))
        frames[dev] = fresh.render()
        assert fresh.process_demand_requests() == 0, \
            "the small frame still requested pages"
    out["small_share"] = _share_within_1lsb(frames[device], frames["cpu"])
    assert out["small_share"] == 1.0, \
        f"demand frame on {device} vs CPU: {out['small_share']}"

    cw, ch = cli_size or (width, height)
    with tempfile.TemporaryDirectory() as tmp:
        png, tsv = os.path.join(tmp, "frame.png"), os.path.join(tmp, "run.tsv")
        argv = ["--device", device, "--obj", _write_textured_obj(tmp),
                "--width", str(cw), "--height", str(ch), "--frames", "2",
                "--schedule", cli_schedule, "--demand-textures",
                "--demand-pages", "4", "--out", png, "--tsv", tsv]
        kernel_build.reset_launches()
        rc = cli.main(argv)
        assert rc == 0, f"the demand CLI returned {rc}"
        sizes = {os.path.basename(f): os.path.getsize(f) for f in (png, tsv)}
        assert all(v > 0 for v in sizes.values()), sizes
        out["cli"] = {"argv": " ".join(argv).replace(tmp, "<tmp>"),
                      "files": sizes,
                      "launches": kernel_build.LAUNCHES.copy()}
    return out


STEREO_PAIRS = 4  # timed pairs of phase j, after one warm-up pair
IPD = 0.064  # metres between the eyes
# the sealed reference schedule: the viewer's 's' key cycles to it
SEALED = "32_16_8_sealed"
# what the sweep writes: a TSV a schedule and the two summaries
SWEEP_FILES = ("box_city_fov_32_2_1.tsv", "box_city_fov_32_4_2.tsv",
               "box_city_fov_32_8_4.tsv", "box_city_fov_32_16_8.tsv",
               "frame_rate.dat", "rendering_time.dat")


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _agreement(frame, ref, canvas=None, ref_canvas=None) -> dict:
    """Two uint8 frames (and their canvases): the share of pixels equal in
    every channel, the share within 1 LSB, the canvases' largest absolute
    difference."""
    import numpy as np

    frame, ref = np.asarray(frame), np.asarray(ref)
    out = {"equal": float((frame == ref).all(-1).mean()),
           "within_1lsb": _share_within_1lsb(frame, ref)}
    if canvas is not None:
        out["canvas_max_abs"] = float((canvas - ref_canvas).abs().max())
    return out


def _exact(agreement: dict) -> bool:
    return (agreement["equal"] == 1.0
            and agreement.get("canvas_max_abs", 0.0) == 0.0)


class _PairSource:
    """A stereo renderer as ``_profile_frames`` drives a renderer:
    ``render()`` renders one pair."""

    def __init__(self, sr, eyes):
        self.sr, self.eyes = sr, eyes

    def render(self):
        return self.sr.render(*self.eyes)


def stereo_phase(scene, config, schedule, camera, pairs: int, device="cuda",
                 profile=None, results=None) -> dict:
    """(j) ``StereoRenderer``: the eyes from ``eye_cameras_from_pose`` at
    ``camera``'s pose (IPD ``IPD``, converged at the lookat point), one
    warm-up pair, then ``pairs`` pairs timed on the host clock (each ends
    in the pair's copy to the host). Each eye of the warm-up pair (subframe
    0) must equal a mono ``render_frame`` with the same camera and key, bit
    for bit. ``profile`` adds ``FRAMES`` profiled pairs."""
    import numpy as np

    from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
    from fovpathtracing_optixcodelatest_tpu_torch.parallel.stereo import (
        StereoRenderer,
        eye_cameras_from_pose,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render import film
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        render_frame,
    )

    w, h = config.width, config.height
    eye, look = np.asarray(camera.eye), np.asarray(camera.lookat)
    fwd = look - eye
    eyes = eye_cameras_from_pose(
        camera.eye, fwd, up=camera.up, ipd=IPD, fov_y=camera.fov_y,
        aspect=w / h, focus_distance=float(np.linalg.norm(fwd)))
    sr = StereoRenderer(scene, config, schedule, device=device)
    keys = [sr.eye_key(e) for e in (0, 1)]
    first = sr.render(*eyes)  # the warm-up pair: subframe 0
    mono_equal = []
    for e, cam in enumerate(eyes):
        canvas = film.new_canvas(w, h, film.schedule_padding(schedule, w, h),
                                 device)
        _, frame, _ = render_frame(scene, cam.device_params(device), w // 2,
                                   h // 2, 0, canvas, keys[e], config,
                                   schedule)
        mono_equal.append(bool(np.array_equal(frame.cpu().numpy(),
                                              first[e])))
    _sync(device)
    kernel_build.reset_launches()
    pair_ms, traces, frames = [], [], [first]
    for _ in range(pairs):
        t0 = time.perf_counter()
        frames.append(sr.render(*eyes))  # a host array: the pair is done
        pair_ms.append((time.perf_counter() - t0) * 1e3)
        traces.append(sr.stats["traces"])
    launches = kernel_build.LAUNCHES.copy()
    out = {
        "pairs": frames, "pair_ms": pair_ms,
        "mean_ms": sum(pair_ms) / len(pair_ms), "traces": traces,
        "mrays": sum(traces) / (sum(pair_ms) / 1e3) / 1e6,
        "launches": launches,
        "launches_per_pair": {k: v / pairs for k, v in launches.items()},
        "mono_equal": mono_equal,
        "finite": all(bool(np.isfinite(c.cpu().numpy()).all())
                      for c in sr.canvases),
        "eyes": [[float(x) for x in c.eye] for c in eyes],
    }
    if profile:
        root, ext = os.path.splitext(profile)
        _profile_frames(_PairSource(sr, eyes), f"{root}_stereo{ext}",
                        results, name="profile_stereo")
    return out


def multidevice_phase(scene, config, schedule, camera, frames: int,
                      device="cuda") -> dict:
    """(k) The multi-device paths on one device: ``render_frame_sharded``
    over two ranks on it, ``render_frame_scene_sharded`` with ``tri_pack``
    padded and cut in two blocks, and ``Renderer(multichip="samples")`` on
    its default mesh; each path's subframe 0 against the single-device
    one's (frame and canvas), then ``frames`` more frames timed, with the
    launches of those frames."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import (
        fold_in,
        prng_key,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.parallel import (
        scene_shard,
        tiles,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render import film
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        Renderer,
        render_frame,
    )

    w, h = config.width, config.height
    gx, gy = w // 2, h // 2
    camp = camera.device_params(device)
    pad = film.schedule_padding(schedule, w, h)
    key = prng_key(0)  # the Renderer's: frame i keyed fold_in(key, i)
    two = tiles.make_mesh([device if device == "cpu" else "cuda:0"] * 2)
    ref_canvas = film.new_canvas(w, h, pad, device)
    ref_canvas, ref, _ = render_frame(scene, camp, gx, gy, 0, ref_canvas,
                                      fold_in(key, 0), config, schedule)
    padded = scene_shard.pad_scene_rows(scene, 2)
    paths = {
        "samples": (scene, tiles.replicate(scene, two)),
        "scene": (padded, scene_shard.shard_scene(padded, two)),
    }
    out = {"table_bytes": padded.tri_pack.numel() * 4,
           "block_bytes": [r.tri_pack.numel() * 4
                           for r in paths["scene"][1]]}
    for name, (sc, ranks) in paths.items():
        canvas = film.new_canvas(w, h, pad, device)

        def one(i, canvas=canvas, sc=sc, ranks=ranks):
            return tiles.render_frame_sharded(
                sc, camp, gx, gy, i, canvas, fold_in(key, i), config,
                schedule, two, rank_scenes=ranks)[1].cpu().numpy()

        agree = _agreement(one(0), ref.cpu().numpy(), canvas, ref_canvas)
        out[name] = dict(agree, **_timed(one, frames))
    r = Renderer(scene, config, schedule, device=device, multichip="samples")
    r.set_camera(camera)
    agree = _agreement(r.render(), ref.cpu().numpy(), r.canvas, ref_canvas)
    out["renderer"] = dict(agree, mesh=[str(d) for d in r.mesh],
                           **_timed(lambda i: r.render(), frames))
    return out


def _timed(fn, frames: int) -> dict:
    """``fn(i)`` for i = 1 .. frames, each ending on the host, timed on the
    host clock, with the launches of those frames."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build

    kernel_build.reset_launches()
    ms = []
    for i in range(1, frames + 1):
        t0 = time.perf_counter()
        fn(i)
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"frame_ms": ms, "mean_ms": sum(ms) / len(ms),
            "launches": kernel_build.LAUNCHES.copy()}


_MP_WORKER = r"""
import ast, json, sys, time
import numpy as np
sys.path.insert(0, sys.argv[1])
from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
from fovpathtracing_optixcodelatest_tpu_torch.parallel.multihost import (
    RenderJob, worker)
rank, port, device, out = int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
job = RenderJob(**ast.literal_eval(sys.argv[6]))
kernel_build.reset_launches()
t0 = time.perf_counter()
frame, traces = worker(rank, 2, f"tcp://127.0.0.1:{port}", device=device,
                       backend="gloo", job=job, timeout_s=float(sys.argv[7]))
np.savez(out, frame=frame, traces=traces, wall_s=time.perf_counter() - t0,
         launches=json.dumps(kernel_build.LAUNCHES))
"""


def multiprocess_phase(job, device="cuda", timeout_s: float = 600.0) -> dict:
    """(l) ``multihost.worker`` in two processes on one device, joined by
    gloo at a free port (NCCL refuses two ranks on one GPU), each with its
    own timeout: both ranks' frames, traces, wall times and kernel
    launches, and their agreement with ``reference_frame`` of the same job
    in this process."""
    import dataclasses
    import tempfile

    import numpy as np

    from fovpathtracing_optixcodelatest_tpu_torch.parallel import multihost

    root = os.path.dirname(os.path.abspath(__file__))
    dev = device if device == "cpu" else "cuda:0"
    spec = repr(dataclasses.asdict(job))
    port = str(_free_port())
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", _MP_WORKER, root, str(r), port, dev,
             outs[r], spec, str(timeout_s)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for r in range(2)]
        logs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=timeout_s)
                logs.append(err.decode()[-3000:])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        assert all(p.returncode == 0 for p in procs), logs
        ranks = [dict(np.load(o)) for o in outs]
    ref = multihost.reference_frame(job=job, device=device)
    return {
        "ranks_equal": bool(np.array_equal(ranks[0]["frame"],
                                           ranks[1]["frame"])),
        "traces": [int(r["traces"]) for r in ranks],
        "wall_s": [float(r["wall_s"]) for r in ranks],
        "launches": [json.loads(str(r["launches"])) for r in ranks],
        "vs_reference": _agreement(ranks[0]["frame"], ref),
        "frame": ranks[0]["frame"],
    }


def _viewer_client(port: int, width: int, height: int, swapped, seen: dict,
                   timeout_s: float, cycle_name: str = SEALED) -> None:
    """(m)'s browser: the page, two JPEGs off the stream and the stats;
    then, at full resolution, a gaze move, an orbit and a zoom (the
    accumulation must restart), the denoised view and the next schedule.
    What it saw goes into ``seen``; a failure into ``seen["error"]``."""
    import io
    import json
    import urllib.request

    from PIL import Image

    base = f"http://127.0.0.1:{port}"
    deadline = time.time() + timeout_s

    def get(path, timeout=30):
        return urllib.request.urlopen(base + path, timeout=timeout)

    def stats():
        s = json.loads(get("/stats").read())
        if not s.get("warmup", True):
            seen["render_ms"].append(s["render_ms"])
        return s

    def wait_for(cond, what):
        while time.time() < deadline:
            s = stats()
            if cond(s):
                return s
            time.sleep(0.05)
        raise TimeoutError(what)

    seen["render_ms"] = []
    try:
        while True:  # the server needs a beat to bind
            try:
                seen["page"] = b"/stream" in get("/").read()
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.2)
        stream = get("/stream", timeout=60)
        data = b""
        while data.count(b"\xff\xd9") < 2:
            chunk = stream.read1(65536)  # what has come, not 64 KiB
            if not chunk:
                break
            data += chunk
        stream.close()
        sizes, start = [], 0
        for _ in range(2):
            a = data.index(b"\xff\xd8", start)
            b = data.index(b"\xff\xd9", a) + 2
            sizes.append(Image.open(io.BytesIO(data[a:b])).size)
            start = b
        seen["jpeg_sizes"] = sizes
        if not swapped.wait(timeout=max(1.0, deadline - time.time())):
            raise TimeoutError("no swap to full resolution")
        before = wait_for(lambda s: not s["warmup"] and s["subframe"] >= 3,
                          "no full-resolution accumulation")
        seen["subframe_before"] = before["subframe"]
        gx, gy = width // 3, height // 3
        sent = stats()["frames"]  # frames rendered before the inputs
        for q in (f"gx={gx}&gy={gy}", "dx=30&dy=8", "zoom=1"):
            get(f"/input?{q}")
        # a restart at a frame rendered after the inputs were sent leaves
        # the subframe at most the frames rendered since; without one it
        # would exceed them by the subframe before (at least 3), however
        # fast the frames come
        after = wait_for(lambda s: s["gaze"] == [gx, height - 1 - gy]
                         and s["subframe"] <= s["frames"] - sent,
                         "the orbit did not restart the accumulation")
        seen["subframe_after"] = after["subframe"]
        seen["frames_since_input"] = after["frames"] - sent
        get("/input?view=denoised")
        wait_for(lambda s: s["view"] == "denoised", "no denoised view")
        get("/input?view=color")
        get("/input?sched=next")
        seen["final"] = wait_for(lambda s: s["schedule"] == cycle_name,
                                 "the schedule did not cycle")
    except Exception as e:  # noqa: BLE001 (reported by the phase)
        seen["error"] = repr(e)


def viewer_phase(scene, config, schedule, camera, device="cuda",
                 max_frames: int = 2000, timeout_s: float = 300.0,
                 cycle=None, warmup_scale: int = 4) -> dict:
    """(m) ``viewer.serve`` at ``config``'s size on a free port,
    progressive, with ``cycle`` = (name, schedule) to cycle to (default the
    sealed reference schedule), driven by a client thread
    (``_viewer_client``); every thread joined with a timeout. Returns what
    the client saw, the frames served, whether the loop swapped to full
    resolution, and the launches."""
    import threading

    from fovpathtracing_optixcodelatest_tpu_torch.apps import viewer
    from fovpathtracing_optixcodelatest_tpu_torch.config import (
        FoveationSchedule,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.camera import (
        Trackball,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import (
        Renderer,
    )

    if cycle is None:
        cycle = (SEALED, FoveationSchedule.reference_32_16_8_sealed())
    r = Renderer(scene, config, schedule, device=device)
    r.set_camera(camera)
    tb = Trackball(camera=camera)
    tb.reinitialize_from_camera()
    port = _free_port()
    swapped, stop = threading.Event(), threading.Event()
    got, seen = {}, {}
    kernel_build.reset_launches()
    t0 = time.perf_counter()
    server = threading.Thread(target=lambda: got.update(frames=viewer.serve(
        r, tb, port=port, max_frames=max_frames, progressive=True,
        warmup_scale=warmup_scale, stop_event=stop, on_swap=swapped.set, schedules=[cycle])))
    client = threading.Thread(target=_viewer_client, args=(
        port, config.width, config.height, swapped, seen, timeout_s,
        cycle[0]))
    server.start()
    client.start()
    client.join(timeout=timeout_s + 60)
    stop.set()
    server.join(timeout=timeout_s)
    alive = [n for n, t in (("client", client), ("server", server))
             if t.is_alive()]
    assert not alive, f"viewer threads still running: {alive}"
    return dict(seen, frames=got.get("frames"), swapped=swapped.is_set(),
                wall_s=time.perf_counter() - t0,
                launches=kernel_build.LAUNCHES.copy())


def sweep_phase(width: int, height: int, frames: int, device="cuda",
                extra=()) -> dict:
    """(n) ``benchmark_sweep.main`` in this process on box_city: the files
    it writes (a TSV a schedule, ``frame_rate.dat``,
    ``rendering_time.dat``) and each schedule's ms/frame, with the
    launches of the whole sweep."""
    import tempfile

    from fovpathtracing_optixcodelatest_tpu_torch.apps import benchmark_sweep
    from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--device", device, "--scene", "box_city", "--width",
                str(width), "--height", str(height), "--frames", str(frames),
                "--out-dir", tmp, *extra]
        kernel_build.reset_launches()
        rc = benchmark_sweep.main(argv)
        launches = kernel_build.LAUNCHES.copy()
        assert rc == 0, f"the sweep returned {rc}"
        files = {f: os.path.getsize(os.path.join(tmp, f))
                 for f in sorted(os.listdir(tmp))}
        with open(os.path.join(tmp, "rendering_time.dat")) as fh:
            names, values = (ln.split() for ln in fh.read().splitlines())
    return {"argv": " ".join(argv).replace(tmp, "<tmp>"), "files": files,
            "ms_per_frame": dict(zip(names, map(float, values))),
            "launches": launches}


# the BSDF image on the card against the CPU, relative to the image's
# largest value, on texels no sample marks in either; the sampled uv
# (measured on an H100: 3.9e-6 and 1.8e-7; the card's transcendentals
# round apart from the CPU's)
BSDF_RTOL = 2e-5


def bsdf_phase(device="cuda") -> dict:
    """(n) ``bsdf_test_image`` of a rough plastic and a glass on the card
    against the CPU: the image's largest difference off the marks relative
    to its largest value, the sampled uv's largest difference, and the
    texels marked in one image only."""
    import numpy as np

    from fovpathtracing_optixcodelatest_tpu_torch.models.material import (
        Material,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.utils.bsdf_viz import (
        bsdf_test_image,
    )

    out = {}
    for name, m in (("plastic", Material(color=(0.8, 0.3, 0.2),
                                         roughness=0.3, metallic=0.0,
                                         transmission=0.0)),
                    ("glass", Material(color=(0.9, 0.9, 0.9), roughness=0.6,
                                       metallic=0.2, transmission=0.7,
                                       eta=1.5, clearcoat=0.5))):
        a, auv = bsdf_test_image(m, device=device)
        b, buv = bsdf_test_image(m, device="cpu")
        red = np.array([1.0, 0.0, 0.0], np.float32)
        ma, mb = (a == red).all(-1), (b == red).all(-1)
        off = ~(ma | mb)
        out[name] = {
            "rel_err": float(np.abs(a - b)[off].max() / np.abs(b).max()),
            "uv_err": float(np.abs(auv - buv).max()),
            "marks": int(mb.sum()), "marks_differ": int((ma != mb).sum()),
        }
    return out


def gif_phase(pairs) -> dict:
    """(n) ``save_gif`` of stereo pairs (left | right, top row up), read
    back: frame count, size, and the first frame's mean difference from
    its source (GIF stores 256 colours a frame)."""
    import tempfile

    import numpy as np
    from PIL import Image

    from fovpathtracing_optixcodelatest_tpu_torch.utils.image import save_gif

    frames = [np.concatenate([p[0], p[1]], axis=1)[::-1] for p in pairs]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stereo.gif")
        save_gif(path, frames, fps=10.0)
        nbytes = os.path.getsize(path)
        with Image.open(path) as im:
            n, size = im.n_frames, im.size
            first = np.asarray(im.convert("RGB"), dtype=np.float64)
    return {"frames": n, "size": size, "bytes": nbytes,
            "mean_abs_lsb": float(np.abs(first - frames[0]).mean())}


# phase o: the legacy oracles on the card. The threaded walk against K1/K2
# on another tree of the scene: hit equal, the triangle on 99.9% of the
# hits (ties on shared edges, the bar of tests/test_traverse_packet.py),
# t within rtol 1e-5 on the same triangle, occlusion on 99.9% of the
# queried lanes (tests/test_bvh.py:108's bar against brute force). The
# packet walk against the threaded walk at rtol 1e-6, equal but on at most
# 0.1% of the lanes, where another ray of its packet leads it into a leaf
# the ray's own float32 slab test rejects by rounding (the reference's
# union walk, ROADMAP.md section 3): there brute force over every triangle
# must side with the packet walk, as it must with K1 where the threaded
# walk found a farther triangle. probe_sample_cdf on the card against the
# CPU within 1e-6 relative, the same texels.
LEGACY_TRI_SHARE = 0.999
LEGACY_OCC_SHARE = 0.999
LEGACY_T_RTOL = 1e-5
PACKET_T_RTOL = 1e-6
LEGACY_PACKET = 256
CDF_SAMPLES = 1 << 20
CDF_RTOL = 1e-6


def _walk(fn, device):
    """``fn()`` once -> (its result, its device time in ms from CUDA events
    around the call; None off the card)."""
    import torch

    if device != "cuda":
        return fn(), None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _hits_against(got: dict, ref: dict) -> dict:
    """A closest-hit answer against another walk's: lanes whose ``hit``
    differs; on the lanes both hit, the share with the same triangle; on
    those with the same triangle, t's largest relative and ulp gaps."""
    import torch

    both = got["hit"] & ref["hit"]
    same = both & (got["tri_id"] == ref["tri_id"])
    out = {"hits": int(ref["hit"].sum()),
           "hit_mismatches": int((got["hit"] != ref["hit"]).sum()),
           "tri_id_differ": int(both.sum() - same.sum()),
           "tri_id_share": float(same.sum()) / max(int(both.sum()), 1),
           "t_max_rel": 0.0, "t_max_ulp": 0}
    if same.any():
        gt, rt = got["t"][same], ref["t"][same]
        out.update(t_max_rel=float(((gt - rt).abs() / rt.abs()).max()),
                   t_max_ulp=int((gt.view(torch.int32).long()
                                  - rt.view(torch.int32).long()).abs().max()))
    return out


def _disagree(got: dict, ref: dict, rtol: float):
    """Lanes where two closest-hit answers disagree: ``hit`` differs, or
    both hit at t more than ``rtol`` apart (a tie on a shared edge, the
    same t on another triangle, agrees)."""
    both = got["hit"] & ref["hit"]
    return (got["hit"] != ref["hit"]) | (
        both & ((got["t"] - ref["t"]).abs() > rtol * ref["t"].abs()))


def _brute_lanes(scene, origin, direction, lanes, answers: dict,
                 tmin: float, tmax: float, cap: int = 16) -> list:
    """Each of the first ``cap`` ``lanes`` with every walk's answer there
    (``answers``: name -> closest-hit dict, or occlusion bool tensor), the
    brute-force answer over every triangle of ``scene`` ("brute": (tri_id,
    t) or bool) and its ray as float32 bit patterns."""
    import torch

    from fovpathtracing_optixcodelatest_tpu_torch.ops import intersect

    lanes = lanes[:cap]
    if not lanes.numel():
        return []
    tp = scene.tri_pack
    tris = (tp[:, 36:39], tp[:, 39:42], tp[:, 42:45])
    ro, rd = origin[lanes], direction[lanes]
    occlusion = isinstance(next(iter(answers.values())), torch.Tensor)
    if occlusion:
        bf = intersect.brute_force_occluded(*tris, ro, rd, tmin, tmax)
        pick = lambda a, i: bool(a[i])  # noqa: E731
        brute = [bool(x) for x in bf]
    else:
        bf = intersect.brute_force_closest_hit(*tris, ro, rd, tmin, tmax)
        pick = lambda a, i: (int(a["tri_id"][i]), float(a["t"][i]))  # noqa
        brute = [(int(i), float(t)) for i, t in zip(bf["tri_id"], bf["t"])]
    bits = lambda x: x.contiguous().view(torch.int32).tolist()  # noqa: E731
    return [dict({k: pick(a, lane) for k, a in answers.items()},
                 lane=lane, brute=brute[i], origin_bits=bits(ro[i]),
                 direction_bits=bits(rd[i]))
            for i, lane in enumerate(lanes.tolist())]


def _sides_with(record: dict, name: str) -> bool:
    """Whether the answer ``name`` of a ``_brute_lanes`` record is the
    brute-force answer (for a closest hit: the same t)."""
    got, brute = record[name], record["brute"]
    return got == brute if isinstance(got, bool) else got[1] == brute[1]


def legacy_phase(rays: dict, tris, device="cuda") -> dict:
    """(o) The legacy oracles on the card, on ``rays`` (``kernel_times``'
    bench rays) of the scene whose host triangles are ``tris``: the
    threaded BVH built on the host and moved to the card; the threaded
    walk (``ops/traverse_threaded.py``) against K1 on the primary and
    continuation lanes and against K2 on the shadow lanes, and the packet
    walk (``ops/traverse_packet.py``, ``LEGACY_PACKET`` rays a packet)
    against the threaded walk, each walk timed once; K1 and K2 on the
    (16, 6) table of the pure-Python builder (``bvh8.build``) and K3 on its
    legacy table (``bvh8.build_legacy8``) against their plain versions
    (exact), K1/K2 on the native table and K2 on the queried lanes;
    ``torch.argmin``'s tie order; ``probe_sample_cdf`` on the card against
    the CPU."""
    import torch

    from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
        gradient_sky_probe,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops import (
        bvh,
        bvh8,
        bvh_native,
        kernel_build,
        packet_traverse,
        probe_sampling,
        traverse,
        traverse_packet,
        traverse_threaded,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.tools import kernel_times

    t_phase = time.perf_counter()
    b, config = rays["scene"].bvh, rays["config"]
    tmin, tmax = config.tmin, config.tmax
    kargs = (tmin, tmax, *b.walk_args)
    out = {"triangles": int(tris.shape[0])}
    t0 = time.perf_counter()
    tb = bvh.build(tris)
    out["threaded_build_s"] = time.perf_counter() - t0
    tbd = tb.to(device)
    t0 = time.perf_counter()
    py = bvh8.build(tris)
    out["python_wide_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = bvh_native.build(tris)
    out["native_wide_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    py8 = bvh8.build_legacy8(tris)
    out["python_legacy_s"] = time.perf_counter() - t0
    out.update(nodes=tb.num_nodes, python_rows=py.num_rows,
               python_legacy_rows=py8.num_rows, native_rows=nat.num_rows)
    assert _bits_equal(nat.table, b.table), \
        "the triangles are not the scene's"
    assert not _bits_equal(py.table, nat.table), \
        "the Python and native builders gave the same table"

    # the threaded and packet walks against K1
    o, d, act, _ = rays["primary"]
    k1_native = None
    for name, (ro, rd, ra) in (("primary", (o, d, act)),
                               ("continuation", rays["continuation"])):
        k1 = traverse.closest_hit(b.table, ro, rd, ra, *kargs)
        tw, tw_ms = _walk(lambda: traverse_threaded.closest_hit(
            tbd, ro, rd, tmin, tmax, active=ra), device)
        pw, pw_ms = _walk(lambda: traverse_packet.closest_hit(
            tbd, ro, rd, tmin, tmax, active=ra, packet_size=LEGACY_PACKET),
            device)
        vs_k1, vs_thr = _hits_against(tw, k1), _hits_against(pw, tw)
        scene = rays["scene"]
        for v, got, ref, right in ((vs_k1, tw, k1, "k1"),
                                   (vs_thr, pw, tw, "packet")):
            lanes = torch.nonzero(_disagree(got, ref, LEGACY_T_RTOL)
                                  ).squeeze(1)
            v["disagree"] = lanes.numel()
            v["lanes"] = _brute_lanes(
                scene, ro, rd, lanes, {"k1": k1, "walk": tw, "packet": pw},
                tmin, tmax)
            assert lanes.numel() <= (1 - LEGACY_TRI_SHARE) * v["hits"] \
                and all(_sides_with(x, right) for x in v["lanes"]), \
                f"brute force does not side with {right} ({name} lanes): {v}"
        out[name] = {"lanes": ro.shape[0], "active": int(ra.sum()),
                     "steps": tw["steps"], "packet_steps": pw["steps"],
                     "threaded_ms": tw_ms, "packet_ms": pw_ms,
                     "vs_k1": vs_k1, "packet_vs_threaded": vs_thr}
        assert vs_k1["hit_mismatches"] == 0 and \
            vs_k1["tri_id_share"] >= LEGACY_TRI_SHARE and \
            vs_k1["t_max_rel"] <= LEGACY_T_RTOL, \
            f"the threaded walk disagrees with K1 ({name} lanes): {vs_k1}"
        assert vs_thr["tri_id_share"] >= LEGACY_TRI_SHARE and \
            vs_thr["t_max_rel"] <= PACKET_T_RTOL, \
            f"the packet walk disagrees with the threaded walk ({name} " \
            f"lanes): {vs_thr}"
        if name == "primary":
            k1_native = k1
        del k1, tw, pw

    # ... and against K2 on the shadow lanes
    so, sd, sq = rays["shadow"]
    ns, nq = so.shape[0], int(sq.sum())
    k2_native = traverse.occluded(b.table, so, sd, sq, *kargs)
    tocc, to_ms = _walk(lambda: traverse_threaded.occluded(
        tbd, so, sd, tmin, tmax, active=sq), device)
    pocc, po_ms = _walk(lambda: traverse_packet.occluded(
        tbd, so, sd, tmin, tmax, active=sq, packet_size=LEGACY_PACKET),
        device)
    differ = torch.nonzero(tocc != k2_native).squeeze(1)
    pdiffer = torch.nonzero(pocc != tocc).squeeze(1)
    answers = {"k2": k2_native, "walk": tocc, "packet": pocc}
    sh = out["shadow"] = {
        "lanes": ns, "queried": nq, "occluded": int(tocc.sum()),
        "differ": differ.numel(),
        "differ_lanes": _brute_lanes(rays["scene"], so, sd, differ, answers,
                                     tmin, tmax),
        "share_equal": 1.0 - differ.numel() / max(nq, 1),
        "packet_differ": pdiffer.numel(),
        "packet_differ_lanes": _brute_lanes(rays["scene"], so, sd, pdiffer,
                                            answers, tmin, tmax),
        "threaded_ms": to_ms, "packet_ms": po_ms}
    assert sh["share_equal"] >= LEGACY_OCC_SHARE, \
        f"the threaded walk disagrees with K2: {sh}"
    assert pdiffer.numel() <= (1 - LEGACY_OCC_SHARE) * nq and all(
        _sides_with(x, "packet") for x in sh["packet_differ_lanes"]), \
        f"the packet occlusion walk disagrees with the threaded walk: {sh}"
    del tocc, pocc

    # K1 and K2 on the Python (16, 6) table, K3 on the Python legacy table
    pt = torch.tensor(py.table, device=device)
    lt = torch.tensor(py8.table, device=device)
    pargs = (tmin, tmax, py.stack_depth, py.arity, py.leaf_size)
    largs = (tmin, tmax, py8.stack_depth, py8.leaf_size)
    calls = {
        "k1_primary": lambda: traverse.closest_hit(pt, o, d, act, *pargs),
        "k2_shadow": lambda: traverse.occluded(pt, so, sd, sq, *pargs),
        "k3_shadow": lambda: packet_traverse.occluded_packets(lt, so, sd, sq,
                                                              *largs),
    }
    kernel_build.reset_launches()
    k1p, k2p, k3p = (calls[k]() for k in calls)
    if device == "cuda":
        torch.cuda.synchronize()
    out["launches"] = kernel_build.LAUNCHES.copy()
    st1, st2, st3 = {}, {}, {}
    p1, p1_ms = _plain_ms(lambda: traverse.closest_hit_plain(
        pt, o, d, act, *pargs, stats=st1))
    p2, p2_ms = _plain_ms(lambda: traverse.occluded_plain(
        pt, so, sd, sq, *pargs, stats=st2))
    p3, p3_ms = _plain_ms(lambda: packet_traverse.occluded_packets_plain(
        lt, so, sd, sq, *largs, stats=st3))
    hit_eq, tri_eq, ulp, err1 = _k1_agreement(k1p, p1)
    mism2, mism3 = int((k2p != p2).sum()), int((k3p != p3).sum())
    vs_native1 = _hits_against(k1p, k1_native)
    mism2n = int((k2p != k2_native).sum())
    mism3k2 = int((k3p != k2_native)[sq].sum())
    assert hit_eq and tri_eq and ulp == 0, \
        "K1 disagrees with its plain version on the Python table"
    assert mism2 == 0, "K2 disagrees with its plain version on the Python table"
    assert mism3 == 0, \
        "K3 disagrees with its plain version on the Python legacy table"
    assert vs_native1["hit_mismatches"] == 0 and \
        vs_native1["tri_id_share"] >= LEGACY_TRI_SHARE, \
        f"K1 on the Python table disagrees with the native table's: " \
        f"{vs_native1}"
    assert mism2n == 0, "K2 on the Python table disagrees with the native's"
    assert mism3k2 == 0, "K3 on the Python legacy table disagrees with K2"
    times = (kernel_times.time_kernels(calls) if device == "cuda"
             else dict.fromkeys(calls))
    n, n_act = o.shape[0], int(act.sum())

    def record(call, st, plain_ms, table, lanes, queried, out_bytes, err,
               **extra):
        bound, by, _ = _bound(st, table, lanes, queried, out_bytes)
        return dict(extra, lanes=lanes, ms=times[call], plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, max_abs_err=err, work=st)

    out["python_table"] = {
        "k1": record("k1_primary", st1, p1_ms, pt, n, n_act, 16, err1,
                     vs_native=vs_native1),
        "k2": record("k2_shadow", st2, p2_ms, pt, ns, nq, 1,
                     float(min(mism2, 1)), native_mismatches=mism2n),
        "k3": record("k3_shadow", st3, p3_ms, lt, ns, nq, 1,
                     float(min(mism3, 1)), k2_mismatches=mism3k2),
    }
    del k1p, k2p, k3p, p1, p2, p3, k1_native, k2_native

    # torch.argmin takes the first of equal minima on the device too (the
    # leaf tests' tie order), all-inf rows included
    inf = float("inf")
    tie = torch.tensor([[2.0, 1.0, 1.0, 3.0], [inf, inf, inf, inf],
                        [0.5, 0.5, 0.5, 0.5], [inf, 4.0, inf, 4.0]],
                       device=device).repeat(1 << 18, 1)
    out["argmin_first"] = bool(torch.equal(
        torch.argmin(tie, dim=1).cpu(),
        torch.tensor([1, 0, 0, 1]).repeat(1 << 18)))
    assert out["argmin_first"], "torch.argmin broke a tie otherwise"

    # the reference's CDF inversion on the card against the CPU
    probe = gradient_sky_probe()
    r = torch.rand((2, CDF_SAMPLES), generator=torch.Generator().manual_seed(0))
    ref = probe_sampling.probe_sample_cdf(probe, r[0], r[1])
    got = probe_sampling.probe_sample_cdf(probe, r[0].to(device),
                                          r[1].to(device))
    texels = [torch.stack(probe_sampling.cdf_texel(probe, u1, u2)).cpu()
              for u1, u2 in ((r[0], r[1]), (r[0].to(device), r[1].to(device)))]
    gd, gc, gp = (x.cpu() for x in got)
    pdf_ok = ref[2] > 0
    out["cdf"] = {
        "samples": CDF_SAMPLES,
        "texel_mismatches": int((texels[0] != texels[1]).any(0).sum()),
        "color_mismatches": int((gc != ref[1]).any(-1).sum()),
        "dir_max_err": float((gd - ref[0]).abs().max()),
        "pdf_max_rel": float(((gp - ref[2]).abs()[pdf_ok]
                              / ref[2][pdf_ok]).max()),
        "pdf_zero_mismatches": int(((gp > 0) != pdf_ok).sum())}
    c = out["cdf"]
    assert c["texel_mismatches"] == c["color_mismatches"] == \
        c["pdf_zero_mismatches"] == 0, f"probe_sample_cdf texels: {c}"
    assert c["dir_max_err"] <= CDF_RTOL and c["pdf_max_rel"] <= CDF_RTOL, \
        f"probe_sample_cdf on the card disagrees with the CPU: {c}"
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _bits_equal(a, b) -> bool:
    """Two float32 tables (numpy or tensors) equal bit for bit."""
    import numpy as np

    a = np.ascontiguousarray(a.cpu().numpy() if hasattr(a, "cpu") else a)
    b = np.ascontiguousarray(b.cpu().numpy() if hasattr(b, "cpu") else b)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


def _python_record(lg: dict, k: str, kernel: str) -> dict:
    """The kernels line's record of K1, K2 or K3 on phase o's Python-built
    table, with its launches in phase o."""
    r = lg["python_table"][k]
    return {"lanes": r["lanes"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "launches": lg["launches"][kernel],
            "max_abs_err": r["max_abs_err"]}


def _legacy_lines(lg: dict, times: dict) -> None:
    _line(f"legacy oracles (phase o): {lg['triangles']} tris; threaded BVH "
          f"{lg['nodes']} nodes, host build {lg['threaded_build_s']:.3f} s; "
          f"wide (6, 16) builds: Python {lg['python_wide_s']:.3f} s "
          f"({lg['python_rows']} rows), native {lg['native_wide_s']:.3f} s "
          f"({lg['native_rows']} rows); Python legacy8 "
          f"{lg['python_legacy_s']:.3f} s ({lg['python_legacy_rows']} rows)")
    ms = lambda x: "not timed" if x is None else f"{x:.1f} ms"  # noqa: E731

    def lanes(v: dict) -> str:
        return (f"{v['disagree']} lanes disagree"
                + "".join(f"; lane {x['lane']}: K1 {x['k1']}, walk "
                          f"{x['walk']}, packet {x['packet']}, brute force "
                          f"{x['brute']}" for x in v["lanes"]))

    for name, k1 in (("primary", "k1_primary"),
                     ("continuation", "k1_continuation")):
        r = lg[name]
        v, p = r["vs_k1"], r["packet_vs_threaded"]
        _line(f"threaded closest_hit on the {r['lanes']} {name} lanes "
              f"({r['active']} active): {r['steps']} steps, "
              f"{ms(r['threaded_ms'])} (K1 {times.get(k1, 0):.4f} ms); vs "
              f"K1: {v['hit_mismatches']} hit mismatches of {v['hits']} "
              f"hits, tri_id share {v['tri_id_share']:.7f}, t max "
              f"{v['t_max_ulp']} ulp ({v['t_max_rel']:.3g} rel) on the same "
              f"triangle, {lanes(v)}")
        _line(f"packet closest_hit ({LEGACY_PACKET} rays) on the {name} "
              f"lanes: {r['packet_steps']} steps, {ms(r['packet_ms'])}; vs "
              f"threaded: {p['hit_mismatches']} hit mismatches, tri_id share "
              f"{p['tri_id_share']:.7f}, t max {p['t_max_ulp']} ulp on the "
              f"same triangle, {lanes(p)}")
    s = lg["shadow"]
    occ = lambda rs: "".join(  # noqa: E731
        f"; lane {x['lane']}: K2 {x['k2']}, walk {x['walk']}, packet "
        f"{x['packet']}, brute force {x['brute']}" for x in rs)
    _line(f"threaded occluded on the {s['lanes']} shadow lanes "
          f"({s['queried']} queried, {s['occluded']} occluded): "
          f"{ms(s['threaded_ms'])} (K2 {times.get('k2_shadow', 0):.4f} ms); "
          f"{s['differ']} lanes differ from K2 (share equal "
          f"{s['share_equal']:.7f}){occ(s['differ_lanes'])}")
    _line(f"packet occluded ({LEGACY_PACKET} rays): {ms(s['packet_ms'])}; "
          f"{s['packet_differ']} lanes differ from the threaded walk"
          f"{occ(s['packet_differ_lanes'])}")
    for k, title in (("k1", "K1 closest_hit"), ("k2", "K2 occluded"),
                     ("k3", "K3 occluded_packets")):
        r = lg["python_table"][k]
        timed = "not timed" if r["ms"] is None else f"{r['ms']:.4f} ms"
        extra = {x: r[x] for x in r if x in (
            "vs_native", "native_mismatches", "k2_mismatches")}
        _line(f"{title} on the Python-built table, {r['lanes']} lanes: exact "
              f"vs plain; {timed}; plain {r['plain_ms']:.1f} ms; bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}); {extra}")
    c = lg["cdf"]
    _line(f"probe_sample_cdf, {c['samples']} samples, card vs CPU: "
          f"{c['texel_mismatches']} texels differ, directions within "
          f"{c['dir_max_err']:.3g}, pdfs within {c['pdf_max_rel']:.3g} "
          f"relative; argmin first-of-ties {lg['argmin_first']}; phase o "
          f"{lg['phase_s']:.1f} s; launches {lg['launches']}")


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
    from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
        host_triangles,
    )
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
    from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import Renderer
    from fovpathtracing_optixcodelatest_tpu_torch.tools import kernel_times

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

    # -- phase 3: scene and the first bounce's rays ---------------------------
    w, h = 960, 540
    rays = kernel_times.bench_rays("cuda", width=w, height=h)
    scene, config = rays["scene"], rays["config"]
    schedule, camera = rays["schedule"], rays["camera"]
    bvh, leg = scene.bvh, scene.legacy
    _line(f"scene: {scene.num_triangles} tris; packed {bvh.num_rows} rows x "
          f"{bvh.table.shape[1]} cols, stack_depth {bvh.stack_depth}; legacy8 "
          f"{leg.num_rows} rows x {leg.table.shape[1]} cols, stack_depth "
          f"{leg.stack_depth}; host build {rays['scene_s']:.1f} s")
    assert scene.num_triangles == 24 * 24 * 12 + 12
    o, d, act, _ = rays["primary"]
    n = o.shape[0]
    assert n == kernel_times.PRIMARY_LANES, n
    tmin, tmax = config.tmin, config.tmax
    kargs = (tmin, tmax, bvh.stack_depth, bvh.arity, bvh.leaf_size)
    calls = kernel_times.kernel_calls(rays)

    # -- phase 4: K1 / K2 / K3 against their plain versions on primary rays --
    k1 = calls["k1_primary"]()
    st1 = {}
    p1, p1_ms = _plain_ms(lambda: traverse.closest_hit_plain(
        bvh.table, o, d, act, *kargs, stats=st1))
    hit_eq, tri_eq, ulp, err1 = _k1_agreement(k1, p1)
    n_act = int(act.sum().item())
    _line(f"K1 closest_hit: {n} lanes ({n_act} active, "
          f"{int(p1['hit'].sum())} hits); plain {p1_ms:.1f} ms; hit equal "
          f"{hit_eq}, tri_id equal {tri_eq}, t/u/v max {ulp} ulp; work "
          f"{st1}")
    assert hit_eq and tri_eq and ulp == 0, "K1 disagrees with its plain version"

    k2p = traverse.occluded(bvh.table, o, d, act, *kargs)
    p2p = traverse.occluded_plain(bvh.table, o, d, act, *kargs)
    mism2p = int((k2p != p2p).sum().item())
    _line(f"K2 occluded on primary rays: {mism2p} mismatches of {n}")
    assert mism2p == 0, "K2 disagrees with its plain version (primary rays)"

    lt = leg.table
    largs = (tmin, tmax, leg.stack_depth, leg.leaf_size)
    k3p = packet_traverse.occluded_packets(lt, o, d, act, *largs)
    p3p = packet_traverse.occluded_packets_plain(lt, o, d, act, *largs)
    mism3p = int((k3p != p3p).sum().item())
    # K2 and K3 walk different trees, so a grazing ray may fall differently
    # in the two: reported, not required
    diff32p = int((k3p != k2p).sum().item())
    _line(f"K3 occluded_packets on primary rays: {mism3p} mismatches of {n}; "
          f"{diff32p} answers differ from K2's")
    assert mism3p == 0, "K3 disagrees with its plain version (primary rays)"

    # -- phase 5: bounce-0 shadow rays; the packet-occlusion path (K3) -------
    so, sd, sq = rays["shadow"]
    ns, nq = so.shape[0], int(sq.sum().item())
    kernel_build.reset_launches()
    fetched3 = {}
    k3 = packet_traverse.occluded_packets(lt, so, sd, sq, *largs,
                                          fetched=fetched3)
    torch.cuda.synchronize()
    k3_launches = kernel_build.LAUNCHES["occluded_packets"]
    assert k3_launches >= 1, "the packet path did not launch K3"
    st3 = {}
    p3, p3_ms = _plain_ms(lambda: packet_traverse.occluded_packets_plain(
        lt, so, sd, sq, *largs, stats=st3))
    k2 = calls["k2_shadow"]()
    st2 = {}
    p2, p2_ms = _plain_ms(lambda: traverse.occluded_plain(
        bvh.table, so, sd, sq, *kargs, stats=st2))
    mism3, mism32 = int((k3 != p3).sum().item()), int((k3 != k2).sum().item())
    mism2 = int((k2 != p2).sum().item())
    # a boolean answer's largest absolute error is 1 if any ray disagrees
    err2, err3 = float(min(mism2, 1)), float(min(mism3, 1))
    _line(f"shadow rays (bounce 0): {ns} lanes, {nq} queried, "
          f"{int(k2.sum())} occluded")
    _line(f"K2 occluded: plain {p2_ms:.1f} ms, {mism2} mismatches; work "
          f"{st2}")
    _line(f"K3 occluded_packets: plain {p3_ms:.1f} ms, {mism3} mismatches vs "
          f"plain, {mism32} vs K2; work {st3}; K3's own walk {fetched3}; "
          f"path launches {k3_launches}")
    assert mism2 == 0, "K2 disagrees with its plain version (shadow rays)"
    assert mism3 == 0, "K3 disagrees with its plain version"
    assert mism32 == 0, "K3 disagrees with K2 on the same rays"
    check_launches = kernel_build.LAUNCHES.copy()  # of this phase's checks
    del p1, p2, p3, p2p, k2p, p3p, k3p

    # K1 again on bounce 0's continuation rays: incoherent, off-camera, the
    # shape of three of its four launches a frame
    bo, bd, bact = rays["continuation"]
    k1b = calls["k1_continuation"]()
    st1b = {}
    p1b, p1b_ms = _plain_ms(lambda: traverse.closest_hit_plain(
        bvh.table, bo, bd, bact, *kargs, stats=st1b))
    hit_eq_b, tri_eq_b, ulp_b, err1b = _k1_agreement(k1b, p1b)
    err1 = max(err1, err1b)
    _line(f"K1 closest_hit on bounce-0 continuation rays: {bo.shape[0]} "
          f"lanes, {int(p1b['hit'].sum())} hits; plain {p1b_ms:.1f} ms; hit "
          f"equal {hit_eq_b}, tri_id equal {tri_eq_b}, t/u/v max {ulp_b} "
          f"ulp; work {st1b}")
    assert hit_eq_b and tri_eq_b and ulp_b == 0, \
        "K1 disagrees with its plain version (bounce-0 continuation rays)"
    del p1b, k1, k1b

    times = kernel_times.time_kernels(calls)
    _line(f"kernel times (CUDA events, {kernel_times.REPS} launches each): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()))

    # -- phase 6: the main path ----------------------------------------------
    renderer = Renderer(scene, config, schedule, device="cuda")
    renderer.set_camera(camera)
    main_path = timed_frames(renderer, FRAMES)
    frame, frame_ms = main_path["frame"], main_path["frame_ms"]
    traces, launches = main_path["traces"], main_path["launches"]
    peak, mrays = main_path["peak"], main_path["mrays"]
    _line(_frames_line(f"main path: {FRAMES} frames {w}x{h} after 1 warm-up",
                       main_path))
    assert frame.shape == (h, w, 3) and main_path["finite"]
    assert 0 < frame.mean() < 255
    for k in PATH_KERNELS:
        assert launches[k] > 0, f"main path never launched {k}"
    # every bounce shaded by the two shading kernels, one launch each
    assert launches["shade"] == launches["resolve"] == launches[
        "closest_hit"] > 0, launches
    # one wavefront a mono frame: its rays in one raygen launch, its
    # composite and tone map in one film launch; its lane lists on the card,
    # one compaction a bounce but the last and one of ray generation's mask
    assert launches["raygen"] == launches["film"] == FRAMES, launches
    assert launches["compact"] == FRAMES * config.max_depth, launches

    # -- phase 6b: the bounce's shading kernels against the plain bounce -------
    results["shade"] = shade_phase(scene, config, rays)
    for depth in (0, 1):
        r = results["shade"][f"depth{depth}"]
        _line(f"shade/resolve against the plain bounce at depth {depth}: "
              f"{r['lanes']} lanes, {r['hits']} hits, {r['queries']} "
              f"queried; {json.dumps(r)}")
    _line(f"shade kernels: shade {results['shade']['shade_ms']:.4f} ms, "
          f"resolve {results['shade']['resolve_ms']:.4f} ms at bounce 0's "
          f"lanes; {json.dumps(results['shade']['resources'])}")
    assert results["shade"]["exact"], \
        "the shading kernels disagree with the plain bounce"

    # -- phase 6c: the frame's raygen and film kernels against their plain
    # versions ----------------------------------------------------------------
    fr = results["frame_kernels"] = frame_phase(scene, config, rays)
    _line(f"raygen/film against their plain versions at {w}x{h}: "
          f"{json.dumps({k: v for k, v in fr.items() if k != 'resources'})}; "
          f"{json.dumps(fr['resources'])}")
    assert fr["exact"], \
        "the frame's raygen or film kernel disagrees with its plain version"

    # -- phase 6d: the lane lists on the card --------------------------------
    lc = results["lanes"] = lanes_phase(scene, config, rays)
    _line(f"compaction against nonzero/idx[alive] and the gathers: "
          f"{json.dumps(lc['compaction'])}")
    _line(f"kernel path against host lane lists: {json.dumps(lc['paths'])}")
    assert lc["compaction"]["exact"], \
        "the compaction disagrees with nonzero / idx[alive]"
    assert lc["paths"]["exact"], \
        "the kernel path's lane lists change the wavefront, or it waits"

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
    share = min(_share_within_1lsb(a, b)
                for a, b in zip(frames["cuda"], frames["cpu"]))
    _line(f"small frame {sw}x{sh}, 2 subframes: GPU vs CPU pixels within "
          f"1 LSB {share:.4f}")
    assert share >= 0.99, "GPU frame disagrees with the CPU reference"

    # -- phase a: the textured bench frame (same geometry, 8 textures) -------
    tex = textured_phase(scene, 24, schedule, w, h, FRAMES)
    _line(f"textured bench frame: box_city_textured n=24, {tex['triangles']} "
          f"tris, textures {tex['textures']} ({tex['texel_bytes'] / 1e6:.1f} "
          f"MB of texels); texture sampler on the card vs CPU on "
          f"{tex['sampler_hits']} bounce-0 hits: max abs err "
          f"{tex['sampler_err']:.3g}; subframe 0 differs from the untextured "
          f"frame on {tex['differing_pixels']} of {tex['geometry_pixels']} "
          f"geometry pixels, {tex['differing_off_geometry']} elsewhere")
    _line(_frames_line(f"textured: {FRAMES} frames {w}x{h} after 1 warm-up",
                       tex))
    # the untextured frame again, so the host's drift shows beside the
    # textured frames: untextured, textured, untextured in one run
    again = timed_frames(renderer, FRAMES, warm_up=False)
    _line(f"untextured (phase 6, this run): mean {main_path['mean_ms']:.1f} "
          f"ms/frame, {mrays:.2f} Mrays/s, peak {peak / 2**30:.2f} GiB, "
          f"launches {launches}")
    _line(_frames_line("untextured again, after the textured frames", again))
    for k in PATH_KERNELS:
        assert tex["launches"][k] > 0, f"the textured frame never launched {k}"
    tex_renderer = tex.pop("renderer")
    if args.profile:
        root, ext = os.path.splitext(args.profile)
        _profile_frames(tex_renderer, f"{root}_textured{ext}", results,
                        name="profile_textured")
    del tex_renderer

    # -- phase b: a 4096x2048 probe, sampled through the alias arrays --------
    big = large_probe_phase(renderer, 4096, 2048, 2)
    _line(f"large probe 4096x2048 ({big['texel_bytes'] / 1e6:.1f} MB of "
          f"texels, host build {big['host_build_s']:.1f} s): "
          + _frames_line("bench scene, 2 frames", big))
    for k in PATH_KERNELS:
        assert big["launches"][k] > 0, f"the large-probe frame never launched {k}"

    # -- phase c: textured catcher frame and AOVs, GPU against the CPU -------
    kernel_build.reset_launches()
    cat = catcher_phase(sw, sh, small_sched)
    cat_launches = kernel_build.LAUNCHES.copy()
    _line(f"catcher cornell {sw}x{sh}, 2 subframes through render_aov: GPU vs "
          f"CPU pixels within 1 LSB {cat['share']:.4f}; AOV and denoise max "
          f"error relative to the CPU image's largest value "
          + ", ".join(f"{k} {v:.3g}" for k, v in cat["rel_err"].items())
          + f" (limit {AOV_RTOL:g}); traces {cat['traces']}; launches "
          f"{cat_launches}")
    for k in PATH_KERNELS:
        assert cat_launches[k] > 0, f"the catcher frame never launched {k}"

    # -- phase d: the CLI ---------------------------------------------------
    kernel_build.reset_launches()
    cli = cli_phase(w, h, "32_16_8")
    cli_launches = kernel_build.LAUNCHES.copy()
    _line(f"CLI: {cli['argv']} -> 0 in {cli['wall_s']:.1f} s; TSV render ms/"
          "frame " + ", ".join(f"{x:.1f}" for x in cli["render_ms"])
          + f"; files {cli['files']}; launches {cli_launches}")
    for k in PATH_KERNELS:
        assert cli_launches[k] > 0, f"the CLI never launched {k}"

    # -- phase e: render-time instancing (two-level table) ------------------
    inst = instanced_phase(schedule, w, h, FRAMES, profile=args.profile,
                           results=results)
    inst_launches = inst["launches"]  # of its timed frames only
    ik1, ik2 = inst["k1"], inst["k2"]
    _line(f"instanced: {inst['instances']} instances of one 320-tri sphere "
          f"({inst['world_triangles']} world tris); table {inst['rows']} rows "
          f"(instances [{inst['inst_base']}, {inst['blas_base']})), "
          f"stack_depth {inst['stack_depth']}, {inst['table_bytes'] / 1e6:.3f} "
          f"MB + tri_pack {inst['tri_pack_bytes'] / 1e6:.3f} MB against the "
          f"flattened {inst['flat_table_bytes'] / 1e6:.1f} MB + "
          f"{inst['flat_tri_pack_bytes'] / 1e6:.1f} MB; host build "
          f"{inst['host_build_s']:.2f} s (flattened "
          f"{inst['flat_host_build_s']:.2f} s)")
    _line(f"instanced K1 on {ik1['lanes']} primary lanes ({ik1['hits']} hits):"
          f" mismatched lanes {ik1['mismatches']}; {ik1['ms']:.4f} "
          f"ms (plain {ik1['plain_ms']:.1f}; K1 on the flattened table "
          f"{ik1['flat_ms']:.4f}); work {ik1['work']}")
    _line(f"instanced K2 on {ik2['lanes']} shadow lanes ({ik2['queried']} "
          f"queried, {ik2['occluded']} occluded): {ik2['mismatches']} "
          f"mismatches; {ik2['ms']:.4f} ms (plain {ik2['plain_ms']:.1f}; K2 "
          f"on the flattened table {ik2['flat_ms']:.4f}); work "
          f"{ik2['work']}")
    _line(f"instanced vs flattened subframe 0: mean radiance "
          f"{[round(x, 5) for x in inst['mean_radiance']]} vs "
          f"{[round(x, 5) for x in inst['flat_mean_radiance']]}, pixels within "
          f"{FLAT_PIXEL_TOL:g} {inst['close_share']:.4f}")
    _line(_frames_line(f"instanced: {FRAMES} frames {w}x{h} after 1 warm-up",
                       inst))
    flat_t = inst["flattened"]
    _line(f"flattened (320,000 tris, single level): ms/frame "
          + ", ".join(f"{x:.1f}" for x in flat_t["frame_ms"])
          + f" (mean {flat_t['mean_ms']:.1f}); {flat_t['mrays']:.2f} Mrays/s;"
          f" peak {flat_t['peak'] / 2**30:.2f} GiB; launches "
          f"{flat_t['launches']}")
    for k in INSTANCED_KERNELS:
        assert inst["launches"][k] > 0, f"the instanced frame never launched {k}"
    _field_lines("instanced field", inst["wide"])
    city = city_field_phase(schedule, w, h, 2)
    _line(f"city field: {city['instances']} instances of one "
          f"{city['unique_triangles']}-tri BLAS ({city['world_triangles']} "
          f"world tris); (16, 6) table {city['rows']} rows, stack_depth "
          f"{city['stack_depth']}; instanced K1/K2 vs plain mismatched lanes "
          f"{city['mismatches']}, {city['k1_ms']:.4f} / {city['k2_ms']:.4f} "
          f"ms; " + _frames_line("2 frames", city))
    _field_lines("city field", city["wide"])
    del city["frame"]

    # -- phase f: spectral (hero wavelengths) --------------------------------
    spec = spectral_phase(scene, config, schedule, camera, FRAMES, sw)
    _line(_frames_line(f"spectral: {FRAMES} frames {w}x{h} after 1 warm-up",
                       spec))
    _line(f"dispersive glass {sw}x{sw} (dispersion 25000), 2 subframes: GPU "
          f"vs CPU pixels within 1 LSB {spec['glass_share']:.4f}")
    for k in PATH_KERNELS:
        assert spec["launches"][k] > 0, f"the spectral frame never launched {k}"
    spec_renderer = spec.pop("renderer")
    if args.profile:
        root, ext = os.path.splitext(args.profile)
        _profile_frames(spec_renderer, f"{root}_spectral{ext}", results,
                        name="profile_spectral")
    del spec_renderer
    kernel_build.reset_launches()
    spec_cli = cli_phase(w, h, "32_16_8", spectral=True)
    spec_cli_launches = kernel_build.LAUNCHES.copy()
    _line(f"CLI: {spec_cli['argv']} -> 0 in {spec_cli['wall_s']:.1f} s; TSV "
          "render ms/frame " + ", ".join(f"{x:.1f}"
                                         for x in spec_cli["render_ms"])
          + f"; files {spec_cli['files']}; launches {spec_cli_launches}")
    for k in PATH_KERNELS:
        assert spec_cli_launches[k] > 0, f"the spectral CLI never launched {k}"

    # -- phase g: deep scenes (388,812 and 10,002,840 triangles), each in its
    # (16, 6) table and in a wide one ---------------------------------------
    deep = {}
    for city_n, deep_frames, wide in DEEP_SCENES:
        g = deep_phase(city_n, deep_frames, schedule, w, h,
                       profile=args.profile, wide=wide)
        deep[city_n] = g
        _deep_lines(f"deep n={city_n}", g)
        for k in PATH_KERNELS:
            wk = traverse.layout_name(k, *wide)
            assert g["launches"][k] > 0, f"the deep frame never launched {k}"
            assert g["launches"][wk] == 0, f"the (16, 6) frame launched {wk}"
            assert g["wide"]["launches"][wk] == g["wide"]["launches"][k] > 0, \
                f"the {wide} frame did not launch only {wk}"
        del g["frame"], g["wide"]["frame"]
        torch.cuda.empty_cache()
    g10 = deep[DEEP_SCENES[-1][0]]

    # -- phase p: JAX's default deep scene (1,920,012 triangles) in the port's
    # (16, 6) table, JAX's plain L12/A32 one and JAX's default (DFS rows,
    # grouped treelets) ------------------------------------------------------
    jt = jax_tables_phase(JAX_SCENE_N, FRAMES, schedule, w, h,
                          profile=args.profile)
    _jax_tables_lines(f"p n={JAX_SCENE_N}", jt)
    for label, rec in jt.items():
        for k in PATH_KERNELS:
            name = traverse.layout_name(k, *rec["layout"])
            assert rec["launches"][name] == rec["launches"][k] > 0, \
                f"the {label} frame did not launch {name}"
        del rec["frame"]
    torch.cuda.empty_cache()

    # -- phase q: a two-level table larger than the L2: instances of phase
    # p's 1,920,012-triangle BLAS in the (16, 6) table and at (32, 12) ------
    dq = deep_field_phase(JAX_SCENE_N, DEEP_FIELD_FRAMES, schedule, w, h,
                          count=DEEP_FIELD_COUNT)
    _deep_field_lines(f"q n={JAX_SCENE_N}", dq)
    torch.cuda.empty_cache()

    # -- phase h: the oracle, the golden images and the 04 raycast ----------
    orc = oracle_phase()
    raycast_launches = orc["raycast_launches"]
    _line(f"oracle: cornell 64x48 uniform(4), K1/K2 vs the brute-force "
          f"oracle: SSIM {orc['oracle_ssim']:.5f} (>= {ORACLE_SSIM}), mean "
          f"abs {orc['oracle_mean_abs']:.6f} (< {ORACLE_MEAN_ABS}); stack "
          f"cut to 1 vs oracle: SSIM {orc['broken_ssim']:.4f} (< 0.9)")
    _line(f"golden: open scene 48x36 uniform(4) vs "
          f"tests/golden/open_scene_48x36_u4.npz: SSIM "
          f"{orc['golden_ssim']:.5f} (> {GOLDEN_SSIM}), mean "
          f"{orc['golden_mean_lsb']:.4f} LSB (< {GOLDEN_MEAN_LSB}); "
          f"equal-spp fovea vs uniform bit-identical "
          f"{orc['fovea_identical']}")
    _line(f"raycast 64x48 (04): card vs CPU pixels within 1 LSB "
          f"{orc['raycast_share']:.4f}; floor lit/shadowed "
          f"{orc['raycast_floor_ratio']:.2f}; shadow rays "
          f"{orc['raycast_shadow']}; launches {raycast_launches}")
    assert raycast_launches["occluded_nocull"] > 0, \
        "the raycast never launched the non-culling K2"
    for k, r in orc["raycast_wide"].items():
        _line(f"raycast 64x48 (04) from the {k[len('occluded_nocull_'):]} "
              f"table: pixels within 1 LSB of the (16, 6) table's "
              f"{r['share']:.4f}; {k} launches {r['launches']}")
        assert r["launches"] > 0, f"the raycast never launched {k}"
    readme = readme_example(w, h)
    _line(f"README example: Renderer(meshes=scenes.cornell()[0]) -> "
          f"{readme['shape']} frame on {readme['device']}, mean "
          f"{readme['mean']:.2f}, {readme['traces']} traces; launches "
          f"{readme['launches']}")
    assert readme["shape"] == (h, w, 3) and 0 < readme["mean"] < 255
    assert readme["device"].startswith("cuda")
    for k in PATH_KERNELS:
        assert readme["launches"][k] > 0, f"the README frame never launched {k}"
    orc["readme"] = readme
    nocull = nocull_check(bvh, so, sd, sq, tmin, tmax)
    _line(f"non-culling K2 on the bench's bounce-0 shadow lanes: "
          f"{nocull['lanes']} lanes, {nocull['queried']} queried, "
          f"{nocull['occluded']} occluded ({nocull['occluded_culling']} "
          f"culling, {nocull['only_without_culling']} only without); "
          f"{nocull['mismatches']} mismatches; {nocull['ms']:.4f} ms "
          f"(culling K2 {nocull['culling_ms']:.4f} ms); plain "
          f"{nocull['plain_ms']:.1f} ms; work {nocull['work']}")

    # -- phase i: demand-loaded textures -------------------------------------
    dem = demand_phase(24, schedule, w, h, (sw, sh), small_sched,
                       profile=args.profile, results=results)
    for max_pages, run in dem["runs"].items():
        _line(f"demand textures, max_pages {max_pages} ({run['total_pages']} "
              f"tiles): " + "; ".join(
                  f"frame {i + 1}: {x['requested']} requested, {x['loaded']} "
                  f"loaded, {x['open']} open, {x['resident']} resident, "
                  f"{x['evicted']} evicted, {x['ms']:.1f} ms"
                  for i, x in enumerate(run["frames"]))
              + f"; launches {run['frames'][-1]['launches']}")
        for x in run["frames"]:
            for k in PATH_KERNELS:
                assert x["launches"][k] > 0, \
                    f"the demand frame never launched {k}"
    _line(f"demand small frame {sw}x{sh} after paging in: card vs CPU pixels "
          f"within 1 LSB {dem['small_share']:.4f}; CLI "
          f"{dem['cli']['argv']} -> 0, files {dem['cli']['files']}, launches "
          f"{dem['cli']['launches']}")

    # -- phase j: stereo, two eyes a pair --------------------------------------
    st = stereo_phase(scene, config, schedule, camera, STEREO_PAIRS,
                      profile=args.profile, results=results)
    _line(f"stereo: 2 x {w}x{h} a pair, IPD {IPD} m, eyes at "
          f"{[[round(x, 4) for x in e] for e in st['eyes']]}; "
          f"{STEREO_PAIRS} pairs after 1 warm-up: ms/pair "
          + ", ".join(f"{x:.1f}" for x in st["pair_ms"])
          + f" (mean {st['mean_ms']:.1f}); traces/pair {st['traces'][-1]}; "
          f"{st['mrays']:.2f} Mrays/s; kernel launches/pair "
          f"{st['launches_per_pair']}; each eye of subframe 0 equals the "
          f"mono frame: {st['mono_equal']}")
    assert all(st["mono_equal"]), "an eye differs from the mono frame"
    assert st["finite"]
    for k in PATH_KERNELS:
        assert st["launches"][k] > 0, f"the stereo pairs never launched {k}"

    # -- phase k: the multi-device paths on one card ----------------------------
    md = multidevice_phase(scene, config, schedule, camera, 2)
    for name, title in (("samples", "render_frame_sharded, 2 ranks"),
                        ("scene", "render_frame_scene_sharded, 2 blocks"),
                        ("renderer", "Renderer(multichip='samples')")):
        x = md[name]
        _line(f"multi-device {title} vs the single-device frame: pixels "
              f"equal {x['equal']:.6f}, within 1 LSB {x['within_1lsb']:.6f},"
              f" canvas max abs {x['canvas_max_abs']:.3g}; ms/frame "
              + ", ".join(f"{v:.1f}" for v in x["frame_ms"])
              + f"; launches {x['launches']}"
              + (f"; mesh {x['mesh']}" if "mesh" in x else ""))
        assert _exact(x), f"{title} differs from the single-device frame"
        for k in PATH_KERNELS:
            assert x["launches"][k] > 0, f"{title} never launched {k}"
    _line(f"scene-sharded tri_pack: {md['table_bytes']} bytes in all, "
          f"blocks of {md['block_bytes']} bytes a rank")

    # -- phase l: two processes on the one card (gloo) ------------------------
    from fovpathtracing_optixcodelatest_tpu_torch.parallel import multihost

    job = multihost.RenderJob(
        width=w, height=h, scene="box_city",
        scene_kwargs=(("n", 24), ("seed", 0)), probe="gradient",
        probe_kwargs=(), schedule="32_16_8", config_overrides=(), frames=2)
    mp = multiprocess_phase(job)
    ref = mp["vs_reference"]
    _line(f"multi-process: 2 gloo ranks on one card, {w}x{h} 32_16_8, 2 "
          f"frames: ranks' frames equal {mp['ranks_equal']}; traces "
          f"{mp['traces']}; vs reference_frame: pixels equal "
          f"{ref['equal']:.6f}, within 1 LSB {ref['within_1lsb']:.6f}; "
          f"wall s/process {[round(x, 1) for x in mp['wall_s']]}; launches "
          f"{mp['launches']}")
    assert mp["ranks_equal"] and mp["traces"][0] == mp["traces"][1] > 0
    assert _exact(ref), "the two-process frame differs from reference_frame"
    for k in PATH_KERNELS:
        assert all(x[k] > 0 for x in mp["launches"]), \
            f"a rank never launched {k}"

    # -- phase m: the browser viewer -------------------------------------------
    vw = viewer_phase(scene, config, schedule, camera)
    rms = sorted(vw["render_ms"])
    _line(f"viewer {w}x{h}: {vw['frames']} frames in {vw['wall_s']:.1f} s; "
          f"page {vw.get('page')}, stream JPEGs {vw.get('jpeg_sizes')}; "
          f"swapped to full resolution {vw['swapped']}; subframe "
          f"{vw.get('subframe_before')} -> {vw.get('subframe_after')} after "
          f"the orbit ({vw.get('frames_since_input')} frames after the "
          f"inputs); stats {vw.get('final')}; full-resolution render ms "
          f"min {rms[0] if rms else None}, median "
          f"{rms[len(rms) // 2] if rms else None}, max "
          f"{rms[-1] if rms else None} ({len(rms)} readings); launches "
          f"{vw['launches']}")
    assert "error" not in vw, vw["error"]
    assert vw["page"] and vw["jpeg_sizes"] == [(w, h)] * 2 and vw["swapped"]
    assert vw["subframe_after"] <= vw["frames_since_input"]
    assert vw["final"]["fps"] > 0 and vw["final"]["render_ms"] > 0
    for k in PATH_KERNELS:
        assert vw["launches"][k] > 0, f"the viewer never launched {k}"

    # -- phase n: the benchmark sweep, the BSDF image, the GIF ---------------
    sw = sweep_phase(480, 270, 2)
    _line(f"benchmark sweep: {sw['argv']} -> files {sw['files']}; ms/frame "
          f"{sw['ms_per_frame']}; launches {sw['launches']}")
    assert set(sw["files"]) == set(SWEEP_FILES) and all(sw["files"].values())
    for k in PATH_KERNELS:
        assert sw["launches"][k] > 0, f"the sweep never launched {k}"
    bs = bsdf_phase()
    _line("bsdf_test_image 512x256, 1000 samples, card vs CPU: " + "; ".join(
        f"{k}: image {v['rel_err']:.3g} of its largest value off the marks, "
        f"uv {v['uv_err']:.3g}, {v['marks']} marked texels, "
        f"{v['marks_differ']} marked in one only" for k, v in bs.items())
          + f" (limit {BSDF_RTOL:g})")
    for v in bs.values():
        assert v["rel_err"] <= BSDF_RTOL and v["uv_err"] <= BSDF_RTOL
    gf = gif_phase(st["pairs"])
    _line(f"save_gif of the {len(st['pairs'])} stereo pairs: read back "
          f"{gf['frames']} frames of {gf['size']}, {gf['bytes']} bytes; the "
          f"first frame's mean difference {gf['mean_abs_lsb']:.2f} LSB "
          "(256 colours a frame)")
    assert gf["frames"] == len(st["pairs"]) and gf["size"] == (2 * w, h)

    # -- phase o: the legacy oracles, and the kernels on the Python tables ----
    lg = legacy_phase(rays, host_triangles(scenes.box_city(n=24, seed=0)[0]))
    _legacy_lines(lg, times)
    for k in ("closest_hit", "occluded", "occluded_packets"):
        assert lg["launches"][k] >= 1, f"phase o never launched {k}"

    # -- phase r: the 04 raycast of the instance field, two-level tables ----
    rf = raycast_field_phase(w, h)
    _raycast_field_lines(rf)
    _check_raycast_field(rf)

    # -- phase 8: the kernels line ---------------------------------------------
    per_frame = lambda k: launches[k] / FRAMES  # noqa: E731
    # a kernel of the main path reports its launches there, one off it the
    # launches of its check on the shadow rays (phase 5)
    path_launches = {k: launches[k] if k in PATH_KERNELS else check_launches[k]
                     for k in launches.keys() | check_launches.keys()}
    b1, b1_by, f1 = _bound(st1, bvh.table, n, n_act, 16)
    b2, b2_by, f2 = _bound(st2, bvh.table, ns, nq, 1)
    b3, b3_by, _ = _bound(st3, leg.table, ns, nq, 1)
    # K3 fetches a row once per packet step, not once per ray
    f3 = ((fetched3["node_rows"] + fetched3["leaf_rows"])
          * leg.table.shape[1] * 4)
    nb = bo.shape[0]
    b1b, b1b_by, f1b = _bound(st1b, bvh.table, nb, nb, 16)
    _line(f"row fetches (L2 traffic): K1 {f1 / 1e6:.1f} MB primary, "
          f"{f1b / 1e6:.1f} MB continuation, K2 {f2 / 1e6:.1f} MB, K3 "
          f"{f3 / 1e6:.1f} MB ({fetched3['packets']} packets)")
    res = traverse.resources(bvh.stack_depth)
    spills = {}
    for log in kernel_build.BUILD_INFO["log"].values():
        spills.update(_ptxas_spills(log))
    for k, r in res.items():
        r["spill_bytes"] = spills.get(k)
    for k, r in (g10["resources"] or {}).items():
        r["spill_bytes"] = spills.get(k)
    # the instanced kernels at the field's stack depth
    inst_res = traverse.resources(inst["stack_depth"])
    for k, r in inst_res.items():
        r["spill_bytes"] = spills.get(k)
    for title, kernel_res in (
            ("resources", {k: r for k, r in res.items()
                           if k not in INSTANCED_KERNELS}),
            (f"resources at the field's depth {inst['stack_depth']}",
             {k: inst_res[k] for k in INSTANCED_KERNELS})):
        _line(f"{title}: " + "; ".join(
            f"{k} {r['registers']} regs, {r['spill_bytes']} B spilled, "
            f"{r['local_bytes']} B local, {r['shared_bytes']} B "
            f"shared/block, {r['blocks_per_sm']} blocks/SM"
            for k, r in kernel_res.items()))
    kernels = [
        {"name": "closest_hit", "route": "cuda",
         "source": KERNEL_SRC + "traverse.cu",
         "replaces": JAX_OPS + "traverse8.py:795", "launches":
         path_launches["closest_hit"], "max_abs_err": err1,
         "ms": times["k1_primary"],
         "plain_ms": p1_ms, "bound_ms": b1, "bound_by": b1_by,
         "library_ms": None, **res["closest_hit"],
         "continuation": {"lanes": nb, "ms": times["k1_continuation"],
                          "plain_ms": p1b_ms,
                          "bound_ms": b1b, "bound_by": b1b_by},
         "deep": _deep_record(g10, "k1", "closest_hit"),
         "jax_tables": _jax_tables_record(jt, "k1", (16, 6)),
         "python_table": _python_record(lg, "k1", "closest_hit")},
        {"name": "occluded", "route": "cuda",
         "source": KERNEL_SRC + "traverse.cu",
         "replaces": JAX_OPS + "traverse8.py:1367", "launches":
         path_launches["occluded"], "max_abs_err": err2,
         "ms": times["k2_shadow"],
         "plain_ms": p2_ms, "bound_ms": b2, "bound_by": b2_by,
         "library_ms": None, **res["occluded"],
         "deep": _deep_record(g10, "k2", "occluded"),
         "jax_tables": _jax_tables_record(jt, "k2", (16, 6)),
         "python_table": _python_record(lg, "k2", "occluded")},
        dict(_instanced_record("closest_hit_instanced", "traverse8.py:523",
                               ik1, inst_launches, inst_res),
             deep_field=_deep_field_record(dq, "closest_hit_instanced",
                                           (16, 6))),
        dict(_instanced_record("occluded_instanced", "traverse8.py:1487",
                               ik2, inst_launches, inst_res),
             deep_field=_deep_field_record(dq, "occluded_instanced",
                                           (16, 6))),
        # the instanced kernels at the wide layouts (phase e; phase q's
        # deep field at its layouts)
        *[dict(_field_record(inst, city, kernel, lay, replaces, spills),
               **({"deep_field": _deep_field_record(dq, kernel, lay)}
                  if lay in DEEP_FIELD_LAYOUTS else {}))
          for lay in traverse.WIDE_LAYOUTS
          for kernel, replaces in (
              ("closest_hit_instanced", "traverse8.py:523"),
              ("occluded_instanced", "traverse8.py:1487"))],
        {"name": "occluded_nocull", "route": "cuda",
         "source": KERNEL_SRC + "traverse.cu",
         "replaces": JAX_OPS + "traverse8.py:1376", "launches":
         raycast_launches["occluded_nocull"],
         "max_abs_err": max(nocull["max_abs_err"],
                            float(min(orc["raycast_shadow"]["mismatches"],
                                      1))),
         "ms": nocull["ms"], "plain_ms": nocull["plain_ms"],
         "bound_ms": nocull["bound_ms"], "bound_by": nocull["bound_by"],
         "library_ms": None, **res["occluded_nocull"],
         "jax_tables": _jax_tables_record(jt, "k2_nocull", (16, 6))},
        # the wide layouts' instantiations on phase g's scenes: K1 and K2
        # launched by the wide table's frames, the non-culling K2 by the
        # raycast from a wide table (phase h)
        *[dict(_wide_record(
            deep[city_n], k, kernel, replaces,
            orc["raycast_wide"][traverse.layout_name(kernel, *wide)][
                "launches"] if k == "k2_nocull" else
            deep[city_n]["wide"]["launches"][
                traverse.layout_name(kernel, *wide)], spills),
            jax_tables=_jax_tables_record(jt, k, wide))
          for city_n, _, wide in DEEP_SCENES
          for k, kernel, replaces in (
              ("k1", "closest_hit", "traverse8.py:795"),
              ("k2", "occluded", "traverse8.py:1367"),
              ("k2_nocull", "occluded_nocull", "traverse8.py:1376"))],
        # the non-culling two-level K2 at each layout (phase r's raycast)
        *[_raycast_field_record(rec, spills) for rec in rf.values()],
        {"name": "occluded_packets", "route": "cuda",
         "source": KERNEL_SRC + "packet_traverse.cu",
         "replaces": JAX_OPS + "pallas_traverse.py:53", "launches":
         path_launches["occluded_packets"], "max_abs_err": err3,
         "ms": times["k3_shadow"],
         "plain_ms": p3_ms, "bound_ms": b3, "bound_by": b3_by,
         "library_ms": None, **res["occluded_packets"],
         "python_table": _python_record(lg, "k3", "occluded_packets")},
        # the frame's raygen and film kernels at the bench frame (phase 6c)
        *[{"name": k, "route": "cuda", "source": KERNEL_SRC + "frame.cu",
           "replaces": JAX_RENDER + replaces, "launches": launches[k],
           "max_abs_err": 0.0, "ms": fr[f"{k}_ms"],
           "plain_ms": fr[f"plain_{k}_ms"], "bound_ms": fr["bound_ms"][k],
           "bound_by": "bytes", "least_bytes": fr["least_bytes"][k],
           "library_ms": None, **fr["resources"][k]}
          for k, replaces in (("raygen", "raygen.py:111"),
                              ("film", "film.py:68"))],
        # the live-lane compaction at bounce 0's survivors (phase 6d); it
        # replaces the host's narrowing, no JAX kernel
        {"name": "compact", "route": "cuda", "source": KERNEL_SRC + "lanes.cu",
         "replaces": None, "launches": launches["compact"],
         "max_abs_err": 0.0, "ms": lc["compaction"]["compact_ms"],
         "plain_ms": None, "bound_ms": lc["compaction"]["bound_ms"],
         "bound_by": "bytes",
         "least_bytes": lc["compaction"]["least_bytes"]["depth1"],
         "library_ms": None, **lc["compaction"]["resources"]["compact"]},
    ]
    for k in kernels:
        k["main_path"] = k["name"] in (PATH_KERNELS + INSTANCED_KERNELS
                                       + ("raygen", "film", "compact"))
    results.update(
        kernels=kernels, frame_ms=frame_ms, traces=traces, mrays_s=mrays,
        peak_bytes=peak, launches_per_frame={k: per_frame(k) for k in launches},
        work={"k1": st1, "k1_continuation": st1b, "k2": st2, "k3": st3,
              "k3_walk": fetched3},
        row_fetch_bytes={"k1": f1, "k1_continuation": f1b, "k2": f2,
                         "k3": f3},
        shadow_rays={"lanes": ns, "queried": nq}, small_share=share,
        workload=RAY_SHAPE,
        textured={k: v for k, v in tex.items() if k != "frame"},
        untextured_again={k: v for k, v in again.items() if k != "frame"},
        large_probe={k: v for k, v in big.items() if k != "frame"},
        catcher=dict(cat, launches=cat_launches),
        cli=dict(cli, launches=cli_launches),
        instanced={k: v for k, v in inst.items() if k != "frame"},
        city_field=city, jax_tables=jt, deep_field=dq,
        spectral={k: v for k, v in spec.items() if k != "frame"},
        spectral_cli=dict(spec_cli, launches=spec_cli_launches),
        deep=deep, oracle=orc, nocull=nocull, demand=dem,
        stereo={k: v for k, v in st.items() if k != "pairs"},
        multidevice=md, multiprocess={k: v for k, v in mp.items()
                                      if k != "frame"},
        viewer=vw, sweep=sw, bsdf=bs, gif=gf, legacy=lg, raycast_field=rf,
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
