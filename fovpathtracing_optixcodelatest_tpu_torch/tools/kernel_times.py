#!/usr/bin/env python3
"""The traversal kernels at the main path's shapes, and their timing.

``bench_rays`` builds the bench scene (box_city n=24, seed 0, gradient sky)
and the first frame's rays at 960x540 ``reference_32_16_8``;
``kernel_calls`` and ``time_kernels`` time, with CUDA events, K1 on the
1,923,984 primary lanes and on bounce 0's continuation rays, K2 and K3 on
bounce 0's shadow lanes. ``field_rays`` and ``field_calls`` do the same
for the instance field (``instance_field``: 1,000 instances of one
320-triangle sphere) on its two-level table: the instanced K1 on the
frame's primary lanes, the instanced K2 on bounce 0's shadow lanes, the
same kernels on the field's two-level tables at the wide layouts
(``field_rays(layouts=)``), and the single-level K1 and K2 on the
flattened twin's table with the same rays; ``deep_field`` is a field
whose table does not fit in the L2 (4 instances of a 1,920,012-triangle
BLAS: ``chip_smoke.py`` phase q). ``layout_tables`` and
``table_calls`` compare packings: one scene's tables at several (arity,
leaf_size) layouts and row orders, each walked by K1, K2 and the
non-culling K2 with the same rays (``chip_smoke.py`` phases g and p).
``chip_smoke.py`` reports these times in its kernels line.

    python3 fovpathtracing_optixcodelatest_tpu_torch/tools/kernel_times.py \\
        --tree DIR [--field [--deep N] [--layout A L ...] | --layouts N
        [--layout A L ...] [--jax-default]] [--out times.json]

prints the same times for the port of another checkout ``DIR``, through
this file's timing code: it calls only the kernel wrappers' public
signatures, which every tree of the port shares, so it times an older
commit, or a patched copy of the port that tries a design alternative, at
shapes that commit's own ``chip_smoke.py`` does not time. It also times K3
three more times (its packets depend on scheduling, so this shows its
spread within one process) and counts the shadow rays where that tree's K3
and K2 answer differently. ``--field`` times the field's kernels instead,
counts the lanes where that tree's instanced K1 and K2 differ from their
plain versions (every output bit for bit), and reports the instanced
kernels' registers, local memory, blocks per SM and shared memory at the
field's stack depth with the tree's ``ptxas`` lines; with ``--layout A L``
(repeatable) also the field's two-level tables at those layouts, on the
same rays (the tree must compile the instanced kernels at those layouts);
``--deep N`` times ``deep_field(N)`` instead (N = 400: phase q's), at
(16, 6) and at (32, 12) unless ``--layout`` names others, holding the
kernels to their plain versions on ``DEEP_CHECK_LANES`` lanes of each
kind and reporting each table's rows, bytes and host build seconds.
``--layouts N``
times ``box_city_fast(N)``'s tables at every layout the kernels are
compiled for (``traverse.KERNEL_LAYOUTS``) on the primary and bounce-0
shadow lanes of that scene's 960x540 frame, with each table's rows, stack
depth, host build seconds, structure (``table_structure``) and resources
(with each kernel's design where the tree reports it: lanes a ray, how
rows are read, the stack's home;
the (32, 24) table is collapsed in Python: about 12 s at N = 180, more
than 5 minutes at N = 913, so name ``--layout 32 12`` there); the tables
are in pack order, and ``--jax-default`` adds the JAX package's default
table for a named L12/A32 layout (from 1M triangles in DFS order with
grouped treelets: at N = 400, 1,920,012 triangles, phase p's scene); it
also counts the lanes where each of the tree's kernels differs from its
plain version on ``DEEP_CHECK_LANES`` lanes of each kind
(``table_mismatches``). To
compare the parent's kernels with the change's on one card, unpack ``git
archive <parent>`` into a git-ignored directory and run, in one chip call,
each tree's ``chip_smoke.py`` in the order parent, change, change, parent,
with this script on the parent's tree beside each parent run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

PRIMARY_LANES = 1_923_984  # 960x540 reference_32_16_8
REPS = 20  # timed launches per kernel and shape, after one warm-up


def bench_rays(device="cuda", city_n: int = 24, width: int = 960,
               height: int = 540, schedule=None) -> dict:
    """The scene and the rays the kernels see on the main path's first
    bounce: ``primary`` (origin, direction, active, ray ids of every lane
    of frame 0's passes), bounce 0 of the active lanes (``bounce0``, the
    integrator's dict), its ``shadow`` rays (origin, direction, query) and
    its ``continuation`` rays (origin, direction, all active)."""
    from fovpathtracing_optixcodelatest_tpu_torch.config import (
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

    meshes, cam = scenes.box_city(n=city_n, seed=0)
    t0 = time.perf_counter()
    arrays = scene_arrays(meshes, gradient_sky_probe(), legacy8=True)
    scene = scene_from_arrays(arrays, device=device)
    scene_s = time.perf_counter() - t0
    config = RenderConfig(width=width, height=height)
    if schedule is None:
        schedule = FoveationSchedule.reference_32_16_8()
    camera = dataclasses.replace(cam, aspect=width / height)
    return dict(frame_rays(scene, camera, config, schedule, device),
                scene_s=scene_s)


def frame_rays(scene, camera, config, schedule, device="cuda") -> dict:
    """The rays ``scene``'s kernels see on the first bounce of subframe 0
    (seed 0) of a frame of ``camera`` at ``config``'s size (``bench_rays``'
    keys but ``scene_s``)."""
    import torch

    from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import (
        fold_in,
        prng_key,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.render import (
        integrator,
        raygen,
    )

    width, height = config.width, config.height
    camp = camera.device_params(device)
    frame_key = fold_in(prng_key(0), 0)  # subframe 0 of seed 0
    rays = [raygen.generate_pass_rays(camp, p, width, height, width // 2,
                                      height // 2, fold_in(frame_key, 0))
            for p in schedule.passes]
    o = torch.cat([r["origin"] for r in rays]).contiguous()
    d = torch.cat([r["direction"] for r in rays]).contiguous()
    act = torch.cat([r["active"] for r in rays]).contiguous()
    ids = torch.cat([r["ray_ids"] for r in rays])

    idx = torch.nonzero(act).squeeze(1)
    k = idx.numel()
    b0 = integrator.bounce(
        scene, o[idx], d[idx],
        torch.ones((k, 3), dtype=torch.float32, device=device),
        torch.ones((k,), dtype=torch.float32, device=device),
        ids[idx], fold_in(fold_in(frame_key, 1), 0), True, config,
    )
    alive = b0["alive"]
    bo = b0["origin"][alive].contiguous()
    return {
        "scene": scene, "config": config,
        "schedule": schedule, "camera": camera,
        "primary": (o, d, act, ids),
        "bounce0": b0,
        "shadow": (b0["shadow_origin"], b0["shadow_dir"],
                   b0["shadow_query"]),
        "continuation": (bo, b0["direction"][alive].contiguous(),
                         torch.ones((bo.shape[0],), dtype=torch.bool,
                                    device=device)),
    }


def instance_field(count: int = 1000):
    """The JAX package's 1,000-instance field (its instancing test's memory
    case): one icosphere (radius 0.45, subdivision 2: 320 triangles) placed
    ``count`` times on a 32 x 8 x 4 lattice, and a camera that frames the
    whole lattice -> (InstancedScene, camera)."""
    import numpy as np

    from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera
    from fovpathtracing_optixcodelatest_tpu_torch.models.instance import (
        instanced,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.material import (
        Material,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
        make_icosphere,
    )

    def translate(x, y, z):
        m = np.eye(4)
        m[:3, 3] = (x, y, z)
        return m

    ball = make_icosphere((0.0, 0.0, 0.0), 0.45, 2,
                          Material(color=(0.7, 0.7, 0.7), roughness=0.9))
    placements = [(0, translate((i % 32) * 1.2, ((i // 32) % 8) * 1.3,
                                (i // 256) * 1.4)) for i in range(count)]
    cam = Camera(eye=(18.6, 16.0, 30.0), lookat=(18.6, 4.5, 2.0), fov_y=45.0)
    return instanced([ball], placements), cam


def _merged(meshes):
    """One ``HostMesh`` of ``meshes``' triangles (in their order) with the
    second mesh's material: a city's boxes as one BLAS."""
    import numpy as np

    from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import HostMesh

    base = np.cumsum([0] + [len(m.vertex) for m in meshes[:-1]])
    return HostMesh(
        vertex=np.concatenate([m.vertex for m in meshes]),
        index=np.concatenate([m.index + b for m, b in zip(meshes, base)]
                             ).astype(np.int32),
        normal=np.concatenate([m.normal for m in meshes]),
        material=meshes[1].material)


def city_field(count: int = 8):
    """``count`` instances of one 1,500-triangle BLAS, box_city n=16's
    ground slab and first 124 boxes merged into one mesh (many leaf rows
    at every layout), on a 4-wide grid 90 apart, and a camera that frames
    them -> (InstancedScene, camera)."""
    import numpy as np

    from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
    from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera
    from fovpathtracing_optixcodelatest_tpu_torch.models.instance import (
        instanced,
    )

    city = _merged(scenes.box_city(n=16, seed=0)[0][:125])
    placements = []
    for k in range(count):
        m = np.eye(4)
        m[:3, 3] = (90.0 * (k % 4), 0.0, -90.0 * (k // 4))
        placements.append((0, m))
    cam = Camera(eye=(135.0, 110.0, 150.0), lookat=(135.0, 0.0, -45.0),
                 fov_y=50.0)
    return instanced([city], placements), cam


def deep_field(city_n: int = 400, count: int = 4):
    """``count`` instances, on a grid two wide and 82 apart, of one BLAS:
    ``box_city_fast(city_n)``'s meshes merged into one mesh (at n=400
    1,920,012 triangles, whose (32, 12) BLAS rows are about 122 MB, more
    than twice the H100's 50 MB L2), and a camera that frames them ->
    (InstancedScene, camera)."""
    import numpy as np

    from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
    from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera
    from fovpathtracing_optixcodelatest_tpu_torch.models.instance import (
        instanced,
    )

    city = _merged(scenes.box_city_fast(n=city_n, seed=0)[0])
    rows = (count + 1) // 2
    placements = []
    for k in range(count):
        m = np.eye(4)
        m[:3, 3] = (82.0 * (k % 2 - 0.5), 0.0,
                    82.0 * (k // 2 - (rows - 1) / 2))
        placements.append((0, m))
    cam = Camera(eye=(-98.4, 36.9, 98.4), lookat=(0.0, 0.0, 0.0),
                 fov_y=45.0)
    return instanced([city], placements), cam


def field_rays(device="cuda", count: int = 1000, width: int = 960,
               height: int = 540, schedule=None, layouts=(),
               field=None, flat: bool = True) -> dict:
    """The instance field (``instance_field``) under the gradient sky on
    its two-level table (``scene``) and flattened into one single-level
    table (``flat``), with the rays the kernels see on the first bounce of
    the instanced frame (``frame_rays``' keys) and the host build seconds
    of both scenes (``build_s``, ``flat_build_s``); ``wide``: the field's
    two-level tables at each (arity, leaf_size) of ``layouts``
    (``DeviceBVH``s) with their host build seconds (``wide_build_s``).
    ``field``: another (InstancedScene, camera), e.g. ``city_field()``;
    ``flat=False`` leaves the flattened scene out (``flat`` None)."""
    from fovpathtracing_optixcodelatest_tpu_torch.config import (
        FoveationSchedule,
        RenderConfig,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
        gradient_sky_probe,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
        scene_arrays,
        scene_arrays_instanced,
        scene_from_arrays,
    )

    sc, cam = instance_field(count) if field is None else field
    probe = gradient_sky_probe()
    t0 = time.perf_counter()
    scene = scene_from_arrays(scene_arrays_instanced(sc, probe), device)
    build_s = time.perf_counter() - t0
    flat_build_s = None
    if flat:
        t0 = time.perf_counter()
        flat = scene_from_arrays(scene_arrays(sc.flatten(), probe), device)
        flat_build_s = time.perf_counter() - t0
    else:
        flat = None
    config = RenderConfig(width=width, height=height)
    if schedule is None:
        schedule = FoveationSchedule.reference_32_16_8()
    camera = dataclasses.replace(cam, aspect=width / height)
    wide, wide_s = {}, {}
    for lay in layouts:
        t0 = time.perf_counter()
        wide[tuple(lay)] = field_table(sc, *lay, device)
        wide_s[tuple(lay)] = time.perf_counter() - t0
    return dict(frame_rays(scene, camera, config, schedule, device),
                flat=flat, field=sc, build_s=build_s,
                flat_build_s=flat_build_s, wide=wide, wide_build_s=wide_s)


def field_table(sc, arity: int, leaf_size: int, device):
    """The two-level table of the instanced scene ``sc`` at (arity,
    leaf_size) (``tlas.build_instanced``), as a ``DeviceBVH``."""
    from fovpathtracing_optixcodelatest_tpu_torch.models.scene import DeviceBVH
    from fovpathtracing_optixcodelatest_tpu_torch.ops import tlas

    b = tlas.build_instanced(*tlas.scene_tables_from_instanced(sc),
                             leaf_size=leaf_size, arity=arity)
    return DeviceBVH.upload(b, device)


def _field_bvh(rays: dict, layout=(16, 6)):
    """The field's two-level table at ``layout``."""
    if tuple(layout) == (16, 6):
        return rays["scene"].bvh
    return rays["wide"][tuple(layout)]


def field_calls(rays: dict) -> dict:
    """One zero-argument call per field kernel and shape: the instanced K1
    on the primary lanes, the instanced K2 on the shadow lanes (on the
    (16, 6) table, "ik1_primary" and "ik2_shadow", and on each of the
    ``wide`` tables, named by ``traverse.layout_name``:
    "ik1_primary_a32_l12", ...), and the single-level K1 and K2 on the same
    rays against the flattened table (where ``rays`` has one)."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse

    config = rays["config"]
    o, d, act, _ = rays["primary"]
    so, sd, sq = rays["shadow"]
    calls = {}
    for lay in ((16, 6), *rays.get("wide", {})):
        b = _field_bvh(rays, lay)
        kargs = (config.tmin, config.tmax, *b.walk_args)
        kw = b.instance_kwargs
        calls[traverse.layout_name("ik1_primary", *lay)] = (
            lambda b=b, kargs=kargs, kw=kw: traverse.closest_hit(
                b.table, o, d, act, *kargs, **kw))
        calls[traverse.layout_name("ik2_shadow", *lay)] = (
            lambda b=b, kargs=kargs, kw=kw: traverse.occluded(
                b.table, so, sd, sq, *kargs, **kw))
    if rays["flat"] is not None:
        fb = rays["flat"].bvh
        fargs = (config.tmin, config.tmax, *fb.walk_args)
        calls["flat_k1_primary"] = lambda: traverse.closest_hit(
            fb.table, o, d, act, *fargs)
        calls["flat_k2_shadow"] = lambda: traverse.occluded(
            fb.table, so, sd, sq, *fargs)
    return calls


def subset_lanes(mask, count: int):
    """``count`` lanes of the set lanes of ``mask``, evenly spread over
    them (all of them where there are fewer)."""
    import torch

    lanes = torch.nonzero(mask).squeeze(1)
    step = max(1, lanes.numel() // count)
    return lanes[::step][:count]


def field_subset(rays: dict, count: int) -> dict:
    """``rays`` (``field_rays``) with its primary and shadow lanes cut to
    ``count`` of the active and of the queried ones (``subset_lanes``),
    every one of them walked."""
    import torch

    o, d, act, ids = rays["primary"]
    so, sd, sq = rays["shadow"]
    s1, s2 = subset_lanes(act, count), subset_lanes(sq, count)
    ones = lambda s: torch.ones((s.numel(),), dtype=torch.bool,  # noqa
                                device=act.device)
    return dict(rays, primary=(o[s1].contiguous(), d[s1].contiguous(),
                               ones(s1), ids[s1]),
                shadow=(so[s2].contiguous(), sd[s2].contiguous(), ones(s2)))


def field_mismatches(rays: dict, calls: dict, plain=None,
                     layout=(16, 6)) -> dict:
    """Lanes where the field's instanced K1 and K2 on its table at
    ``layout`` differ from their plain versions: per K1 output (t, u, v
    compared bit for bit) and K2's answer. The kernels are exact when
    every count is 0. ``plain``: the plain versions' (K1, K2) answers on
    ``rays``, where the caller has them already."""
    import torch

    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse

    config, b = rays["config"], _field_bvh(rays, layout)
    kargs = (config.tmin, config.tmax, *b.walk_args)
    o, d, act, _ = rays["primary"]
    so, sd, sq = rays["shadow"]
    if plain is None:
        plain = (traverse.closest_hit_plain(b.table, o, d, act, *kargs,
                                            **b.instance_kwargs),
                 traverse.occluded_plain(b.table, so, sd, sq, *kargs,
                                         **b.instance_kwargs))
    p1, p2 = plain
    k1 = calls[traverse.layout_name("ik1_primary", *layout)]()
    out = {}
    for c in ("hit", "t", "u", "v", "tri_id", "inst"):
        got, want = k1[c], p1[c]
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        out[c] = int((got != want).sum())
    del k1
    out["occluded"] = int(
        (calls[traverse.layout_name("ik2_shadow", *layout)]() != p2)
        .sum())
    return out


def events_ms(fn) -> float:
    """Mean device time of ``fn`` over ``REPS`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def kernel_calls(rays: dict) -> dict:
    """One zero-argument call per (kernel, main-path shape)."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import (
        packet_traverse,
        traverse,
    )

    scene, config = rays["scene"], rays["config"]
    bvh, leg = scene.bvh, scene.legacy
    kargs = (config.tmin, config.tmax, bvh.stack_depth, bvh.arity,
             bvh.leaf_size)
    largs = (config.tmin, config.tmax, leg.stack_depth, leg.leaf_size)
    o, d, act, _ = rays["primary"]
    co, cd, cact = rays["continuation"]
    so, sd, sq = rays["shadow"]
    return {
        "k1_primary": lambda: traverse.closest_hit(bvh.table, o, d, act,
                                                   *kargs),
        "k1_continuation": lambda: traverse.closest_hit(bvh.table, co, cd,
                                                        cact, *kargs),
        "k2_shadow": lambda: traverse.occluded(bvh.table, so, sd, sq, *kargs),
        "k3_shadow": lambda: packet_traverse.occluded_packets(
            leg.table, so, sd, sq, *largs),
    }


def layout_tables(tris, layouts, jax_default: bool = False) -> dict:
    """{(arity, leaf_size): (WideBVH, host build seconds)} of the triangles
    ``tris`` packed at each of ``layouts`` in pack order (``dfs=False``:
    the (16, 6) table the default build gives), and with ``jax_default``
    under "jax" the JAX package's table for a named L12/A32 layout
    (``bvh_native.build(tris, leaf_size=12, arity=32)``: from 1M triangles
    in DFS order with grouped treelets)."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import bvh_native

    out = {}
    todo = [((arity, leaf), {"leaf_size": leaf, "arity": arity,
                             "dfs": False}) for arity, leaf in layouts]
    if jax_default:
        todo.append(("jax", {"leaf_size": 12, "arity": 32}))
    for key, kw in todo:
        t0 = time.perf_counter()
        b = bvh_native.build(tris, **kw)
        out[key] = (b, time.perf_counter() - t0)
    return out


def table_name(kernel: str, b) -> str:
    """``kernel``'s call name on the table ``b``: its instantiation's
    (``traverse.layout_name``), and "_dfs" or "_treelet" after it for
    a table in DFS or treelet order."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse

    name = traverse.layout_name(kernel, b.arity, b.leaf_size)
    return name + ("_treelet" if b.top_rows else "_dfs" if b.dfs else "")


def table_calls(bvhs, config, primary, shadow) -> dict:
    """One zero-argument call per table and kernel, every table walked by
    the same rays: K1 on the ``primary`` lanes (origin, direction,
    active), K2 and the non-culling K2 on the ``shadow`` lanes (origin,
    direction, query). ``bvhs`` are ``DeviceBVH``s of distinct layouts or
    row orders; each call is named by ``table_name``: "closest_hit",
    "occluded_a32_l12", "closest_hit_a32_l12_treelet", ..."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse

    calls = {}
    for b in bvhs:
        kargs = (config.tmin, config.tmax, *b.walk_args)
        name = lambda k, b=b: table_name(k, b)  # noqa: E731
        calls[name("closest_hit")] = (
            lambda b=b, kargs=kargs: traverse.closest_hit(
                b.table, *primary, *kargs))
        calls[name("occluded")] = (
            lambda b=b, kargs=kargs: traverse.occluded(
                b.table, *shadow, *kargs))
        calls[name("occluded_nocull")] = (
            lambda b=b, kargs=kargs: traverse.occluded(
                b.table, *shadow, *kargs, cull_backface=False))
    return calls


def table_mismatches(bvhs, config, primary, shadow, count: int) -> dict:
    """{call name: lanes where the kernel's answer differs from its plain
    version's} for every ``table_calls`` call on ``count`` of the active
    ``primary`` lanes and of the queried ``shadow`` lanes
    (``subset_lanes``): K1's hit, t, u, v (bit for bit) and tri_id
    summed, K2's and the non-culling K2's answers."""
    import torch

    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse

    s1, s2 = subset_lanes(primary[2], count), subset_lanes(shadow[2], count)
    o, d = (x[s1].contiguous() for x in primary[:2])
    so, sd = (x[s2].contiguous() for x in shadow[:2])
    act = torch.ones((s1.numel(),), dtype=torch.bool, device=o.device)
    sq = torch.ones((s2.numel(),), dtype=torch.bool, device=o.device)
    out = {}
    for b in bvhs:
        args = (b.table, o, d, act, config.tmin, config.tmax, *b.walk_args)
        k, p = traverse.closest_hit(*args), traverse.closest_hit_plain(*args)
        out[table_name("closest_hit", b)] = sum(
            int((k[c].view(torch.int32) != p[c].view(torch.int32)).sum())
            if k[c].dtype == torch.float32 else int((k[c] != p[c]).sum())
            for c in ("hit", "t", "u", "v", "tri_id"))
        sargs = (b.table, so, sd, sq, config.tmin, config.tmax,
                 *b.walk_args)
        for name, cull in (("occluded", True), ("occluded_nocull", False)):
            out[table_name(name, b)] = int(
                (traverse.occluded(*sargs, cull_backface=cull)
                 != traverse.occluded_plain(*sargs, cull_backface=cull))
                .sum())
    return out


def table_structure(b) -> dict:
    """The shape of a packed single-level table (``WideBVH``, numpy) as
    its walks meet it: its rows, the node and leaf rows reached from the
    root, children a node row holds, the node rows with a child past slot 15,
    triangles a leaf row holds, and how many leaf rows use each count of
    thirds (``used_thirds[k]``: leaves whose real triangles fill k thirds
    of three slots; a leaf's padding is a suffix, id -1)."""
    import numpy as np

    arity, leaf = b.arity, b.leaf_size
    codes = np.ascontiguousarray(b.table[:, 3 * arity: 4 * arity]).view(
        np.uint32)
    ids = np.ascontiguousarray(b.table[:, 9 * leaf: 10 * leaf]).view(
        np.int32)
    nodes, leaves, todo = [], [], [0]
    while todo:
        row = todo.pop()
        nodes.append(row)
        for c in codes[row][codes[row] != 0]:
            (todo if c & 3 == 0 else leaves).append(int(c) >> 2)
    kids = codes[nodes] != 0
    real = (ids[leaves] >= 0).sum(axis=1)
    thirds = np.bincount((real + 2) // 3, minlength=leaf // 3 + 1)
    return {"rows": int(b.table.shape[0]), "node_rows": len(nodes),
            "leaf_rows": len(leaves),
            "children_per_node": float(kids.sum() / len(nodes)),
            "node_rows_past_slot_15": int(kids[:, 16:].any(axis=1).sum()),
            "triangles_per_leaf": float(real.mean()),
            "used_thirds": [int(x) for x in thirds],
            "thirds_per_leaf": float(((real + 2) // 3).mean())}


def time_kernels(calls: dict) -> dict:
    """{shape: mean ms} of every ``kernel_calls`` entry, in its order."""
    return {name: events_ms(fn) for name, fn in calls.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True,
                    help="root of the checkout whose port is timed")
    ap.add_argument("--field", action="store_true",
                    help="time the instance field's kernels instead")
    ap.add_argument("--layouts", type=int, default=None, metavar="N",
                    help="time box_city_fast(N)'s tables at every compiled "
                    "layout instead")
    ap.add_argument("--layout", type=int, nargs=2, action="append",
                    metavar=("ARITY", "LEAF"),
                    help="with --layouts: only these layouts; with "
                    "--field: the field's tables at these layouts too "
                    "(repeat)")
    ap.add_argument("--deep", type=int, default=None, metavar="N",
                    help="with --field: the deep field (4 instances of "
                    "box_city_fast(N)'s BLAS) instead of the sphere field, "
                    "at (16, 6) and (32, 12) unless --layout names others")
    ap.add_argument("--jax-default", action="store_true",
                    help="with --layouts: also the JAX package's default "
                    "table of a named L12/A32 layout")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if args.field:
        result = dict(field_times(args.layout or ([(32, 12)] if args.deep
                                                  else ()), args.deep),
                      tree=tree, device=smi, reps=REPS)
    elif args.layouts is not None:
        result = dict(layout_times(args.layouts, args.layout,
                                   args.jax_default),
                      tree=tree, device=smi, reps=REPS)
    else:
        result = dict(bench_times(), tree=tree, device=smi, reps=REPS)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


# the lanes of each kind on which --field --deep holds the kernels to
# their plain versions (the plain walks of all the deep field's lanes
# would take minutes)
DEEP_CHECK_LANES = 65_536


def field_times(layouts=(), deep=None) -> dict:
    """``--field``: the field's kernel times, the instanced kernels'
    mismatches against their plain versions and their resources at each
    table's depth, on the (16, 6) table and at ``layouts``; with ``deep``
    (``--deep N``) on ``deep_field(N)``, the mismatches on
    ``DEEP_CHECK_LANES`` of each kind, with each table's rows, bytes and
    host build seconds."""
    from fovpathtracing_optixcodelatest_tpu_torch.ops import (
        kernel_build,
        traverse,
    )

    layouts = [tuple(x) for x in layouts]
    rays = field_rays("cuda", layouts=layouts, flat=deep is None,
                      field=None if deep is None else deep_field(deep))
    assert rays["primary"][0].shape[0] == PRIMARY_LANES
    calls = field_calls(rays)
    checked = rays if deep is None else field_subset(rays, DEEP_CHECK_LANES)
    check_calls = calls if deep is None else field_calls(checked)
    mismatches, depths, resources, tables = {}, {}, {}, {}
    for lay in ((16, 6), *layouts):
        key = traverse.layout_name("field", *lay)
        mismatches[key] = field_mismatches(checked, check_calls, layout=lay)
        b = _field_bvh(rays, lay)
        depths[key] = b.stack_depth
        tables[key] = {"rows": b.num_rows, "bytes": b.table.numel() * 4,
                       "build_s": rays["build_s"] if lay == (16, 6)
                       else rays["wide_build_s"][lay]}
        res = traverse.resources(depths[key])
        resources.update({traverse.layout_name(k, *lay):
                          res[traverse.layout_name(k, *lay)]
                          for k in traverse.INSTANCED_KERNELS})
    times = time_kernels(calls)
    ptxas = [ln.strip() for log in kernel_build.BUILD_INFO["log"].values()
             for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    return {"lanes": {"primary": PRIMARY_LANES,
                      "shadow": rays["shadow"][0].shape[0],
                      "shadow_queried": int(rays["shadow"][2].sum())},
            "deep": deep, "checked_lanes": checked["primary"][0].shape[0],
            "stack_depth": depths, "tables": tables,
            "flat_stack_depth": (rays["flat"].bvh.stack_depth
                                 if rays["flat"] is not None else None),
            "ms": times, "mismatches": mismatches, "resources": resources,
            "ptxas": ptxas}


def layout_times(city_n: int, layouts=None, jax_default: bool = False
                 ) -> dict:
    """``--layouts N``: K1, K2 and the non-culling K2 on ``box_city_fast(N)``
    at each of ``layouts`` (default: every compiled layout) in pack order,
    and with ``jax_default`` on the JAX package's default L12/A32 table,
    with the same rays (the frame of the scene's (16, 6) table); the lanes
    where each differs from its plain version on ``DEEP_CHECK_LANES`` lanes
    of each kind (``table_mismatches``); and each table's rows, stack depth,
    top rows, host build seconds, structure (``table_structure``, pack
    order only) and kernel resources at its depth."""
    from fovpathtracing_optixcodelatest_tpu_torch.config import (
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
        DeviceBVH,
        scene_arrays,
        scene_from_arrays,
    )
    from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse

    layouts = [tuple(x) for x in layouts or traverse.KERNEL_LAYOUTS]
    meshes, cam = scenes.box_city_fast(n=city_n, seed=0)
    tables = layout_tables(host_triangles(meshes), {(16, 6), *layouts},
                           jax_default)
    scene = scene_from_arrays(scene_arrays(
        meshes, gradient_sky_probe(), bvh=tables[(16, 6)][0]), "cuda")
    tables = {k: tables[k] for k in (*layouts, *(["jax"] * jax_default))}
    config = RenderConfig(width=960, height=540)
    rays = frame_rays(scene, dataclasses.replace(cam, aspect=960 / 540),
                      config, FoveationSchedule.reference_32_16_8())
    o, d, act, _ = rays["primary"]
    bvhs = {k: DeviceBVH.upload(b, "cuda") for k, (b, _) in tables.items()}
    calls = table_calls(bvhs.values(), config, (o, d, act), rays["shadow"])
    mismatches = table_mismatches(bvhs.values(), config, (o, d, act),
                                  rays["shadow"], DEEP_CHECK_LANES)
    times = time_kernels(calls)
    info = []
    for key, (b, build_s) in tables.items():
        res = traverse.resources(b.stack_depth)
        structure = None if b.dfs else table_structure(b)
        b = bvhs[key]
        names = [traverse.layout_name(k, b.arity, b.leaf_size)
                 for k in traverse.LAYOUT_KERNELS]
        info.append({
            "layout": [b.arity, b.leaf_size], "dfs": b.dfs,
            "top_rows": b.top_rows, "rows": b.num_rows,
            "width": b.table.shape[1], "stack_depth": b.stack_depth,
            "build_s": build_s, "structure": structure,
            "resources": {k: res[k] for k in names}})
    return {"city_n": city_n, "triangles": scene.num_triangles,
            "lanes": {"primary": o.shape[0],
                      "shadow": rays["shadow"][0].shape[0],
                      "shadow_queried": int(rays["shadow"][2].sum())},
            "ms": times, "mismatches": mismatches, "tables": info}


def bench_times() -> dict:
    """The bench kernels' times, K3's spread and its answers against
    K2's."""
    rays = bench_rays("cuda")
    assert rays["primary"][0].shape[0] == PRIMARY_LANES
    calls = kernel_calls(rays)
    mismatches = int((calls["k2_shadow"]() != calls["k3_shadow"]()).sum())
    times = time_kernels(calls)
    k3_again = [events_ms(calls["k3_shadow"]) for _ in range(3)]
    return {"lanes": {"primary": PRIMARY_LANES,
                      "continuation": rays["continuation"][0].shape[0],
                      "shadow": rays["shadow"][0].shape[0],
                      "shadow_queried": int(rays["shadow"][2].sum())},
            "ms": times, "k3_again": k3_again,
            "k3_vs_k2_mismatches": mismatches}


if __name__ == "__main__":
    sys.exit(main())
