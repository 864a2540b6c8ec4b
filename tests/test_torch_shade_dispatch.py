"""Which bounce ``trace_paths`` takes, and the C interface of the bounce's
shading kernels (``csrc/shade.cu``, ``ops/shade.py``), on the CPU.

CPU tensors take the plain bounce and count it under ``shade`` /
``"plain"``; ``integrator.shades_on_kernels`` sends spectral, demand,
oracle and row-sharded inputs to the plain bounce on any device. The
kernels' names are not traversal kernels' to the benchmark's
``traversal_ms`` reader, so their time counts in ``torch_ops_ms``. The
argument structs ``ops/shade.py`` packs have the fields, order and types
``csrc/shade.cu`` declares, and the packing reads the material columns,
probe rows or alias arrays, texture sizes and key words the kernels
expect, and refuses a tensor of another dtype or a strided one.
"""

import dataclasses
import os
import re
import sys

import pytest
import torch

from fovpathtracing_optixcodelatest_tpu_torch.config import (
    FoveationSchedule,
    RenderConfig,
)
from fovpathtracing_optixcodelatest_tpu_torch.models import probe as probe_mod
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
from fovpathtracing_optixcodelatest_tpu_torch.models.material import view_rows
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
    gradient_sky_probe,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import build_scene
from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
from fovpathtracing_optixcodelatest_tpu_torch.ops import shade
from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import (
    fold_in,
    key_words,
    prng_key,
)
from fovpathtracing_optixcodelatest_tpu_torch.render import integrator
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import Renderer
from fovpathtracing_optixcodelatest_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHADE_CU = os.path.join(REPO, "fovpathtracing_optixcodelatest_tpu_torch",
                        "csrc", "shade.cu")
CUDA = torch.device("cuda")  # only compared against, never allocated on


@pytest.fixture(scope="module")
def textured():
    meshes, cam, images = scenes.box_city_textured(n=3, seed=0)
    return build_scene(meshes, gradient_sky_probe(width=64, height=32),
                       images, device="cpu"), cam


def test_cpu_frames_take_the_plain_bounce(textured):
    scene, cam = textured
    config = RenderConfig(width=32, height=16, max_depth=3)
    r = Renderer(scene, config, FoveationSchedule.uniform(1), seed=1,
                 device="cpu")
    r.set_camera(cam)
    kernel_build.reset_launches()
    before = tracing.snapshot()
    r.render()
    got = tracing.diff(before, tracing.snapshot())
    bounces = sum(1 for n in got["lanes"].values() if n > 0)
    assert bounces > 0 and got["shade"] == {"plain": bounces}
    assert kernel_build.LAUNCHES["shade"] == kernel_build.LAUNCHES[
        "resolve"] == 0


@pytest.mark.parametrize("case,kernels", [
    ("rgb", True), ("cpu", False), ("spectral", False), ("demand", False),
    ("oracle", False), ("row_sharded", False), ("textured", True),
    ("catcher", True), ("instanced", True),
])
def test_dispatch_predicate(textured, case, kernels):
    scene, _ = textured
    config, device = RenderConfig(), CUDA
    if case == "cpu":
        device = torch.device("cpu")
    elif case == "spectral":
        config = RenderConfig(spectral=True)
    elif case == "demand":
        scene = dataclasses.replace(scene, demand=object())
    elif case == "oracle":
        config = RenderConfig(traversal="oracle")
    elif case == "row_sharded":
        scene = dataclasses.replace(scene, pack_blocks=(scene.tri_pack,))
    elif case == "catcher":
        scene = dataclasses.replace(scene, has_catcher=True)
    elif case == "instanced":
        scene = dataclasses.replace(
            scene, bvh=dataclasses.replace(scene.bvh, num_instances=3))
    assert integrator.shades_on_kernels(scene, config, device) is kernels


def _source() -> str:
    with open(SHADE_CU) as f:
        return f.read()


def test_kernel_names_count_as_shading_not_traversal():
    sys.path.insert(0, REPO)
    try:
        from fovbench.metrics import traversal_ms
    finally:
        sys.path.remove(REPO)
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                       r"(\w+)\s*\(", _source())
    assert sorted(names) == ["resolve_kernel", "shade_kernel"]
    assert not any(traversal_ms.is_traversal(n) for n in names)
    # as the profiler names them: in an anonymous namespace
    assert not traversal_ms.is_traversal(
        "(anonymous namespace)::shade_kernel(ShadeArgs)")


def test_record_layout_matches_the_source():
    src = _source()
    assert f"kRec = {shade.REC_ROWS};" in src
    assert f"kFlags = {shade.REC_FLAGS}," in src


def _hits(scene, n=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    o = torch.tensor([[-30.0, 20.0, 30.0]]).repeat(n, 1)
    d = torch.nn.functional.normalize(
        torch.tensor([[1.0, -0.6, -1.0]]) + 0.2 * torch.randn((n, 3),
                                                              generator=g))
    b = scene.bvh
    hit = traverse.closest_hit(b.table, o, d, torch.ones(n, dtype=torch.bool),
                               0.01, 1e16, *b.walk_args)
    return o, d.contiguous(), hit


def test_packing_reads_what_the_kernels_expect(textured):
    scene, _ = textured
    n = 64
    o, d, hit = _hits(scene, n)
    idx = torch.arange(n)
    st_eta = torch.ones((n,))
    ids = torch.arange(n, dtype=torch.int64)
    key = fold_in(prng_key(4), 2)
    tensors, ints = shade.shade_inputs(scene, idx, o, d, hit, st_eta, ids,
                                       key, True)
    assert (ints["key0"], ints["key1"]) == key_words(key)
    assert ints["n"] == n and ints["rec_rows"] == shade.REC_ROWS
    # the material columns: the rows' own view of each field
    cols = shade.material_columns()
    view = view_rows(scene.tri_pack[:, 12:36])
    for f in shade.SHADE_FIELDS:
        c = ints[f"col_{f}"]
        assert c == cols[f]
        want = getattr(view, f)
        got = scene.tri_pack[:, c: c + want.shape[1]] if want.ndim == 2 \
            else scene.tri_pack[:, c]
        if f == "flags":
            got = got.contiguous().view(torch.int32)
        assert torch.equal(got, want), f
    assert ints["col_tex"] == shade.TEX_COL
    assert torch.equal(scene.tri_pack[:, shade.TEX_COL].contiguous().view(
        torch.int32) >= 0, torch.ones(scene.num_triangles, dtype=torch.bool))
    # the textures and the probe's sample rows
    assert tensors["tex_sizes"].dtype == torch.int64
    assert (ints["tex_count"], ints["tex_h"], ints["tex_w"], 3) == tuple(
        scene.textures.data.shape)
    assert tensors["probe_rows"].shape == (64 * 32, 13)
    assert tensors["alias_prob"] is None and tensors["inst"] is None
    assert (ints["probe_w"], ints["probe_h"]) == (64, 32)
    assert ints["has_textures"] == 1 and ints["instanced"] == 0
    assert tensors["rec"].shape == (shade.REC_ROWS, n)
    args = shade.pack(shade.ShadeArgs, shade.SHADE_TENSORS, tensors, ints)
    assert args.tri_pack == scene.tri_pack.data_ptr()
    assert args.alias_prob is None and args.n == n
    assert args.col_roughness == cols["roughness"]


def test_packing_takes_the_alias_arrays_without_sample_rows(monkeypatch):
    monkeypatch.setattr(probe_mod, "SAMPLE_ROWS_MAX_TEXELS", 0)
    meshes, _ = scenes.box_city(n=2, seed=0)
    scene = build_scene(meshes, gradient_sky_probe(width=32, height=16),
                        device="cpu")
    assert scene.probe.sample_rows is None
    o, d, hit = _hits(scene, 8)
    tensors, ints = shade.shade_inputs(
        scene, torch.arange(8), o, d, hit, torch.ones(8), torch.arange(8),
        prng_key(0), False)
    assert tensors["probe_rows"] is None and tensors["tex_data"] is None
    assert tensors["alias_idx"].dtype == torch.int64
    assert ints["has_textures"] == 0 and ints["primary"] == 0
    args = shade.pack(shade.ShadeArgs, shade.SHADE_TENSORS, tensors, ints)
    assert args.probe_rows is None
    assert args.alias_idx == scene.probe.alias_idx.data_ptr()


@pytest.mark.parametrize("fault", ["dtype", "strided", "device"])
def test_packing_refuses_other_tensors(textured, fault):
    scene, _ = textured
    n = 16
    o, d, hit = _hits(scene, n)
    ids = torch.arange(n, dtype=torch.int64)
    if fault == "dtype":
        ids = ids.to(torch.int32)
    elif fault == "strided":
        ids = torch.arange(2 * n, dtype=torch.int64)[::2]
    tensors, ints = shade.shade_inputs(scene, torch.arange(n), o, d, hit,
                                       torch.ones(n), ids, prng_key(0), True)
    if fault == "device":
        tensors["eta"] = torch.ones(n, device="meta")
    with pytest.raises(ValueError):
        shade.pack(shade.ShadeArgs, shade.SHADE_TENSORS, tensors, ints)


def test_resolve_packing_updates_the_state_in_place():
    n = 5
    st = integrator.PathState(
        *(torch.zeros((n, 3)) for _ in range(3)), torch.ones(n),
        *(torch.zeros((n, 3)) for _ in range(4)),
        traces=torch.zeros((), dtype=torch.int64))
    k = 3
    tensors, ints = shade.resolve_inputs(
        torch.arange(k), torch.zeros((shade.REC_ROWS, k)),
        torch.zeros((k, 3)), torch.zeros(k, dtype=torch.bool),
        torch.zeros(k, dtype=torch.bool), st, True, False)
    args = shade.pack(shade.ResolveArgs, shade.RESOLVE_TENSORS, tensors, ints)
    assert args.radiance == st.radiance.data_ptr()
    assert args.traces == st.traces.data_ptr()
    assert (args.n, args.primary, args.has_catcher) == (k, 1, 0)
    assert tensors["alive"].shape == (k,)
