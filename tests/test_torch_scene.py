"""The PyTorch port's host scene build against the JAX package: the packed
BVH table, tri_pack, material rows and probe tables must be bit-identical
(both packages compile the same bvh_builder.cpp source with the same
flags), unsupported features must raise, and the port must not import JAX."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu.models import scenes as jscenes
from fovpathtracing_optixcodelatest_tpu.models.mesh import (
    host_triangles as j_host_triangles,
)
from fovpathtracing_optixcodelatest_tpu.models.probe import (
    constant_probe as j_constant_probe,
)
from fovpathtracing_optixcodelatest_tpu.models.probe import (
    gradient_sky_probe as j_gradient_sky_probe,
)
from fovpathtracing_optixcodelatest_tpu.models.scene import build_scene as j_build
from fovpathtracing_optixcodelatest_tpu.ops import bvh8 as jbvh8
from fovpathtracing_optixcodelatest_tpu.ops.bvh_native import collapse_native
from fovpathtracing_optixcodelatest_tpu_torch.config import RenderConfig
from fovpathtracing_optixcodelatest_tpu_torch.models import probe as pprobe
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes as pscenes
from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera
from fovpathtracing_optixcodelatest_tpu_torch.models.material import Material
from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
    host_triangles,
    make_box,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
    build_scene,
    scene_arrays,
    scene_from_arrays,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import bvh_native

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "fovpathtracing_optixcodelatest_tpu_torch")


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.uint32)


@pytest.fixture(scope="module")
def box_city4():
    meshes, _ = jscenes.box_city(n=4, seed=0)
    jscene = j_build(meshes, probe=j_gradient_sky_probe(width=64, height=32))
    pmeshes, _ = pscenes.box_city(n=4, seed=0)
    arrays = scene_arrays(pmeshes, pprobe.gradient_sky_probe(width=64, height=32))
    return jscene, arrays


def test_packed_bvh_table_bit_exact(box_city4):
    jscene, arrays = box_city4
    assert np.array_equal(_bits(jscene.bvh.table), _bits(arrays["bvh_table"]))
    assert jscene.bvh.stack_depth == arrays["bvh_stack_depth"]
    assert jscene.bvh.arity == arrays["bvh_arity"] == 16
    assert jscene.bvh.leaf_size == arrays["bvh_leaf_size"] == 6


def test_tri_pack_and_material_rows_bit_exact(box_city4):
    jscene, arrays = box_city4
    assert arrays["tri_pack"].shape == (4 * 4 * 12 + 12, 48)
    assert np.array_equal(_bits(jscene.geom.tri_pack), _bits(arrays["tri_pack"]))
    assert np.array_equal(_bits(jscene.materials.packed),
                          _bits(arrays["material_rows"]))


@pytest.mark.parametrize("kind", ["sky_small", "sky_default", "constant"])
def test_probe_tables_bit_exact(kind):
    if kind == "sky_small":
        jp, pp = j_gradient_sky_probe(64, 32), pprobe.gradient_sky_probe(64, 32)
    elif kind == "sky_default":
        jp, pp = j_gradient_sky_probe(), pprobe.gradient_sky_probe()
    else:
        jp = j_constant_probe((2.5, 2.5, 2.5))
        pp = pprobe.constant_probe((2.5, 2.5, 2.5))
    for f in ("data", "pdf_x", "pdf_y", "sample_rows", "alias_prob",
              "alias_idx", "pdf_flat", "cdf_x", "cdf_y"):
        assert np.array_equal(np.asarray(getattr(jp, f)), getattr(pp, f)), f


def test_legacy8_table_bit_exact():
    meshes, _ = jscenes.box_city(n=6, seed=2)
    tris = j_host_triangles(meshes)
    boxes, meta, perm = collapse_native(tris, 4, 8)
    jleg = jbvh8.pack_wide_legacy8(boxes, meta, tris, perm, 4)
    pleg = bvh_native.build_legacy8(host_triangles(pscenes.box_city(n=6, seed=2)[0]))
    assert np.array_equal(_bits(jleg.table), _bits(pleg.table))
    assert jleg.stack_depth == pleg.stack_depth


def test_scene_from_arrays_carries_the_jax_scene(box_city4):
    jscene, arrays = box_city4
    jarrays = {
        "bvh_table": np.asarray(jscene.bvh.table),
        "bvh_stack_depth": jscene.bvh.stack_depth,
        "bvh_arity": jscene.bvh.arity,
        "bvh_leaf_size": jscene.bvh.leaf_size,
        "tri_pack": np.asarray(jscene.geom.tri_pack),
        "material_rows": np.asarray(jscene.materials.packed),
        "probe_data": np.asarray(jscene.probe.data),
        "probe_pdf_x": np.asarray(jscene.probe.pdf_x),
        "probe_pdf_y": np.asarray(jscene.probe.pdf_y),
        "probe_sample_rows": np.asarray(jscene.probe.sample_rows),
    }
    a = scene_from_arrays(jarrays, device="cpu")
    b = build_scene(pscenes.box_city(n=4, seed=0)[0],
                    pprobe.gradient_sky_probe(width=64, height=32), device="cpu")
    assert a.device.type == "cpu"
    for x, y in ((a.bvh.table, b.bvh.table), (a.tri_pack, b.tri_pack),
                 (a.material_rows, b.material_rows),
                 (a.probe.sample_rows, b.probe.sample_rows),
                 (a.probe.data, b.probe.data)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert a.bvh.stack_depth == b.bvh.stack_depth


def test_camera_frame_matches_jax():
    for cam in (jscenes.box_city(n=4)[1], jscenes.cornell()[1]):
        jc = dataclasses.replace(cam, aspect=64 / 48)
        pc = Camera(**dataclasses.asdict(jc))
        for x, y in zip(jc.uvw_frame(), pc.uvw_frame()):
            assert np.array_equal(x, y)
        dp = pc.device_params("cpu")
        assert torch.equal(dp.u, torch.from_numpy(pc.uvw_frame()[0]))


def _box(**kw):
    return make_box((0, 0, 0), (1, 1, 1), Material(**kw))


@pytest.mark.parametrize("case, error", [("demand", ValueError),
                                         ("oracle", NotImplementedError)],
                         ids=["demand", "oracle"])
def test_unsupported_features_raise(case, error):
    # demand textures and the oracle are ported: what stays refused is a
    # demand context that lacks a triangle's texture id (ValueError), any
    # intersection backend but "bvh" and "oracle" (NotImplementedError), and
    # the oracle on a two-level table
    with pytest.raises(error):
        if case == "demand":
            from fovpathtracing_optixcodelatest_tpu_torch.models.demand import (
                DemandLoader,
            )

            loader = DemandLoader(max_pages=2, device="cpu")
            loader.create_texture(np.ones((8, 8, 3), np.float32))
            scene_from_arrays(scene_arrays([_box(), make_box(
                (3, 0, 0), (1, 1, 1), Material(), texture_id=1)]),
                device="cpu", demand=loader.launch_prepare())
        else:
            RenderConfig(traversal="treelet").check_supported()


@pytest.mark.parametrize("case", ["texture", "catcher", "sampler",
                                  "instanced", "spectral", "demand",
                                  "oracle"])
def test_formerly_refused_features_build(case):
    # textures, catchers, the stratified/blue-noise samplers, two-level
    # (instanced) scenes, the spectral path, demand-loaded textures and the
    # brute-force oracle are ported
    if case == "demand":
        from fovpathtracing_optixcodelatest_tpu_torch.models.demand import (
            DemandLoader,
        )

        loader = DemandLoader(max_pages=2, device="cpu")
        loader.create_texture(np.ones((8, 8, 3), np.float32))
        scene = build_scene([make_box((0, 0, 0), (1, 1, 1), Material(),
                                      texture_id=0)], device="cpu",
                            demand=loader.launch_prepare())
        assert scene.demand is not None and scene.textures is None
        assert scene.with_demand(None).demand is None
    elif case == "oracle":
        from fovpathtracing_optixcodelatest_tpu_torch.models.instance import (
            instanced,
        )
        from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
            build_scene_instanced,
        )
        from fovpathtracing_optixcodelatest_tpu_torch.render.integrator import (
            trace_paths,
        )
        from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import prng_key

        cfg = RenderConfig(traversal="oracle")
        cfg.check_supported()
        o = torch.tensor([[0.0, 0.0, 5.0]])
        d = torch.tensor([[0.0, 0.0, -1.0]])
        act = torch.ones(1, dtype=torch.bool)
        out = trace_paths(build_scene([_box()], device="cpu"), o, d, act,
                          prng_key(0), cfg)
        assert float(out["alpha"][0, 0]) == 1.0  # the box was hit
        # the oracle walks flattened geometry only
        inst = build_scene_instanced(instanced([_box()], [(0, np.eye(4))]),
                                     device="cpu")
        with pytest.raises(ValueError):
            trace_paths(inst, o, d, act, prng_key(0), cfg)
    elif case == "instanced":
        from fovpathtracing_optixcodelatest_tpu_torch.models.instance import (
            instanced,
        )
        from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
            build_scene_instanced,
        )

        m = np.eye(4)
        m[:3, 3] = (3.0, 0.0, 0.0)
        scene = build_scene_instanced(
            instanced([_box()], [(0, np.eye(4)), (0, m)]), device="cpu")
        b = scene.bvh
        assert b.instanced and b.num_instances == 2
        assert 0 < b.inst_base < b.blas_base == b.inst_base + 2 < b.num_rows
        assert scene.num_triangles == 12
        # a single-level scene has no instance rows
        flat = build_scene([_box()], device="cpu")
        assert not flat.bvh.instanced and flat.bvh.blas_base == 0
    elif case == "spectral":
        RenderConfig(spectral=True).check_supported()
        RenderConfig(spectral=True, dispersion=0.0).check_supported()
    elif case == "texture":
        scene = build_scene([make_box((0, 0, 0), (1, 1, 1), Material(),
                                      texture_id=0)],
                            texture_images=[np.ones((4, 4, 3), np.float32)],
                            device="cpu")
        assert scene.has_textures and not scene.has_catcher
        assert scene.textures.data.shape == (1, 4, 4, 3)
        # a texture id with no image is refused
        with pytest.raises(ValueError):
            build_scene([make_box((0, 0, 0), (1, 1, 1), Material(),
                                  texture_id=1)],
                        texture_images=[np.ones((4, 4, 3), np.float32)],
                        device="cpu")
    elif case == "catcher":
        scene = build_scene([_box(flags=1)], device="cpu")
        assert scene.has_catcher and not scene.has_textures
        assert not build_scene([_box()], device="cpu").has_catcher
    else:
        for sampler in ("stratified", "blue_noise"):
            RenderConfig(sampler=sampler).check_supported()
        with pytest.raises(ValueError):
            RenderConfig(sampler="sobol").check_supported()


def test_entry_points_default_to_cuda():
    # no silent CPU fallback: without a card the default device fails
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        build_scene([_box()])


def test_port_imports_nothing_of_jax():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax\b|jaxlib\b|fovpathtracing_optixcodelatest_tpu\b)",
        re.M,
    )
    # the card's tests run where JAX is not installed
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tests", "test_torch_kernels_cuda.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    # the CLI and the host utilities are covered too
    for sub in ("apps", "utils"):
        assert any(os.sep + sub + os.sep in f for f in files), sub
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not pat.search(src), path
        assert "fovpathtracing_optixcodelatest_tpu." not in src, path
