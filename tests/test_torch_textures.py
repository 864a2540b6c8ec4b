"""The PyTorch port's textures, procedural scenes and textured path tracing
against the JAX package on the CPU.

Tolerances: texture samples within 1e-6 (XLA may contract the lerp's
multiply-adds into FMAs; the port rounds each operation); scene arrays,
meshes and texture images exact; per-ray radiance / alpha / normal /
albedo within rtol 1e-3 / atol 1e-5 on at least 99% of the rays (K1's u/v
and JAX's re-intersection differ by up to 1.2e-6, so a bilinear tap near a
texel boundary may fall on the other texel), ``traces`` exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu import config as jconfig
from fovpathtracing_optixcodelatest_tpu.models import scenes as jscenes
from fovpathtracing_optixcodelatest_tpu.models import texture as jtexture
from fovpathtracing_optixcodelatest_tpu.models.probe import (
    gradient_sky_probe as j_sky,
)
from fovpathtracing_optixcodelatest_tpu.models.scene import build_scene as j_build
from fovpathtracing_optixcodelatest_tpu.render import raygen as jraygen
from fovpathtracing_optixcodelatest_tpu.render.integrator import (
    trace_paths as j_trace_paths,
)
from fovpathtracing_optixcodelatest_tpu_torch import config as pconfig
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes as pscenes
from fovpathtracing_optixcodelatest_tpu_torch.models import texture as ptexture
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
    gradient_sky_probe,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
    scene_arrays,
    scene_from_arrays,
)
from fovpathtracing_optixcodelatest_tpu_torch.render.integrator import trace_paths

torch.set_num_threads(2)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.uint32)


def jax_scene_arrays(jscene) -> dict:
    """The JAX scene's arrays under ``scene_from_arrays``'s keys."""
    p = jscene.probe
    arrays = {
        "bvh_table": np.asarray(jscene.bvh.table),
        "bvh_stack_depth": jscene.bvh.stack_depth,
        "bvh_arity": jscene.bvh.arity,
        "bvh_leaf_size": jscene.bvh.leaf_size,
        "bvh_num_instances": jscene.bvh.num_instances,
        "bvh_inst_base": jscene.bvh.inst_base,
        "bvh_blas_base": jscene.bvh.blas_base,
        "tri_pack": np.asarray(jscene.geom.tri_pack),
        "material_rows": np.asarray(jscene.materials.packed),
        "texture_data": np.asarray(jscene.textures.data),
        "texture_sizes": np.asarray(jscene.textures.sizes),
        "probe_data": np.asarray(p.data),
        "probe_pdf_x": np.asarray(p.pdf_x),
        "probe_pdf_y": np.asarray(p.pdf_y),
    }
    if p.sample_rows is not None:
        arrays["probe_sample_rows"] = np.asarray(p.sample_rows)
    else:
        arrays.update(probe_alias_prob=np.asarray(p.alias_prob),
                      probe_alias_idx=np.asarray(p.alias_idx),
                      probe_pdf_flat=np.asarray(p.pdf_flat))
    return arrays


def test_texture_samples_match_jax():
    rng = np.random.default_rng(11)
    imgs = [
        jtexture.checkerboard(32, 4),
        rng.uniform(0, 1, (17, 23, 3)).astype(np.float32),
        rng.uniform(0, 1, (8, 40, 3)).astype(np.float32),
    ]
    assert np.array_equal(jtexture.checkerboard(32, 4),
                          ptexture.checkerboard(32, 4))
    n = 20000
    ids = rng.integers(-1, 3, n).astype(np.int32)  # -1 included
    uv = rng.uniform(-3, 4, (n, 2)).astype(np.float32)  # negative and > 1
    want = np.asarray(jtexture.sample_bilinear_wrap(
        jtexture.build_texture_array(imgs), jnp.asarray(ids), jnp.asarray(uv)))
    tex = ptexture.build_texture_array(imgs, device="cpu")
    got = ptexture.sample_bilinear_wrap(tex, torch.from_numpy(ids),
                                        torch.from_numpy(uv)).numpy()
    assert np.abs(got - want).max() <= 1e-6
    # the padded array is the JAX one
    jt = jtexture.build_texture_array(imgs)
    assert np.array_equal(tex.data.numpy(), np.asarray(jt.data))
    assert np.array_equal(tex.sizes.numpy(), np.asarray(jt.sizes))


@pytest.mark.parametrize("which", ["box_city_textured", "cornell", "furnace",
                                   "box_city_fast"])
def test_scene_arrays_bit_exact(which):
    images = []
    if which == "box_city_textured":
        jm, jc, jimg = jscenes.box_city_textured(n=4, seed=0)
        pm, pc, images = pscenes.box_city_textured(n=4, seed=0)
        assert len(images) == len(jimg) == 8
        for a, b in zip(images, jimg):
            assert a.dtype == np.float32 and np.array_equal(a, b)
    elif which == "cornell":
        (jm, jc), (pm, pc) = jscenes.cornell(), pscenes.cornell()
    elif which == "furnace":
        (jm, jc), (pm, pc) = jscenes.furnace_sphere(2), pscenes.furnace_sphere(2)
    else:
        (jm, jc) = jscenes.box_city_fast(n=5, seed=1)
        (pm, pc) = pscenes.box_city_fast(n=5, seed=1)
    assert dataclasses.asdict(jc) == dataclasses.asdict(pc)
    assert len(jm) == len(pm)
    for a, b in zip(jm, pm):
        for f in ("vertex", "index", "normal", "texcoord"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert a.diffuse_texture_id == b.diffuse_texture_id
        assert dataclasses.asdict(a.material) == dataclasses.asdict(b.material)
    jscene = j_build(jm, texture_images=images or None)
    arrays = scene_arrays(pm, texture_images=images)
    assert np.array_equal(_bits(jscene.geom.tri_pack), _bits(arrays["tri_pack"]))
    assert np.array_equal(_bits(jscene.bvh.table), _bits(arrays["bvh_table"]))
    assert np.array_equal(_bits(jscene.materials.packed),
                          _bits(arrays["material_rows"]))
    assert np.array_equal(np.asarray(jscene.textures.data),
                          arrays["texture_data"])
    assert np.array_equal(np.asarray(jscene.textures.sizes),
                          arrays["texture_sizes"])
    scene = scene_from_arrays(arrays, device="cpu")
    assert scene.has_textures == bool(images)
    assert scene.has_textures == jscene.geom.has_textures


@pytest.fixture(scope="module")
def textured4():
    meshes, cam, images = jscenes.box_city_textured(n=4, seed=0)
    jscene = j_build(meshes, probe=j_sky(width=64, height=32),
                     texture_images=images)
    pscene = scene_from_arrays(jax_scene_arrays(jscene), device="cpu")
    return jscene, pscene, cam


def _camera_rays(cam, w, h, spp, key):
    cp = dataclasses.replace(cam, aspect=w / h).device_params()
    return jraygen.generate_pass_rays(
        cp, jconfig.FoveationSchedule.uniform(spp).passes[0], w, h,
        jnp.int32(w // 2), jnp.int32(h // 2), key)


def compare_trace_paths(jscene, pscene, rays, path_key, jcfg, pcfg,
                        share=0.99):
    """Both integrators on the same rays; returns the port's output."""
    want = jax.jit(lambda o, d, a, i: j_trace_paths(
        jscene, o, d, a, path_key, jcfg, ray_ids=i))(
        rays["origin"], rays["direction"], rays["active"], rays["ray_ids"])
    got = trace_paths(
        pscene, torch.tensor(np.asarray(rays["origin"])),
        torch.tensor(np.asarray(rays["direction"])),
        torch.tensor(np.asarray(rays["active"])), np.asarray(path_key),
        pcfg, ray_ids=torch.tensor(np.asarray(rays["ray_ids"])))
    assert int(got["traces"]) == int(want["traces"])
    for f in ("radiance", "alpha", "normal", "albedo"):
        ok = np.isclose(got[f].numpy(), np.asarray(want[f]), rtol=1e-3,
                        atol=1e-5).all(axis=1)
        assert ok.mean() >= share, (f, ok.mean())
    return got, want


def test_textured_trace_paths_per_ray(textured4):
    jscene, pscene, cam = textured4
    assert pscene.has_textures and not pscene.has_catcher
    w, h = 48, 32
    key = jax.random.fold_in(jax.random.PRNGKey(3), 1)
    rays = _camera_rays(cam, w, h, 2, key)
    got, want = compare_trace_paths(
        jscene, pscene, rays, jax.random.fold_in(key, 5),
        jconfig.RenderConfig(width=w, height=h),
        pconfig.RenderConfig(width=w, height=h))
    # the albedo AOV really is textured: it varies within one material
    alb = got["albedo"].numpy()
    hit = got["alpha"].numpy()[:, 0] > 0
    assert len(np.unique(alb[hit].round(4), axis=0)) > 40


def test_textured_albedo_differs_from_untextured(textured4):
    # the same geometry without textures: albedo differs on hits only
    jscene, pscene, cam = textured4
    plain = dataclasses.replace(pscene, textures=None)
    w, h = 32, 24
    key = jax.random.PRNGKey(2)
    rays = _camera_rays(cam, w, h, 1, key)
    args = (torch.tensor(np.asarray(rays["origin"])),
            torch.tensor(np.asarray(rays["direction"])),
            torch.tensor(np.asarray(rays["active"])), np.asarray(key),
            pconfig.RenderConfig(width=w, height=h, max_depth=1))
    a = trace_paths(pscene, *args)
    b = trace_paths(plain, *args)
    hit = a["alpha"][:, 0] > 0
    assert torch.equal(a["alpha"], b["alpha"])
    assert torch.equal(a["albedo"][~hit], b["albedo"][~hit])
    assert (a["albedo"][hit] != b["albedo"][hit]).any(dim=1).float().mean() > 0.5
