"""The PyTorch port's shadow catcher, AOV frame, denoiser and Renderer
schedule/size changes against the JAX package on the CPU.

Tolerances: per-ray radiance / alpha / normal / albedo within rtol 1e-3 /
atol 1e-5 on at least 99% of the rays and ``traces`` exact; frames: at
least 99% of the pixels within 1 LSB; linear AOV images within rtol 1e-3 /
atol 1e-5 on at least 99% of the pixels; ``atrous_denoise`` on the same
inputs within 1e-5 relative to the image's largest value (XLA and PyTorch
round ``exp`` and the 25-tap sums differently; measured 2.7e-7 on this
file's inputs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fovpathtracing_optixcodelatest_tpu import config as jconfig
from fovpathtracing_optixcodelatest_tpu.models import material as jmaterial
from fovpathtracing_optixcodelatest_tpu.models import mesh as jmesh
from fovpathtracing_optixcodelatest_tpu.models.camera import Camera as JCamera
from fovpathtracing_optixcodelatest_tpu.models.probe import (
    constant_probe as j_constant,
)
from fovpathtracing_optixcodelatest_tpu.models.probe import (
    gradient_sky_probe as j_sky,
)
from fovpathtracing_optixcodelatest_tpu.models.scene import build_scene as j_build
from fovpathtracing_optixcodelatest_tpu.ops.denoise import (
    atrous_denoise as j_denoise,
)
from fovpathtracing_optixcodelatest_tpu.render.renderer import Renderer as JRenderer
from fovpathtracing_optixcodelatest_tpu_torch import config as pconfig
from fovpathtracing_optixcodelatest_tpu_torch.models.material import (
    MATERIAL_FLAG_SHADOW_CATCHER,
    Material,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import make_quad
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
    scene_from_arrays,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops.denoise import atrous_denoise
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import Renderer
from test_torch_textures import (
    _camera_rays,
    compare_trace_paths,
    jax_scene_arrays,
)

torch.set_num_threads(2)

W, H = 32, 24


def to_jax_meshes(meshes):
    """The port's host meshes as the JAX package's (same fields)."""
    return [jmesh.HostMesh(
        vertex=m.vertex, index=m.index, normal=m.normal, texcoord=m.texcoord,
        material=jmaterial.Material(**dataclasses.asdict(m.material)),
        diffuse_texture_id=m.diffuse_texture_id) for m in meshes]


def _two_pass(cfg, r=5):
    return cfg.FoveationSchedule(passes=(
        cfg.FoveationPass(factor=4, spp=2, r_inner=float(r), r_outer=1e9,
                          redraw=False),
        cfg.FoveationPass(factor=1, spp=4, r_inner=0.0, r_outer=float(r + 1),
                          redraw=True, launch_w=2 * (r + 1),
                          launch_h=2 * (r + 1), centered=True,
                          center_offset=r + 1),
    ))


@pytest.fixture(scope="module")
def cornell_catcher():
    meshes, cam, images = chip_smoke.catcher_cornell()
    jscene = j_build(to_jax_meshes(meshes), probe=j_sky(width=64, height=32),
                     texture_images=images)
    assert jscene.materials.has_catcher and jscene.geom.has_textures
    pscene = scene_from_arrays(jax_scene_arrays(jscene), device="cpu")
    assert pscene.has_catcher and pscene.has_textures
    return jscene, pscene, JCamera(**dataclasses.asdict(cam))


def test_catcher_cornell_trace_paths_per_ray(cornell_catcher):
    jscene, pscene, cam = cornell_catcher
    w, h = 40, 30
    key = jax.random.fold_in(jax.random.PRNGKey(8), 2)
    rays = _camera_rays(cam, w, h, 2, key)
    got, _ = compare_trace_paths(
        jscene, pscene, rays, jax.random.fold_in(key, 1),
        jconfig.RenderConfig(width=w, height=h),
        pconfig.RenderConfig(width=w, height=h))
    alpha = got["alpha"].numpy()[:, 0]
    # rays whose catcher hit found its NEE blocked carry a shadow alpha
    # (neither a miss's 0 nor a hit's 1)
    assert ((alpha != 0) & (alpha != 1)).sum() > 5
    assert (alpha == 1.0).mean() > 0.5


@pytest.mark.parametrize("passthrough", [2, 0])
def test_catcher_passthrough_per_ray(passthrough):
    # a mirror turns rays down into rays through a catcher plate towards a
    # lit wall: on secondary rays the plate is transparent
    s2 = 1.0 / np.sqrt(2.0)
    e1, e2 = np.array([0.0, 0.0, 1.0]), np.array([s2, -s2, 0.0])
    c = [tuple(5 * (a * e1 + b * e2))
         for a, b in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
    meshes = [
        make_quad(*c, Material(color=(1, 1, 1), metallic=1.0, roughness=0.01,
                               specular=1.0, transmission=0.0)),
        make_quad((5, -1.5, -1.5), (5, 1.5, -1.5), (5, 1.5, 1.5),
                  (5, -1.5, 1.5),
                  Material(color=(1, 1, 1), roughness=1.0,
                           flags=MATERIAL_FLAG_SHADOW_CATCHER)),
        make_quad((8, -10, -10), (8, 10, -10), (8, 10, 10), (8, -10, 10),
                  Material(color=(1, 1, 1), roughness=1.0, metallic=0.0,
                           specular=0.0)),
    ]
    jscene = j_build(to_jax_meshes(meshes), probe=j_constant((2.0, 2.0, 2.0)))
    pscene = scene_from_arrays(jax_scene_arrays(jscene), device="cpu")
    n = 256
    rng = np.random.default_rng(3)
    o = np.stack([rng.uniform(-1, 1, n), np.full(n, 10.0),
                  rng.uniform(-1, 1, n)], 1).astype(np.float32)
    d = np.tile([[0.0, -1.0, 0.0]], (n, 1)).astype(np.float32)
    rays = {"origin": jnp.asarray(o), "direction": jnp.asarray(d),
            "active": jnp.ones(n, bool),
            "ray_ids": jnp.arange(n, dtype=jnp.int32)}
    got, want = compare_trace_paths(
        jscene, pscene, rays, jax.random.PRNGKey(1),
        jconfig.RenderConfig(width=16, height=16,
                             catcher_passthrough=passthrough),
        pconfig.RenderConfig(width=16, height=16,
                             catcher_passthrough=passthrough))
    if passthrough:
        # the re-traces count: more than the alive rays and queries alone
        assert int(got["traces"]) > 2 * n


@pytest.fixture(scope="module")
def aov_renders(cornell_catcher):
    """Two subframes through render_aov, then a new schedule and a new
    size, in both packages."""
    jscene, pscene, cam = cornell_catcher
    pcam = chip_smoke.catcher_cornell()[1]
    out = {}
    for name, cfg, r in (
        ("jax", jconfig, JRenderer(scene=jscene,
                                   config=jconfig.RenderConfig(width=W,
                                                               height=H),
                                   schedule=_two_pass(jconfig))),
        ("port", pconfig, Renderer(pscene, pconfig.RenderConfig(width=W,
                                                                height=H),
                                   _two_pass(pconfig), device="cpu")),
    ):
        camera = cam if name == "jax" else pcam
        r.set_camera(dataclasses.replace(camera, aspect=W / H))
        frames, aovs = [], []
        for _ in range(2):
            f, a = r.render_aov()
            frames.append(f)
            aovs.append({k: np.asarray(v) for k, v in a.items()})
        traces = r.stats["traces"]
        r.set_schedule(cfg.FoveationSchedule.uniform(1))
        after_schedule = (r.subframe, tuple(r.canvas.shape))
        r.resize((24, 16))
        after_resize = (r.subframe, tuple(r.canvas.shape), r.config.width,
                        r.config.height)
        resized = [r.render() for _ in range(2)]
        out[name] = dict(frames=frames, aovs=aovs, traces=traces,
                         after_schedule=after_schedule,
                         after_resize=after_resize, resized=resized,
                         linear=r.linear_frame())
    return out


def _lsb_share(a, b):
    return float((np.abs(a.astype(int) - b.astype(int)).max(-1) <= 1).mean())


def test_render_aov_frames_and_aovs(aov_renders):
    j, p = aov_renders["jax"], aov_renders["port"]
    assert p["traces"] == j["traces"]
    for fj, fp in zip(j["frames"], p["frames"]):
        assert fp.shape == (H, W, 3) and fp.dtype == np.uint8
        assert _lsb_share(fp, fj) >= 0.99
    for aj, ap in zip(j["aovs"], p["aovs"]):
        assert set(ap) == {"accum", "normal", "albedo"}
        for k in ap:
            assert ap[k].shape == (H, W, 3)
            ok = np.isclose(ap[k], aj[k], rtol=1e-3, atol=1e-5).all(-1)
            assert ok.mean() >= 0.99, (k, ok.mean())
    # the albedo AOV sees the textures and the normal AOV the walls
    assert len(np.unique(p["aovs"][1]["albedo"].reshape(-1, 3), axis=0)) > 20
    assert np.abs(p["aovs"][1]["normal"]).max() > 0.5


def test_set_schedule_and_resize_match_jax(aov_renders):
    j, p = aov_renders["jax"], aov_renders["port"]
    assert p["after_schedule"] == j["after_schedule"]
    assert p["after_resize"] == j["after_resize"]
    for fj, fp in zip(j["resized"], p["resized"]):
        assert fp.shape == (16, 24, 3)
        assert _lsb_share(fp, fj) >= 0.99
    assert p["linear"].shape == (16, 24, 3)


def test_atrous_denoise_matches_jax(aov_renders):
    a = aov_renders["jax"]["aovs"][1]
    rng = np.random.default_rng(5)
    noisy = a["accum"] * rng.uniform(0.5, 1.5, a["accum"].shape).astype(
        np.float32)
    want = np.asarray(j_denoise(jnp.asarray(noisy), jnp.asarray(a["normal"]),
                                jnp.asarray(a["albedo"])))
    got = atrous_denoise(torch.tensor(noisy), torch.tensor(a["normal"]),
                         torch.tensor(a["albedo"])).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # it filters: the noise shrinks
    assert np.abs(np.diff(got, axis=1)).mean() < np.abs(
        np.diff(noisy, axis=1)).mean()
