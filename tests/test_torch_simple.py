"""The PyTorch port's simple renderers (``render/simple.py``) and K2's
plain non-culling walk against the JAX package on the CPU.

``solid_color`` and ``test_pattern`` equal JAX's bit for bit; ``raycast``
(the 04 twin) passes the JAX test's checks on its scene
(``tests/test_features.py``) and agrees with JAX's ``simple.raycast`` on at
least 99% of the pixels within 1 LSB; ``occluded_plain`` with
``cull_backface=False`` equals ``traverse8.occluded(cull_backface=False)``
and the brute-force answer without culling.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fovpathtracing_optixcodelatest_tpu.models import scenes as jscenes
from fovpathtracing_optixcodelatest_tpu.models.camera import Camera as JCamera
from fovpathtracing_optixcodelatest_tpu.models.material import (
    Material as JMaterial,
)
from fovpathtracing_optixcodelatest_tpu.models.mesh import make_quad as j_quad
from fovpathtracing_optixcodelatest_tpu.models.scene import build_scene as j_build
from fovpathtracing_optixcodelatest_tpu.models.texture import (
    checkerboard as j_checkerboard,
)
from fovpathtracing_optixcodelatest_tpu.ops import traverse8
from fovpathtracing_optixcodelatest_tpu.render import simple as jsimple
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import build_scene
from fovpathtracing_optixcodelatest_tpu_torch.ops import intersect, traverse
from fovpathtracing_optixcodelatest_tpu_torch.render import simple

torch.set_num_threads(2)

TMIN, TMAX = 0.01, 1e16


@pytest.mark.parametrize("w,h", [(16, 8), (37, 21), (300, 270)])
def test_solid_color_and_pattern_match_jax(w, h):
    for color in ((1.0, 0.0, 0.0), (0.0, 0.3, 0.8), (0.5, 1.5, -0.2)):
        got = simple.solid_color(w, h, color, device="cpu").numpy()
        assert np.array_equal(got, np.asarray(jsimple.solid_color(w, h,
                                                                  color)))
    got = simple.test_pattern(w, h, device="cpu").numpy()
    assert np.array_equal(got, np.asarray(jsimple.test_pattern(w, h)))
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    assert len(np.unique(got[..., 0])) == 2  # the checker in red


def _jax_raycast_scene():
    floor = j_quad((-5, 0, 5), (5, 0, 5), (5, 0, -5), (-5, 0, -5),
                   JMaterial(color=(1.0, 1.0, 1.0), emission=(0, 0, 0)))
    wall = j_quad((-1, 0, 0), (1, 0, 0), (1, 2, 0), (-1, 2, 0),
                  JMaterial(color=(1.0, 0.2, 0.2), emission=(0, 0, 0)),
                  texture_id=0)
    return j_build([floor, wall], texture_images=[j_checkerboard(16, 4)])


def test_raycast_04_twin_matches_jax():
    meshes, images, cam, light = chip_smoke.raycast_scene()
    scene = build_scene(meshes, texture_images=images, device="cpu",
                        shading_normals=True)
    frame = simple.raycast(scene, cam.device_params("cpu"), 64, 48,
                           light_pos=light).numpy()
    assert frame.shape == (48, 64, 3)
    assert frame.max() > 60  # lit geometry
    assert (frame[-1] == 0).all()  # the sky rows are black
    r, g, b = (frame[..., c].astype(int) for c in range(3))
    floor = (abs(r - g) < 3) & (abs(g - b) < 3) & (r > 10)
    vals = r[floor].astype(float)
    assert len(vals) > 100
    assert np.percentile(vals, 95) / max(np.percentile(vals, 5), 1.0) > 1.5
    assert ((r > g + 30) & (r > 20)).sum() > 20  # the textured red wall

    jcam = JCamera(eye=cam.eye, lookat=cam.lookat, fov_y=cam.fov_y,
                   aspect=cam.aspect)
    jframe = np.asarray(jsimple.raycast(_jax_raycast_scene(),
                                        jcam.device_params(), 64, 48,
                                        light_pos=light))
    close = (np.abs(frame.astype(int) - jframe.astype(int)).max(-1)
             <= 1).mean()
    assert close >= 0.99, close


def test_shadow_rays_are_the_raycast_ones():
    meshes, images, cam, light = chip_smoke.raycast_scene()
    scene = build_scene(meshes, texture_images=images, device="cpu")
    so, sd, q = simple.shadow_rays(scene, cam.device_params("cpu"), 64, 48,
                                   light_pos=light)
    assert so.shape == sd.shape == (64 * 48, 3) and q.shape == (64 * 48,)
    # the light vector's far end is the light itself
    lit = so[q] + sd[q]
    assert torch.allclose(lit, torch.tensor(light).expand_as(lit), atol=2e-2)
    # a scene built without shading normals (the default) is refused
    assert scene.shading_normals is None
    with pytest.raises(ValueError):
        simple.raycast(scene, cam.device_params("cpu"), 8, 6)


def test_nocull_occlusion_matches_traverse8_and_brute_force():
    meshes, _ = jscenes.box_city(n=6, seed=1)
    jscene = j_build(meshes)
    pscene = build_scene(scenes.box_city(n=6, seed=1)[0], device="cpu")
    rng = np.random.default_rng(5)
    n = 3000
    o = rng.uniform((-40.0, 0.0, -40.0), (40.0, 25.0, 40.0),
                    (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    act = rng.random(n) < 0.9
    ot, dt, at = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(act)
    b = pscene.bvh
    got = traverse.occluded_plain(b.table, ot, dt, at, TMIN, TMAX,
                                  *b.walk_args, cull_backface=False)
    ref = np.asarray(traverse8.occluded(
        jscene.bvh, jnp.asarray(o), jnp.asarray(d), TMIN, TMAX,
        active=jnp.asarray(act), cull_backface=False))
    assert np.array_equal(got.numpy(), ref)
    tp = pscene.tri_pack
    brute = intersect.brute_force_occluded(
        tp[:, 36:39], tp[:, 39:42], tp[:, 42:45], ot, dt, TMIN, TMAX,
        cull_backface=False) & at
    # the walk can differ from the oracle only on grazing rays
    assert (got == brute).float().mean() >= 0.999
    culled = traverse.occluded_plain(b.table, ot, dt, at, TMIN, TMAX,
                                     *b.walk_args)
    assert not (culled & ~got).any() and (got & ~culled).any()
