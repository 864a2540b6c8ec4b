"""The 04 raycast of a render-time-instanced scene, and the two-level
occlusion walk without back-face culling, against the JAX package on the
CPU (the JAX function compiled as its own tests run it; the port's
wrappers run their plain versions on CPU tensors).

- ``build_scene_instanced(..., shading_normals=True)`` carries the unique
  meshes' corner normals in their triangle order, and ``simple.raycast``
  of the JAX instancing test's rotated 4 x 4 grid (``tests/
  test_instancing.py`` ``_grid_scene(rot=True)``) at 48x48 matches JAX's
  ``simple.raycast`` of the same scene on at least 99% of the pixels
  within 1 LSB (the share found is printed). Both shade with the unique
  mesh's object-space normals, the instance's transform not applied.
- The port's plain two-level occlusion walk with ``cull_backface=False``
  answers as JAX's ``traverse8.occluded(cull_backface=False)`` on 4,096
  rays of that grid, half of them starting inside its boxes (where only
  back faces occlude): the answers exact, and the port's ``ops/
  traverse8.py`` ``occluded`` (JAX's signature) gives the same.
- The port's ``ops/traverse8.py`` ``closest_hit`` and
  ``closest_hit_staged`` on the grid against JAX's ``closest_hit``:
  ``hit``, ``tri_id`` and ``inst`` exact, ``t`` within the 17 ulp of the
  FMA contraction JAX's CPU build applies to the instance transform
  (ROADMAP §3), ``pending`` all False.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu.models.camera import Camera as JCamera
from fovpathtracing_optixcodelatest_tpu.models.scene import (
    build_scene_instanced as j_build_instanced,
)
from fovpathtracing_optixcodelatest_tpu.ops import traverse8 as jtraverse8
from fovpathtracing_optixcodelatest_tpu.render import simple as jsimple
from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera
from fovpathtracing_optixcodelatest_tpu_torch.models.mesh import (
    shading_normal_rows,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
    build_scene_instanced,
    scene_arrays_instanced,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse, traverse8
from fovpathtracing_optixcodelatest_tpu_torch.render import simple
from test_instancing import _grid_scene, _rays_grid
from test_torch_instancing import to_port_scene

torch.set_num_threads(2)

TMIN, TMAX = 0.01, 1e16
CAMERA = dict(eye=(2.25, 5.0, 8.0), lookat=(2.25, 0.4, 2.25), fov_y=50.0,
              aspect=1.0)


@pytest.fixture(scope="module")
def grid():
    """The JAX test's rotated 4 x 4 grid in both packages: (JAX scene,
    the port's on the CPU with its shading normals)."""
    jsc = _grid_scene(rot=True)
    return (j_build_instanced(jsc),
            build_scene_instanced(to_port_scene(jsc), shading_normals=True,
                                  device="cpu"))


def _ulps(a, b):
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def test_instanced_scene_carries_the_unique_meshes_normals():
    psc = to_port_scene(_grid_scene(rot=True))
    arrays = scene_arrays_instanced(psc, shading_normals=True)
    rows = arrays["shading_normals"]
    # one row a triangle of the unique meshes, as tri_pack, and none
    # without the flag
    assert rows.shape == (arrays["tri_pack"].shape[0], 10)
    assert np.array_equal(rows, shading_normal_rows(psc.unique))
    assert (rows[:, 9] == 1.0).all()
    assert "shading_normals" not in scene_arrays_instanced(psc)


def test_raycast_of_an_instanced_scene_matches_jax(grid):
    jscene, pscene = grid
    assert pscene.bvh.instanced and pscene.shading_normals is not None
    frame = simple.raycast(pscene, Camera(**CAMERA).device_params("cpu"),
                           48, 48).numpy()
    jframe = np.asarray(jsimple.raycast(
        jscene, JCamera(**CAMERA).device_params(), 48, 48))
    assert frame.shape == jframe.shape == (48, 48, 3)
    lit = float((frame.max(-1) > 0).mean())
    share = float((np.abs(frame.astype(int) - jframe.astype(int)).max(-1)
                   <= 1).mean())
    print(f"instanced raycast 48x48: lit {lit:.4f}, pixels within 1 LSB of "
          f"JAX's {share:.4f}")
    assert lit > 0.3 and share >= 0.99, (lit, share)


def _grid_shadow_rays(n=4096, seed=3):
    """Half from above the grid, down onto it; half from inside its boxes
    and balls' cells in every direction (back faces first)."""
    rng = np.random.default_rng(seed)
    k = n // 2
    o_top = np.stack([rng.uniform(-1.0, 6.0, k), np.full(k, 5.0),
                      rng.uniform(-1.0, 6.0, k)], 1)
    d_top = rng.normal(size=(k, 3))
    d_top[:, 1] = -np.abs(d_top[:, 1]) - 1.0
    cell = rng.integers(0, 4, (n - k, 2)) * 1.5
    o_in = np.stack([cell[:, 0] + rng.uniform(-0.3, 0.3, n - k),
                     rng.uniform(0.1, 0.7, n - k),
                     cell[:, 1] + rng.uniform(-0.3, 0.3, n - k)], 1)
    d_in = rng.normal(size=(n - k, 3))
    o = np.concatenate([o_top, o_in]).astype(np.float32)
    d = np.concatenate([d_top, d_in])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def test_plain_nocull_two_level_occlusion_matches_jax(grid):
    jscene, pscene = grid
    o, d = _grid_shadow_rays()
    want = np.asarray(jtraverse8.occluded(jscene.bvh, o, d, TMIN, 30.0,
                                          cull_backface=False))
    b = pscene.bvh
    every = torch.ones(o.shape[0], dtype=torch.bool)
    args = (b.table, torch.from_numpy(o), torch.from_numpy(d), every, TMIN,
            30.0, *b.walk_args)
    got = traverse.occluded_plain(*args, cull_backface=False,
                                  **b.instance_kwargs).numpy()
    culled = traverse.occluded_plain(*args, **b.instance_kwargs).numpy()
    assert np.array_equal(got, want)
    # the rays inside the boxes meet only back faces first
    assert (want & ~culled).sum() > 100 and not (culled & ~want).any()
    # JAX's signature in the port
    assert np.array_equal(traverse8.occluded(
        b, o, d, TMIN, 30.0, cull_backface=False).numpy(), want)


def test_jax_named_closest_hit_on_the_grid_matches_jax(grid):
    jscene, pscene = grid
    o, d = (np.array(x) for x in _rays_grid(4096, seed=3, extent=7.0))
    want = {k: np.asarray(v) for k, v in jtraverse8.closest_hit(
        jscene.bvh, o, d, TMIN, TMAX).items()}
    for fn in (traverse8.closest_hit, traverse8.closest_hit_staged):
        got = {k: v.numpy() for k, v in fn(pscene.bvh, o, d, TMIN,
                                          TMAX).items()}
        assert set(got) == {"t", "tri_id", "u", "v", "hit", "pending",
                            "inst"}
        for k in ("hit", "tri_id", "inst"):
            assert np.array_equal(got[k], want[k]), (fn.__name__, k)
        hit = got["hit"]
        assert 0.05 < hit.mean() < 1.0 and not got["pending"].any()
        ulps = _ulps(got["t"][hit], want["t"][hit]).max()
        print(f"{fn.__name__} on the grid: t within {ulps} ulp of JAX's")
        assert ulps <= 17
