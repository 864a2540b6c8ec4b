"""``Renderer`` built the JAX package's ways in the port, against the JAX
package on the CPU: ``Renderer(meshes=...)`` as the README's library
example writes it, with ``probe=`` and ``texture_images=``, and
``Renderer(scene=..., probe=...)``, which swaps the scene's probe.

Tolerances are the port's frame gate: at least 99% of the pixels within
1 LSB, and the traces count exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu import config as jconfig
from fovpathtracing_optixcodelatest_tpu.models import scenes as jscenes
from fovpathtracing_optixcodelatest_tpu.models.probe import (
    constant_probe as j_constant_probe,
)
from fovpathtracing_optixcodelatest_tpu.models.scene import build_scene as j_build
from fovpathtracing_optixcodelatest_tpu.render.renderer import Renderer as JRenderer
from fovpathtracing_optixcodelatest_tpu_torch import config as pconfig
from fovpathtracing_optixcodelatest_tpu_torch.models import scenes as pscenes
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import constant_probe
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import Scene, build_scene
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import Renderer

torch.set_num_threads(2)

W, H = 32, 24


def _frames_agree(jr, pr, cam, pcam):
    """Render one frame with each renderer and hold them to the gate."""
    jr.set_camera(dataclasses.replace(cam, aspect=W / H))
    pr.set_camera(dataclasses.replace(pcam, aspect=W / H))
    want, got = jr.render(), pr.render()
    assert got.shape == (H, W, 3) and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int)).max(axis=-1)
    assert (d <= 1).mean() >= 0.99, (d <= 1).mean()
    assert pr.stats["traces"] == jr.stats["traces"]
    return got


def _cfgs(**kw):
    return (jconfig.RenderConfig(width=W, height=H, **kw),
            pconfig.RenderConfig(width=W, height=H, **kw))


def test_readme_example_renders_as_jax():
    """The README's ``Renderer(meshes=..., config=..., schedule=...)`` on
    ``scenes.cornell()``."""
    jmeshes, cam = jscenes.cornell()
    pmeshes, pcam = pscenes.cornell()
    jcfg, pcfg = _cfgs(max_depth=2)
    jr = JRenderer(meshes=jmeshes, config=jcfg,
                   schedule=jconfig.FoveationSchedule.uniform(2))
    pr = Renderer(meshes=pmeshes, config=pcfg,
                  schedule=pconfig.FoveationSchedule.uniform(2),
                  device="cpu")
    assert pr.scene.device.type == "cpu"
    frame = _frames_agree(jr, pr, cam, pcam)
    assert frame.std() > 1.0


def test_meshes_with_probe_and_textures_as_jax():
    """``probe=`` and ``texture_images=`` go into the scene the renderer
    builds, as in the JAX package's ``tests/test_textured_scene.py``."""
    jmeshes, cam, jimages = jscenes.box_city_textured(n=3, seed=5)
    pmeshes, pcam, pimages = pscenes.box_city_textured(n=3, seed=5)
    jcfg, pcfg = _cfgs(max_depth=2)
    jr = JRenderer(meshes=jmeshes, config=jcfg,
                   schedule=jconfig.FoveationSchedule.uniform(1),
                   probe=j_constant_probe((1.5, 1.5, 1.5)),
                   texture_images=jimages)
    pr = Renderer(meshes=pmeshes, config=pcfg,
                  schedule=pconfig.FoveationSchedule.uniform(1),
                  probe=constant_probe((1.5, 1.5, 1.5)),
                  texture_images=pimages, device="cpu")
    assert pr.scene.has_textures
    assert np.allclose(pr.scene.probe.data.numpy(), 1.5)
    _frames_agree(jr, pr, cam, pcam)


def test_scene_with_probe_swaps_the_probe_as_jax():
    """``Renderer(scene=..., probe=...)`` renders the scene under the new
    probe; positional ``Renderer(scene, ...)`` still takes a prebuilt
    scene unchanged."""
    jmeshes, cam = jscenes.box_city(n=3, seed=5)
    pmeshes, pcam = pscenes.box_city(n=3, seed=5)
    jcfg, pcfg = _cfgs(max_depth=2)
    jscene = j_build(jmeshes)
    pscene = build_scene(pmeshes, device="cpu")
    sched_j = jconfig.FoveationSchedule.uniform(1)
    sched_p = pconfig.FoveationSchedule.uniform(1)
    jr = JRenderer(scene=jscene, config=jcfg, schedule=sched_j,
                   probe=j_constant_probe((0.7, 1.1, 1.9)))
    pr = Renderer(scene=pscene, config=pcfg, schedule=sched_p,
                  probe=constant_probe((0.7, 1.1, 1.9)), device="cpu")
    assert pr.scene is not pscene
    swapped = _frames_agree(jr, pr, cam, pcam)

    same = Renderer(pscene, pcfg, sched_p, device="cpu")
    assert same.scene is pscene
    same.set_camera(dataclasses.replace(pcam, aspect=W / H))
    assert (same.render() != swapped).any()


def test_meshes_positional_and_errors():
    meshes, _ = pscenes.cornell(sphere_subdiv=0)
    cfg = pconfig.RenderConfig(width=8, height=8)
    r = Renderer(meshes, cfg, device="cpu")  # JAX's first positional
    assert isinstance(r.scene, Scene) and r.scene.device.type == "cpu"
    with pytest.raises(ValueError, match="provide meshes or a prebuilt scene"):
        Renderer(config=cfg, device="cpu")
    with pytest.raises(ValueError, match="meshes given twice"):
        Renderer(meshes, cfg, device="cpu", meshes=meshes)
