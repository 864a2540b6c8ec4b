"""The PyTorch port's spectral path (``ops/spectrum.py``,
``render/spectral.py``, ``render/spectral_path.py`` and the integrator's
hero-wavelength mode) against the JAX package on the CPU.

Tolerances: the numpy constants exact; every spectral function within
1e-6 relative (to the largest value; XLA and PyTorch round ``exp`` and the
basis contractions differently); per-ray radiance within rtol 1e-3 / atol
1e-5 on at least 99% of the rays and ``traces`` exact (measured: 100% of
the rays, largest difference 1.7e-4 on values near 1); frames at least 99%
of the pixels within 1 LSB.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu import config as jconfig
from fovpathtracing_optixcodelatest_tpu.models.camera import Camera as JCamera
from fovpathtracing_optixcodelatest_tpu.models.material import (
    Material as JMaterial,
)
from fovpathtracing_optixcodelatest_tpu.models.probe import (
    gradient_sky_probe as j_sky,
)
from fovpathtracing_optixcodelatest_tpu.models.scene import build_scene as j_build
from fovpathtracing_optixcodelatest_tpu.ops import spectrum as jsp
from fovpathtracing_optixcodelatest_tpu.render import integrator as jintegrator
from fovpathtracing_optixcodelatest_tpu.render import spectral as jspectral
from fovpathtracing_optixcodelatest_tpu.render.renderer import Renderer as JRenderer
from fovpathtracing_optixcodelatest_tpu.render.spectral_path import (
    trace_paths_spectral as j_trace_spectral,
)
from fovpathtracing_optixcodelatest_tpu_torch import config as pconfig
from fovpathtracing_optixcodelatest_tpu_torch.models.camera import Camera
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
    scene_from_arrays,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import spectrum as psp
from fovpathtracing_optixcodelatest_tpu_torch.render import integrator
from fovpathtracing_optixcodelatest_tpu_torch.render import spectral
from fovpathtracing_optixcodelatest_tpu_torch.render.renderer import Renderer
from fovpathtracing_optixcodelatest_tpu_torch.render.spectral_path import (
    trace_paths_spectral,
)
from test_spectral_path import _rays_at_sphere, _sphere_scene
from test_torch_textures import jax_scene_arrays

torch.set_num_threads(2)

REL = 1e-6


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max() / scale)


def test_constants_match_jax():
    for name in ("LAMBDA_MIN", "LAMBDA_MAX", "NUM_BINS", "NUM_HERO",
                 "_Y_NORM", "_DL"):
        assert getattr(psp, name) == getattr(jsp, name), name
    for name in ("_LAMBDAS", "_XBAR", "_YBAR", "_ZBAR", "RGB_BASIS",
                 "XYZ_TO_SRGB", "SRGB_TO_XYZ"):
        assert np.array_equal(getattr(psp, name), getattr(jsp, name)), name
    lam = np.linspace(360.0, 740.0, 97)
    for a, b in zip(psp.cie_xyz_bar(lam), jsp.cie_xyz_bar(lam)):
        assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def seeded():
    rng = np.random.default_rng(21)
    return {
        "u": rng.random(257).astype(np.float32),
        "rgb": rng.uniform(0.0, 2.0, (257, 3)).astype(np.float32),
        "spec": rng.uniform(0.0, 1.5, (257, psp.NUM_BINS)).astype(np.float32),
        "lam": rng.uniform(370.0, 730.0, (257, 4)).astype(np.float32),
        "eta": rng.uniform(1.2, 2.4, 257).astype(np.float32),
    }


@pytest.mark.parametrize("fn", [
    "sample_hero_wavelengths", "rgb_to_spectrum", "spectrum_to_xyz",
    "spectrum_to_rgb", "eval_spectrum_at", "cie_xyz_bar",
])
def test_spectrum_functions_match_jax(seeded, fn):
    t = {k: torch.from_numpy(v) for k, v in seeded.items()}
    j = {k: jnp.asarray(v) for k, v in seeded.items()}
    if fn == "sample_hero_wavelengths":
        got, want = psp.sample_hero_wavelengths(t["u"]), \
            jsp.sample_hero_wavelengths(j["u"])
    elif fn == "rgb_to_spectrum":
        got, want = psp.rgb_to_spectrum(t["rgb"]), jsp.rgb_to_spectrum(j["rgb"])
    elif fn == "spectrum_to_xyz":
        got, want = psp.spectrum_to_xyz(t["spec"]), \
            jsp.spectrum_to_xyz(j["spec"])
    elif fn == "spectrum_to_rgb":
        got, want = psp.spectrum_to_rgb(t["spec"]), \
            jsp.spectrum_to_rgb(j["spec"])
    elif fn == "eval_spectrum_at":
        got, want = psp.eval_spectrum_at(t["spec"], t["lam"]), \
            jsp.eval_spectrum_at(j["spec"], j["lam"])
    else:
        got = torch.stack(psp.cie_xyz_bar_torch(t["lam"]))
        want = jnp.stack(jsp.cie_xyz_bar_jnp(j["lam"]))
    _close(got.numpy(), want)


@pytest.mark.parametrize("fn", ["cauchy_eta", "rgb_eval_at",
                                "cie_rgb_matrix"])
def test_integrator_spectral_helpers_match_jax(seeded, fn):
    lam = psp.sample_hero_wavelengths(torch.from_numpy(seeded["u"]))
    jlam = jnp.asarray(lam.numpy())
    if fn == "cauchy_eta":
        for disp in (0.0, 4200.0, 25000.0):
            _close(spectral.cauchy_eta(torch.from_numpy(seeded["eta"]),
                                       lam[:, 0], disp).numpy(),
                   jspectral.cauchy_eta(jnp.asarray(seeded["eta"]),
                                        jlam[:, 0], disp))
    elif fn == "rgb_eval_at":
        _close(integrator._rgb_eval_at(torch.from_numpy(seeded["rgb"]),
                                       lam).numpy(),
               jintegrator._rgb_eval_at(jnp.asarray(seeded["rgb"]), jlam))
    else:
        _close(integrator._cie_rgb_matrix(lam).numpy(),
               jintegrator._cie_rgb_matrix(jlam))


@pytest.fixture(scope="module")
def glass():
    mat = JMaterial(color=(1.0, 1.0, 1.0), metallic=0.0, roughness=0.05,
                    specular=0.5, transmission=1.0, eta=1.5)
    jscene = _sphere_scene(mat, probe_v=1.5)
    return jscene, scene_from_arrays(jax_scene_arrays(jscene), device="cpu")


@pytest.mark.parametrize("dispersion", [20000.0, 0.0])
def test_trace_paths_spectral_matches_jax(glass, dispersion):
    jscene, pscene = glass
    n = 4096
    o, d = _rays_at_sphere(n, seed=2, spread=0.9)
    key = jax.random.PRNGKey(3)
    cfg = jconfig.RenderConfig(width=16, height=16)
    want = jax.jit(lambda o, d: j_trace_spectral(
        jscene, o, d, jnp.ones(n, bool), key, cfg, dispersion=dispersion))(
        o, d)
    got = trace_paths_spectral(
        pscene, torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)),
        torch.ones(n, dtype=torch.bool), np.asarray(key),
        pconfig.RenderConfig(width=16, height=16), dispersion=dispersion)
    assert int(got["traces"]) == int(want["traces"])
    ok = np.isclose(got["radiance"].numpy(), np.asarray(want["radiance"]),
                    rtol=1e-3, atol=1e-5).all(axis=1)
    assert ok.mean() >= 0.99, ok.mean()
    assert np.isfinite(got["radiance"].numpy()).all()


def _lsb_share(a, b):
    return float((np.abs(a.astype(int) - b.astype(int)).max(-1) <= 1).mean())


def test_spectral_frames_match_jax():
    # the dispersive glass sphere under a sky with a sun, through
    # Renderer.render at 32x24 uniform:2, two subframes
    import chip_smoke

    meshes, probe, cam = chip_smoke.glass_sphere()
    from test_torch_catcher_aov import to_jax_meshes

    jscene = j_build(to_jax_meshes(meshes),
                     probe=j_sky(sun_power=30.0, sun_sharpness=40.0))
    pscene = scene_from_arrays(jax_scene_arrays(jscene), device="cpu")
    w, h = 32, 24
    kw = dict(width=w, height=h, spectral=True, dispersion=25000.0)
    jr = JRenderer(scene=jscene, config=jconfig.RenderConfig(**kw),
                   schedule=jconfig.FoveationSchedule.uniform(2))
    pr = Renderer(pscene, pconfig.RenderConfig(**kw),
                  pconfig.FoveationSchedule.uniform(2), device="cpu")
    jc = JCamera(**dataclasses.asdict(dataclasses.replace(cam,
                                                          aspect=w / h)))
    jr.set_camera(jc)
    pr.set_camera(Camera(**dataclasses.asdict(jc)))
    for _ in range(2):
        want, got = np.asarray(jr.render()), pr.render()
        assert _lsb_share(got, want) >= 0.99
    assert got.std() > 1.0  # not a flat frame


def test_spectral_render_matches_jax(glass):
    jscene, pscene = glass
    w, h = 24, 16
    cam = JCamera(eye=(0.0, 0.4, 3.4), lookat=(0.0, 0.0, 0.0), fov_y=42.0,
                  aspect=w / h)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jspectral.spectral_render(
        jscene, cam.device_params(), w, h, dispersion=25000.0, key=key))
    got = spectral.spectral_render(
        pscene, Camera(**dataclasses.asdict(cam)).device_params("cpu"), w, h,
        dispersion=25000.0, key=np.asarray(key)).numpy()
    assert got.shape == want.shape == (h, w, 3) and got.dtype == np.uint8
    assert _lsb_share(got, want) >= 0.99
    assert got.std() > 1.0
