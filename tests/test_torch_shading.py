"""The PyTorch port's shading ops against the JAX package on the same numpy
inputs: Disney BSDF pdf / eval / sample, probe lookup / pdf / alias
sampling, the shading frame, the tone map and the film composite.

Tolerances: the two packages evaluate the same expressions, but XLA on the
CPU contracts multiply-adds into FMAs and its sin/cos/sqrt/acos/atan2/pow
differ from PyTorch's by up to an ulp. Elementwise results are held to
rtol 1e-4 / atol 1e-6 on every element except where a discrete branch flips on a value within an
ulp of its threshold; such elements must stay under 0.2% of the batch.
Integer outputs (texel indices, sample types, uint8 pixels) are exact or
within 1 LSB as stated per test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu.models.material import (
    Material as JMaterial,
)
from fovpathtracing_optixcodelatest_tpu.models.material import MaterialTable
from fovpathtracing_optixcodelatest_tpu.models.probe import (
    gradient_sky_probe as j_sky,
)
from fovpathtracing_optixcodelatest_tpu.ops import bsdf as jbsdf
from fovpathtracing_optixcodelatest_tpu.ops import probe_sampling as jprobe
from fovpathtracing_optixcodelatest_tpu.ops import sampling as jsampling
from fovpathtracing_optixcodelatest_tpu.ops import tonemap as jtonemap
from fovpathtracing_optixcodelatest_tpu.render import film as jfilm
from fovpathtracing_optixcodelatest_tpu_torch.config import FoveationPass
from fovpathtracing_optixcodelatest_tpu_torch.models.material import view_rows
from fovpathtracing_optixcodelatest_tpu_torch.models.probe import (
    gradient_sky_probe,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.scene import (
    _device_probe,
    _probe_arrays,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import bsdf as pbsdf
from fovpathtracing_optixcodelatest_tpu_torch.ops import probe_sampling as pprobe
from fovpathtracing_optixcodelatest_tpu_torch.ops import sampling as psampling
from fovpathtracing_optixcodelatest_tpu_torch.ops import tonemap as ptonemap
from fovpathtracing_optixcodelatest_tpu_torch.render import film as pfilm

torch.set_num_threads(2)

N = 4096
RTOL, ATOL = 1e-4, 1e-6
MAX_FLIP_SHARE = 0.002


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    ok = np.isclose(got, want, rtol=rtol, atol=atol, equal_nan=True)
    if ok.ndim > 1:
        ok = ok.reshape(ok.shape[0], -1).all(axis=1)
    return ok


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def shading_inputs():
    rng = np.random.default_rng(11)
    mats = [
        JMaterial(
            color=tuple(rng.uniform(0.05, 0.95, 3)),
            emission=tuple(rng.uniform(0, 1, 3)),
            eta=float(rng.choice([0.0, 1.33, 1.5])),
            metallic=float(rng.uniform()), subsurface=float(rng.choice([0, 0.3])),
            specular=float(rng.uniform()), roughness=float(rng.uniform(0.05, 1)),
            specular_tint=float(rng.uniform()), sheen=0.0,
            clearcoat=float(rng.choice([0, 0.5])),
            clearcoat_gloss=float(rng.uniform()),
            transmission=float(rng.choice([0.0, 0.0, 0.4, 1.0])),
        )
        for _ in range(12)
    ]
    rows = MaterialTable.packed_rows_numpy(mats)[rng.integers(0, 12, N)]
    n = _unit(rng, N)
    view = _unit(rng, N)
    view = np.where((view * n).sum(1, keepdims=True) < 0, -view, view)
    light = _unit(rng, N)
    eta_i = rng.choice([1.0, 1.4], N).astype(np.float32)
    eta_o = np.where(eta_i == 1.0, rows[:, 9], 1.0).astype(np.float32)
    uni = rng.random((N, 6)).astype(np.float32)
    jm = MaterialTable.from_materials(mats).view_rows(jnp.asarray(rows))
    pm = view_rows(torch.from_numpy(rows))
    j = dict(n=jnp.asarray(n), view=jnp.asarray(view), light=jnp.asarray(light),
             eta_i=jnp.asarray(eta_i), eta_o=jnp.asarray(eta_o),
             uni=jnp.asarray(uni))
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in j.items()}
    return jm, pm, j, p, rows


def test_bsdf_pdf_and_eval(shading_inputs):
    jm, pm, j, p, rows = shading_inputs
    want = jbsdf.bsdf_pdf(jm, j["eta_i"], j["eta_o"], j["n"], j["view"],
                          j["light"])
    got = pbsdf.bsdf_pdf(pm, p["eta_i"], p["eta_o"], p["n"], p["view"],
                         p["light"])
    assert _close(got, want).all()
    albedo_j, albedo_p = jm.color, pm.color
    want = jbsdf.bsdf_eval(jm, albedo_j, j["eta_i"], j["eta_o"], j["n"],
                           j["view"], j["light"])
    got = pbsdf.bsdf_eval(pm, albedo_p, p["eta_i"], p["eta_o"], p["n"],
                          p["view"], p["light"])
    assert _close(got, want).all()


def test_bsdf_sample(shading_inputs):
    jm, pm, j, p, rows = shading_inputs
    ju, jv = jsampling.basis_from_vector(j["n"])
    pu, pv = psampling.basis_from_vector(p["n"])
    assert _close(pu, ju).all() and _close(pv, jv).all()
    jl, jpdf, jt = jbsdf.bsdf_sample(jm, j["eta_i"], j["eta_o"], ju, jv,
                                     j["n"], j["view"], j["uni"])
    pl, ppdf, pt = pbsdf.bsdf_sample(pm, p["eta_i"], p["eta_o"], pu, pv,
                                     p["n"], p["view"], p["uni"])
    same_type = pt.numpy() == np.asarray(jt)
    assert 1 - same_type.mean() <= MAX_FLIP_SHARE
    ok = _close(pl, jl) & _close(ppdf, jpdf, rtol=1e-3) & same_type
    assert 1 - ok.mean() <= MAX_FLIP_SHARE
    assert len(np.unique(np.asarray(jt))) == 3  # every lobe was exercised


def test_shading_frame_helpers(shading_inputs):
    _, _, j, p, _ = shading_inputs
    assert _close(psampling.face_forward(p["n"], p["light"]),
                  jsampling.face_forward(j["n"], j["light"])).all()
    assert _close(psampling.safe_normalize(p["light"] * 3.0),
                  jsampling.safe_normalize(j["light"] * 3.0)).all()
    assert _close(psampling.dot(p["n"], p["view"]),
                  jsampling.dot(j["n"], j["view"])).all()


@pytest.fixture(scope="module")
def probes():
    return j_sky(width=64, height=32), _device_probe(
        _probe_arrays(gradient_sky_probe(width=64, height=32)), "cpu")


def test_probe_lookup_and_pdf(probes):
    jp, pp = probes
    d = _unit(np.random.default_rng(4), N)
    juv = jprobe.dir_to_uv(jnp.asarray(d))
    puv = pprobe.dir_to_uv(torch.from_numpy(d))
    assert _close(puv, juv).all()
    assert _close(pprobe.uv_to_dir(puv), jprobe.uv_to_dir(juv)).all()
    # nearest-texel fetches: identical unless a uv lands within an ulp of a
    # texel edge
    ok = _close(pprobe.probe_eval(pp, puv), jprobe.probe_eval(jp, juv), 0, 0)
    assert 1 - ok.mean() <= MAX_FLIP_SHARE
    ok = _close(pprobe.probe_pdf(pp, torch.from_numpy(d)),
                jprobe.probe_pdf(jp, jnp.asarray(d)))
    assert 1 - ok.mean() <= MAX_FLIP_SHARE


def test_probe_alias_sampling(probes):
    jp, pp = probes
    r = np.random.default_rng(8).random((2, N)).astype(np.float32)
    jd, jc, jpdf = jprobe.probe_sample(jp, jnp.asarray(r[0]), jnp.asarray(r[1]))
    pd, pc, ppdf = pprobe.probe_sample(pp, torch.from_numpy(r[0]),
                                       torch.from_numpy(r[1]))
    assert torch.equal(pc, torch.from_numpy(np.asarray(jc)))  # same texels
    assert _close(pd, jd).all()
    assert _close(ppdf, jpdf).all()


def test_tonemap_within_one_lsb():
    rng = np.random.default_rng(2)
    c = (rng.gamma(0.6, 0.3, (20000, 3))).astype(np.float32)
    want = np.asarray(jtonemap.postprocess(jnp.asarray(c))).astype(int)
    got = ptonemap.postprocess(torch.from_numpy(c)).numpy().astype(int)
    d = np.abs(got - want)
    assert d.max() <= 1
    assert (d == 0).mean() >= 0.999


@pytest.mark.parametrize("redraw,subframe", [(False, 0), (False, 3),
                                             (True, 2)])
def test_film_composite_matches_jax(redraw, subframe):
    rng = np.random.default_rng(subframe)
    p = FoveationPass(factor=2, spp=4, r_inner=0.0, r_outer=9.0,
                      redraw=redraw, launch_w=9, launch_h=9, centered=True,
                      center_offset=9)
    canvas = rng.random((48 + 36, 64 + 36, 3)).astype(np.float32)
    accum = rng.random((9, 9, 3)).astype(np.float32)
    ring = rng.random((9, 9)) < 0.7
    want = jfilm.composite_pass(
        jnp.asarray(canvas), jnp.asarray(accum), jnp.asarray(ring), p,
        (jnp.int32(32 - 9), jnp.int32(24 - 9)), jnp.int32(subframe), 18, True)
    got = pfilm.composite_pass(
        torch.from_numpy(canvas.copy()), torch.from_numpy(accum),
        torch.from_numpy(ring), p, (32 - 9, 24 - 9), subframe, 18, True)
    assert np.array_equal(got.numpy(), np.asarray(want))
