"""The last sampling, probe and checkpoint helpers of the port against the
JAX package on the CPU: ``ops/sampling`` ``onb``,
``uniform_sample_sphere`` and ``uniform_sample_triangle``,
``ops/probe_sampling`` ``_lower_bound_rows`` and ``probe_sample_cdf`` (the
reference's two-level CDF inversion), and ``utils/checkpoint``
``AutoCheckpointer``.

Tolerances: the frame and sample vectors within 1e-6 absolute (the
packages' sqrt, sin and cos, and JAX's summed dot products, round apart by
an ulp or two); the CDF search's rows and columns exact; the CDF sample's
colors exact, directions and pdfs within 1e-6 relative; the checkpoints
written on the same subframes, with the same contents.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fovpathtracing_optixcodelatest_tpu.models import probe as jprobe
from fovpathtracing_optixcodelatest_tpu.ops import probe_sampling as jps
from fovpathtracing_optixcodelatest_tpu.ops import sampling as jsampling
from fovpathtracing_optixcodelatest_tpu.utils import checkpoint as jckpt
from fovpathtracing_optixcodelatest_tpu_torch.models import probe as pprobe
from fovpathtracing_optixcodelatest_tpu_torch.ops import probe_sampling as pps
from fovpathtracing_optixcodelatest_tpu_torch.ops import sampling as psampling
from fovpathtracing_optixcodelatest_tpu_torch.utils import checkpoint as pckpt

ATOL = 1e-6


def _uniforms(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.random((2, n)).astype(np.float32)
    u[:, :4] = [[0.0, 1.0, 0.5, 0.25], [0.0, 1.0, 0.5, 0.75]]
    return u


def test_onb_equals_jax():
    rng = np.random.default_rng(0)
    n = rng.normal(size=(4096, 3))
    # axis-aligned normals and |n.x| == |n.z| ties
    n[:6] = [[1, 0, 0], [0, 1, 0], [0, 0, -1], [1, 0, 1], [-1, 2, 1],
             [0.5, 0.5, -0.5]]
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    jt, jb = jsampling.onb(jnp.asarray(n))
    pt, pb = psampling.onb(torch.from_numpy(n))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=0, atol=ATOL)
    # an orthonormal frame around n
    for a, b in ((pt, pb), (pt, torch.from_numpy(n)), (pb, torch.from_numpy(n))):
        assert psampling.dot(a, b).abs().max() < 1e-6
    assert (psampling.dot(pb, pb) - 1).abs().max() < 1e-6


def test_uniform_samples_equal_jax():
    u1, u2 = _uniforms(4096, 1)
    js = jsampling.uniform_sample_sphere(jnp.asarray(u1), jnp.asarray(u2))
    ps = psampling.uniform_sample_sphere(torch.from_numpy(u1),
                                         torch.from_numpy(u2))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=ATOL)
    assert (psampling.dot(ps, ps) - 1).abs().max() < 1e-6
    ju, jv = jsampling.uniform_sample_triangle(jnp.asarray(u1),
                                               jnp.asarray(u2))
    pu, pv = psampling.uniform_sample_triangle(torch.from_numpy(u1),
                                               torch.from_numpy(u2))
    np.testing.assert_allclose(pu.numpy(), np.asarray(ju), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=ATOL)
    assert ((pu >= 0) & (pv >= 0) & (pu + pv <= 1 + 1e-6)).all()


@pytest.fixture(scope="module")
def probes():
    rng = np.random.default_rng(2)
    data = (rng.random((8, 16, 3)) ** 3 * 4).astype(np.float32)
    data[3] = 0.0  # a black row: a flat step of the marginal CDF
    jp, pp = jprobe.build_cdf(data), pprobe.build_cdf(data)
    for k in ("cdf_x", "cdf_y", "pdf_x", "pdf_y", "data"):
        assert np.array_equal(getattr(pp, k), np.asarray(getattr(jp, k))), k
    return jp, pp


def _cdf_uniforms(pp, n=4096):
    """Random uniforms, then every CDF value exactly (ties at the steps)."""
    r1, r2 = _uniforms(n, 3)
    h, w = pp.cdf_x.shape
    r1[4:4 + h] = pp.cdf_y
    r2[4:4 + w] = pp.cdf_x[2]
    r2[4 + w:4 + 2 * w] = pp.cdf_x[5]
    return r1, r2


def test_lower_bound_rows_equals_jax(probes):
    jp, pp = probes
    r1, r2 = _cdf_uniforms(pp)
    h, w = pp.cdf_x.shape
    row = np.random.default_rng(4).integers(0, h, r2.shape[0]).astype(np.int32)
    row[4:4 + w], row[4 + w:4 + 2 * w] = 2, 5
    flat = pp.cdf_x.reshape(-1)
    want = np.asarray(jps._lower_bound_rows(jnp.asarray(flat), jnp.asarray(row),
                                            w, jnp.asarray(r2)))
    got = pps._lower_bound_rows(torch.from_numpy(flat), torch.from_numpy(row),
                                w, torch.from_numpy(r2))
    np.testing.assert_array_equal(got.numpy(), want)
    # lower bound: the first column whose CDF value is >= the uniform
    ref = np.asarray([np.searchsorted(pp.cdf_x[r], v, side="left")
                      for r, v in zip(row, r2)])
    np.testing.assert_array_equal(got.numpy(), ref)


def test_probe_sample_cdf_equals_jax(probes):
    jp, pp = probes
    r1, r2 = _cdf_uniforms(pp)
    jd, jc, jpdf = jps.probe_sample_cdf(jp, jnp.asarray(r1), jnp.asarray(r2))
    pd, pc, ppdf = pps.probe_sample_cdf(pp, torch.from_numpy(r1),
                                        torch.from_numpy(r2))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ppdf.numpy(), np.asarray(jpdf), rtol=1e-6)
    # the black row is never chosen
    assert (pc.sum(-1) > 0).all()
    # the texel: JAX's row search (searchsorted, left side) and column
    # search, step by step
    row, col = pps.cdf_texel(pp, torch.from_numpy(r1), torch.from_numpy(r2))
    jrow = jnp.clip(jnp.searchsorted(jnp.asarray(jp.cdf_y), jnp.asarray(r1),
                                     side="left"), 0, jp.height - 1)
    jcol = jnp.clip(jps._lower_bound_rows(jnp.asarray(jp.cdf_x).reshape(-1),
                                          jrow, jp.width, jnp.asarray(r2)),
                    0, jp.width - 1)
    np.testing.assert_array_equal(row.numpy(), np.asarray(jrow))
    np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))


def _renderer(canvas, subframe):
    return types.SimpleNamespace(canvas=canvas, subframe=subframe)


def test_auto_checkpointer_equals_jax(tmp_path):
    canvas = np.random.default_rng(5).random((6, 8, 4)).astype(np.float32)
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jauto = jckpt.AutoCheckpointer(jpath, every=3)
    pauto = pckpt.AutoCheckpointer(ppath, every=3)
    assert pckpt.AutoCheckpointer("x").every == jckpt.AutoCheckpointer(
        "x").every == 32
    wrote = []
    for sub in range(8):
        j = jauto.maybe(_renderer(canvas * sub, sub))
        p = pauto.maybe(_renderer(torch.from_numpy(canvas * sub), sub))
        assert j == p
        if p:
            wrote.append(sub)
            a, b = np.load(jpath), np.load(ppath)
            assert set(a.files) == set(b.files) == {"canvas", "subframe"}
            for k in a.files:
                np.testing.assert_array_equal(b[k], a[k])
            assert int(b["subframe"]) == sub
    assert wrote == [3, 6]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["jax.npz",
                                                         "port.npz"]
