"""BSDF visualisation (counterpart of the JAX package's
``utils/bsdf_viz.py``, after the reference's BSDF test harness): f and pdf
of one material over the lat-long sphere of incoming directions, with
importance-sampled directions marked, so that the sampling can be checked
by eye and by test."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fovpathtracing_optixcodelatest_tpu_torch.models.material import (
    Material,
    packed_rows_numpy,
    view_rows,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import bsdf as bsdf_ops
from fovpathtracing_optixcodelatest_tpu_torch.ops.probe_sampling import (
    dir_to_uv,
    uv_to_dir,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import (
    prng_key,
    uniform,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops.sampling import (
    basis_from_vector,
)


def bsdf_test_image(
    material: Material,
    wo_theta: float = np.pi / 2.05,
    width: int = 512,
    height: int = 256,
    num_samples: int = 1000,
    eta_i: float = 1.0,
    eta_o: float = 1.4,
    seed: int = 0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (image (H, W, 3) float32, sampled uv (S, 2)). R is f's first
    channel, G the pdf, B 0.5; texels of sampled directions are red. The
    sample uniforms are ``jax.random.uniform(PRNGKey(seed), (S, 6))``
    (``ops/rng.uniform``)."""
    f32 = dict(dtype=torch.float32, device=device)
    n = torch.tensor([1.0, 0.0, 0.0], **f32)
    u_axis, v_axis = basis_from_vector(n[None, :])
    u_axis, v_axis = u_axis[0], v_axis[0]
    wo = torch.tensor((-np.sin(wo_theta) * v_axis.cpu().numpy()
                       + np.cos(wo_theta) * n.cpu().numpy()
                       ).astype(np.float32), device=device)

    row = torch.tensor(packed_rows_numpy([material])[0], device=device)
    npix = width * height
    mat = view_rows(row[None, :].expand(npix, 24))
    xs = torch.arange(width, **f32) / width
    ys = torch.arange(height, **f32) / height
    gv, gu = torch.meshgrid(ys, xs, indexing="ij")
    wi = uv_to_dir(torch.stack([gu.reshape(-1), gv.reshape(-1)], dim=-1))

    full = lambda v, k: v[None, :].expand(k, 3)  # noqa: E731
    albedo = torch.tensor(material.color, **f32)
    ei = torch.full((npix,), eta_i, **f32)
    eo = torch.full((npix,), eta_o, **f32)
    f = bsdf_ops.bsdf_eval(mat, full(albedo, npix), ei, eo, full(n, npix),
                           full(wo, npix), wi)
    pdf = bsdf_ops.bsdf_pdf(mat, ei, eo, full(n, npix), full(wo, npix), wi)
    img = torch.stack([f[:, 0], pdf, torch.full((npix,), 0.5, **f32)],
                      dim=-1).reshape(height, width, 3)

    s = num_samples
    us = torch.tensor(uniform(prng_key(seed), (s, 6)), device=device)
    light, _pdf, _t = bsdf_ops.bsdf_sample(
        view_rows(row[None, :].expand(s, 24)),
        torch.full((s,), eta_i, **f32), torch.full((s,), eta_o, **f32),
        full(u_axis, s), full(v_axis, s), full(n, s), full(wo, s), us)
    uv = dir_to_uv(light).cpu().numpy()

    image = img.cpu().numpy().copy()
    px = np.clip((uv[:, 0] * width).astype(int), 0, width - 1)
    py = np.clip((uv[:, 1] * height).astype(int), 0, height - 1)
    image[py, px] = [1.0, 0.0, 0.0]
    return image, uv

