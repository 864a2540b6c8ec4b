"""Wavefront path-tracing integrator (counterpart of the JAX package's
``render/integrator.py`` ``trace_paths`` for untextured, catcher-free,
single-level, non-spectral scenes).

The batch advances one bounce at a time: closest hit (K1), one ``tri_pack``
row gather, probe NEE with MIS, Disney BSDF sampling, occlusion (K2).
Semantics kept from the reference:

- the environment contributes only through NEE; primary misses composite
  the backplate through ``alpha`` in the film stage;
- a vertex's NEE and emission count only if its BSDF sample succeeds
  (pdf > 0);
- emission is added on primary hits only; ``alpha`` is set to 1 on a hit;
- eta flips on transmission; MIS weight = sky_pdf / (bsdf_pdf + sky_pdf);
- the occlusion ray is walked only where its answer can change the result
  (hit, nonzero NEE, successful BSDF sample).

Each bounce works on the rays still alive only (a gather at the start, a
scatter at the end): dead rays' state never changes, so this is the same
result as masking every lane. ``traces`` counts alive rays per bounce plus
the occlusion queries walked.
"""

from __future__ import annotations

from typing import Dict

import torch

from fovpathtracing_optixcodelatest_tpu_torch.config import RenderConfig
from fovpathtracing_optixcodelatest_tpu_torch.models.material import view_rows
from fovpathtracing_optixcodelatest_tpu_torch.ops import bsdf as bsdf_ops
from fovpathtracing_optixcodelatest_tpu_torch.ops import probe_sampling as probe_ops
from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import fold_in, ray_uniforms
from fovpathtracing_optixcodelatest_tpu_torch.ops.sampling import (
    basis_from_vector,
    dot,
    face_forward,
)


def bounce(scene, o, d, throughput, eta_in, ray_ids, key, primary: bool,
           config: RenderConfig):
    """One bounce of K alive rays. Returns the per-ray updates, and the
    bounce's shadow rays (``shadow_origin``, ``shadow_dir``, walked where
    ``shadow_query``)."""
    bvh = scene.bvh
    k = o.shape[0]
    every = torch.ones((k,), dtype=torch.bool, device=o.device)
    hit = traverse.closest_hit(bvh.table, o, d, every, config.tmin,
                               config.tmax, bvh.stack_depth, bvh.arity,
                               bvh.leaf_size)
    hit_mask = hit["hit"]
    attr = scene.tri_pack[torch.clamp(hit["tri_id"], min=0).to(torch.int64)]
    p = torch.where(hit_mask[:, None], o + hit["t"][:, None] * d, o)
    nrm = face_forward(attr[:, 0:3], -d)
    m = view_rows(attr[:, 12:36])
    albedo = m.color
    out_eta = torch.where(eta_in == 1.0, m.eta, 1.0)

    # probe NEE with MIS
    u_all = ray_uniforms(key, ray_ids, 8)
    wi, sky_col, sky_pdf = probe_ops.probe_sample(
        scene.probe, u_all[:, 0], u_all[:, 1]
    )
    view = -d
    nee_pdf = bsdf_ops.bsdf_pdf(m, eta_in, out_eta, nrm, view, wi)
    nee_f = bsdf_ops.bsdf_eval(m, albedo, eta_in, out_eta, nrm, view, wi)
    denom = 0.5 * nee_pdf + 0.5 * sky_pdf
    weight = torch.where(
        denom > 0, 0.5 * sky_pdf / torch.clamp(denom, min=1e-20), 0.0
    )
    valid = (nee_pdf > 0.0) & (weight > 0.0) & (sky_pdf > 0.0)
    light_val = torch.where(
        valid[:, None],
        weight[:, None] * sky_col * nee_f * dot(wi, nrm).abs()[:, None]
        / torch.clamp(sky_pdf, min=1e-20)[:, None],
        0.0,
    )

    # BSDF sample, drawn before the occlusion walk: a failed sample voids
    # the vertex, so its shadow ray is never walked
    u_frame, v_frame = basis_from_vector(nrm)
    l_dir, pdf, _ = bsdf_ops.bsdf_sample(
        m, eta_in, out_eta, u_frame, v_frame, nrm, view, u_all[:, 2:8]
    )
    sample_ok = pdf > 0.0
    occl_query = hit_mask & (light_val.amax(dim=1) > 0.0) & sample_ok
    p, wi = p.contiguous(), wi.contiguous()
    occ = traverse.occluded(bvh.table, p, wi,
                            occl_query, config.tmin, config.tmax,
                            bvh.stack_depth, bvh.arity, bvh.leaf_size)

    nee_contrib = torch.where((~occ)[:, None], light_val, 0.0)
    vert_radiance = throughput * nee_contrib + torch.where(
        hit_mask & primary, 1.0, 0.0
    )[:, None] * m.emission

    f_b = bsdf_ops.bsdf_eval(m, albedo, eta_in, out_eta, nrm, view, l_dir)
    transmitted = dot(l_dir, nrm) <= 0.0
    cont = hit_mask & sample_ok
    thr_scale = (f_b * dot(nrm, l_dir).abs()[:, None]
                 / torch.clamp(pdf, min=1e-20)[:, None])
    return {
        "hit_mask": hit_mask,
        "alive": cont,
        "origin": p,
        "direction": torch.where(hit_mask[:, None], l_dir, d),
        "throughput": torch.where(cont[:, None], throughput * thr_scale,
                                  throughput),
        "eta": torch.where(hit_mask & transmitted, out_eta, eta_in),
        "contrib": torch.where(cont[:, None], vert_radiance, 0.0),
        "normal": nrm,
        "albedo": albedo,
        "occl_queries": occl_query.sum(),
        "shadow_origin": p,
        "shadow_dir": wi,
        "shadow_query": occl_query,
    }


def trace_paths(scene, origin: torch.Tensor, direction: torch.Tensor,
                active: torch.Tensor, key, config: RenderConfig,
                ray_ids: torch.Tensor | None = None) -> Dict[str, torch.Tensor]:
    """Trace N paths to completion.

    ``key`` is a (2,) uint32 key (``ops.rng``); bounce ``depth`` draws its
    uniforms from ``fold_in(key, depth)`` keyed by ``ray_ids`` (default
    arange). Returns radiance, alpha, normal, albedo (N, 3) and ``traces``
    (0-dim int64 tensor)."""
    config.check_supported()
    n, dev = origin.shape[0], origin.device
    if ray_ids is None:
        ray_ids = torch.arange(n, device=dev)
    f3 = lambda v: torch.full((n, 3), v, dtype=torch.float32, device=dev)  # noqa: E731
    o = origin.contiguous().clone()
    d = direction.contiguous().clone()
    throughput = f3(1.0)
    eta = torch.ones((n,), dtype=torch.float32, device=dev)
    radiance, alpha, normal, albedo = f3(0.0), f3(0.0), f3(0.0), f3(0.0)
    traces = torch.zeros((), dtype=torch.int64, device=dev)
    idx = torch.nonzero(active).squeeze(1)
    for depth in range(config.max_depth):
        if idx.numel() == 0:
            break
        b = bounce(scene, o[idx], d[idx], throughput[idx], eta[idx],
                   ray_ids[idx], fold_in(key, depth), depth == 0, config)
        hm = b["hit_mask"]
        o[idx] = b["origin"]
        d[idx] = b["direction"]
        throughput[idx] = b["throughput"]
        eta[idx] = b["eta"]
        radiance[idx] = radiance[idx] + b["contrib"]
        alpha[idx] = torch.where(hm[:, None], 1.0, alpha[idx])
        if depth == 0:
            normal[idx] = torch.where(hm[:, None], b["normal"], 0.0)
            albedo[idx] = torch.where(hm[:, None], b["albedo"], 0.0)
        traces = traces + idx.numel() + b["occl_queries"]
        idx = idx[b["alive"]]
    return {"radiance": radiance, "alpha": alpha, "normal": normal,
            "albedo": albedo, "traces": traces}
