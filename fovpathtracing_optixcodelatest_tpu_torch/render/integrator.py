"""Wavefront path-tracing integrator (counterpart of the JAX package's
``render/integrator.py`` ``trace_paths``).

The batch advances one bounce at a time: closest hit (K1), the catcher
pass-through on secondary rays, one ``tri_pack`` row gather, the texture
fetch, probe NEE with MIS, Disney BSDF sampling, occlusion (K2).
Semantics kept from the reference:

- the environment contributes only through NEE; primary misses composite
  the backplate through ``alpha`` in the film stage;
- a vertex's NEE and emission count only if its BSDF sample succeeds
  (pdf > 0);
- emission is added on primary hits only; ``alpha`` is set to 1 on a hit
  that is not a shadow catcher;
- albedo is the texture's bilinear-wrap sample at the hit's uv (K1's
  barycentrics over ``tri_pack`` cols 3:9) where the triangle has a texture
  id >= 0 (col 10), else the material color;
- a shadow catcher adds no NEE radiance; its alpha gathers the throughput
  times the NEE that its occlusion query found blocked, whether or not its
  BSDF sample succeeds. On secondary rays a catcher is transparent: the ray
  re-traces from the hit point, ``config.catcher_passthrough`` rounds at
  most, and each re-trace counts in ``traces``;
- eta flips on transmission; MIS weight = sky_pdf / (bsdf_pdf + sky_pdf);
- the occlusion ray is walked only where its answer can change the result
  (hit, nonzero NEE, and a successful BSDF sample or a catcher).

The texture fetch and the catcher branches run only on scenes that have
textures or catchers (``Scene.has_textures``, ``Scene.has_catcher``). On a
two-level (instanced) scene K1 also returns each hit's instance, and the
geometric normal, which ``tri_pack`` holds in object space, goes to world
space through the instance row's inverse transform (A^T n, normalised).

On a scene with a demand-texture context (``Scene.demand``) a textured
hit's albedo is instead the point sample of the context's tile atlas
(``models/demand.py``), the tile's mean where the tile is not resident, and
``trace_paths`` returns the frame's page-request bitmap
(``demand_requests``).

``config.traversal == "oracle"`` sends both queries, and the catcher
re-traces, through the brute-force intersector of ``ops/intersect.py`` on
``tri_pack`` columns 36:45 (single-level tables only), masked to the walked
lanes as K1 and K2 answer: an independent check of the kernels.

Spectral mode (``config.spectral``, the hero-wavelength estimator) runs the
same bounce with an (N, ``NUM_HERO``) throughput: the wavelengths come from
``fold_in(key, 7919)``, RGB light, emission and BSDF values are lifted
through the RGB basis at them (``_rgb_eval_at``), transmissive materials
get the Cauchy eta(lambda) of the hero wavelength (``config.dispersion``),
the first dispersive transmission of a path collapses its other
wavelengths (``lam_alive``), and each bounce's spectral contribution is
CIE-integrated to linear sRGB on the spot (``_cie_rgb_matrix``), so the
film's carry stays RGB.

Each bounce works on the rays still alive only (a gather at the start, a
scatter at the end): dead rays' state never changes, so this is the same
result as masking every lane. A catcher lane whose sample failed is alive
in the bounce that finds it, so its occlusion answer and its alpha come in
that bounce before it leaves. ``traces`` counts alive rays per bounce, the
occlusion queries walked and the pass-through re-traces.

On CUDA tensors in RGB, without a demand context, row-sharded triangles
or the oracle (``shades_on_kernels``), a bounce is K1, ``csrc/shade.cu``'s
``shade_kernel``, K2 and its ``resolve_kernel`` (``kernel_bounce``, through
``ops/shade.py``): the shading between the hits and the state update runs
in two launches instead of some 1,400 PyTorch ops, on the same arithmetic.
Everywhere else it is ``plain_bounce`` (``bounce`` and its scatter), the
kernels' plain version, which the card tests hold them to.

The two paths keep their live lanes apart. The plain bounce's lanes are a
host list: the live-lane ``nonzero`` and each bounce's narrowing
``idx[alive]`` wait for the device. On the kernel path they stay on the
card (``kernel_paths``): ``csrc/lanes.cu``'s compaction (``ops/lanes.py``)
writes each bounce's lane list, its length and its rays on the device,
every kernel of the bounce reads the length there, and the lane-sized
buffers (``CardWave``) are allocated once a wavefront at its capacity, so
the host queues the whole wavefront without waiting.

``trace_paths`` is the span ``fov.paths`` and each bounce's loop body the
span ``fov.bounce.<depth>`` (``utils/tracing.py``); on the plain path the
live-lane ``nonzero`` and each narrowing are the syncs ``live_lanes`` and
``narrow``. The lanes entering each depth are counted under ``lanes`` (on
the kernel path from the device's per-depth counts, which reach the
counters after the frame's download), each bounce under ``shade`` and
each wavefront's lane list under ``lane_list``, keyed ``"kernel"`` or
``"plain"`` and ``"device"`` or ``"host"`` by the path it took; each call
counts one wavefront.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from fovpathtracing_optixcodelatest_tpu_torch.config import RenderConfig
from fovpathtracing_optixcodelatest_tpu_torch.models.demand import (
    demand_tex2d,
    fold_requests,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.material import (
    MATERIAL_FLAG_SHADOW_CATCHER,
    MATERIAL_FLAGS_COL,
    view_rows,
)
from fovpathtracing_optixcodelatest_tpu_torch.models.texture import (
    hit_uv,
    sample_bilinear_wrap,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops import bsdf as bsdf_ops
from fovpathtracing_optixcodelatest_tpu_torch.ops import intersect
from fovpathtracing_optixcodelatest_tpu_torch.ops import lanes as lane_ops
from fovpathtracing_optixcodelatest_tpu_torch.ops import probe_sampling as probe_ops
from fovpathtracing_optixcodelatest_tpu_torch.ops import shade as shade_ops
from fovpathtracing_optixcodelatest_tpu_torch.ops import spectrum as sp
from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import fold_in, ray_uniforms
from fovpathtracing_optixcodelatest_tpu_torch.render.spectral import cauchy_eta
from fovpathtracing_optixcodelatest_tpu_torch.utils import tracing
from fovpathtracing_optixcodelatest_tpu_torch.ops.sampling import (
    basis_from_vector,
    dot,
    face_forward,
)


_SPAN = sp.LAMBDA_MAX - sp.LAMBDA_MIN


def _rgb_eval_at(rgb: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """The spectral lift of (N, 3) linear RGB read at (N, K) wavelengths:
    sum_c rgb_c * basis_c(lambda), without forming the 81-bin spectra."""
    basis = torch.as_tensor(sp.RGB_BASIS, dtype=torch.float32,
                            device=rgb.device)
    t = (lam - sp.LAMBDA_MIN) / _SPAN * (sp.NUM_BINS - 1)
    t = torch.clamp(t, 0.0, sp.NUM_BINS - 1)
    i0 = torch.clamp(t.to(torch.int64), max=sp.NUM_BINS - 2)
    frac = t - i0
    out = torch.zeros_like(lam)
    for c in range(3):
        row = basis[c]
        out = out + rgb[:, c: c + 1] * (row[i0] * (1 - frac)
                                        + row[i0 + 1] * frac)
    return torch.clamp(out, min=0.0)


def _cie_rgb_matrix(lam: torch.Tensor) -> torch.Tensor:
    """Per-ray linear map (N, 3, K) from a ray's K spectral samples to
    linear sRGB: each wavelength a uniform sample of the visible span,
    averaged over the K, Y-normalised as ``spectrum_to_xyz``."""
    xbar, ybar, zbar = sp.cie_xyz_bar_torch(lam)
    scale = _SPAN / lam.shape[1] / sp._Y_NORM
    xyz = torch.stack([xbar, ybar, zbar], dim=1) * scale
    m = torch.as_tensor(sp.XYZ_TO_SRGB, dtype=torch.float32, device=lam.device)
    return torch.einsum("rc,nck->nrk", m, xyz)


def take_tri_pack(scene, tri: torch.Tensor, cols=None) -> torch.Tensor:
    """The ``tri_pack`` rows (or the columns ``cols`` of them) of the int64
    triangle ids ``tri``. On a whole table this is one index. On a rank of a
    row-sharded scene (``parallel/scene_shard.py``: ``scene.pack_blocks``
    holds every rank's block of R rows, each on its rank's device,
    ``scene.pack_rank`` says which rank this is) the blocks are walked rank
    by rank, starting at this rank's own and copied to its device as they
    come, and each gathers the rows of its range that this rank's lanes
    need. The sum runs in int32 on the rows' bits: float adds would lose
    the material ids bitcast into columns 9 and 10 and the NaN payload of
    the texture id -1, while integer adds against zeros are exact in every
    column, so the result is the whole table's gather bit for bit."""
    blocks = scene.pack_blocks
    if blocks is None:
        tab = scene.tri_pack if cols is None else scene.tri_pack[:, cols]
        return tab[tri]
    n, rank = len(blocks), scene.pack_rank
    r = blocks[0].shape[0]
    acc = None
    for s in range(n):
        owner = (rank - s) % n
        blk = blocks[owner] if cols is None else blocks[owner][:, cols]
        blk = blk.to(tri.device).contiguous().view(torch.int32)
        local = tri - owner * r
        ok = (local >= 0) & (local < r)
        g = blk[torch.clamp(local, 0, r - 1)]
        g = torch.where(ok[:, None] if g.ndim == 2 else ok, g, 0)
        acc = g if acc is None else acc + g
    return acc.view(torch.float32)


def _oracle_triangles(scene):
    if scene.bvh.instanced:
        raise ValueError("oracle traversal needs a single-level table")
    if scene.pack_blocks is not None:
        raise ValueError("oracle traversal needs the whole triangle table")
    tp = scene.tri_pack
    return tp[:, 36:39], tp[:, 39:42], tp[:, 42:45]


def _closest(scene, o, d, active, config: RenderConfig, **launch):
    """K1 (or the oracle) over the rays; ``launch`` goes to
    ``traverse.closest_hit`` (a lane count, counter, output tensors)."""
    if config.traversal == "oracle":
        out = intersect.brute_force_closest_hit(
            *_oracle_triangles(scene), o, d, config.tmin, config.tmax)
        out["hit"] = out["hit"] & active
        out["tri_id"] = torch.where(out["hit"], out["tri_id"], -1)
        return out
    bvh = scene.bvh
    return traverse.closest_hit(bvh.table, o, d, active, config.tmin,
                                config.tmax, *bvh.walk_args,
                                **bvh.instance_kwargs, **launch)


def _occluded(scene, p, wi, query, config: RenderConfig, **launch):
    if config.traversal == "oracle":
        return intersect.brute_force_occluded(
            *_oracle_triangles(scene), p, wi, config.tmin, config.tmax
        ) & query
    bvh = scene.bvh
    return traverse.occluded(bvh.table, p, wi, query, config.tmin,
                             config.tmax, *bvh.walk_args,
                             **bvh.instance_kwargs, **launch)


def _world_normal(scene, ng, inst):
    """An instanced hit's object-space geometric normal in world space:
    A^T n normalised (A the instance row's inverse transform,
    ``ops/tlas.py``)."""
    bvh = scene.bvh
    a_m = bvh.table[bvh.inst_base + torch.clamp(inst, min=0).to(torch.int64),
                    1:10]
    ngw = torch.stack([
        a_m[:, 0] * ng[:, 0] + a_m[:, 3] * ng[:, 1] + a_m[:, 6] * ng[:, 2],
        a_m[:, 1] * ng[:, 0] + a_m[:, 4] * ng[:, 1] + a_m[:, 7] * ng[:, 2],
        a_m[:, 2] * ng[:, 0] + a_m[:, 5] * ng[:, 1] + a_m[:, 8] * ng[:, 2],
    ], dim=1)
    return ngw / torch.clamp(torch.linalg.vector_norm(ngw, dim=1,
                                                      keepdim=True), min=1e-20)


def _catcher_passthrough(scene, o, d, hit, config: RenderConfig, live=None):
    """``config.catcher_passthrough`` rounds of the catcher pass-through:
    lanes whose closest hit is a catcher re-trace (K1, those lanes only)
    from the hit point along the same direction, and take the new hit.
    ``live`` (None: all) masks the lanes of a list whose length the device
    holds. Returns (origin, hit, re-traces walked)."""
    walked = torch.zeros((), dtype=torch.int64, device=o.device)
    for _ in range(config.catcher_passthrough):
        tri_id = hit["tri_id"]
        if live is not None:  # past the length K1 left stale words
            tri_id = torch.where(live, tri_id, -1)
        tri = torch.clamp(tri_id, min=0).to(torch.int64)
        flags = take_tri_pack(scene, tri, 12 + MATERIAL_FLAGS_COL).view(
            torch.int32)
        thru = (tri_id >= 0) & ((flags & MATERIAL_FLAG_SHADOW_CATCHER) != 0)
        o = torch.where(thru[:, None], o + hit["t"][:, None] * d, o)
        o = o.contiguous()
        again = _closest(scene, o, d, thru, config)
        hit = {k: torch.where(thru, again[k], hit[k]) for k in hit}
        walked = walked + thru.sum()
    return o, hit, walked


def bounce(scene, o, d, throughput, eta_in, ray_ids, key, primary: bool,
           config: RenderConfig, lam=None, lam_alive=None):
    """One bounce of K alive rays. Returns the per-ray updates, and the
    bounce's shadow rays (``shadow_origin``, ``shadow_dir``, walked where
    ``shadow_query``). Spectral mode passes the rays' hero wavelengths
    ``lam`` and ``lam_alive`` (K, NUM_HERO) and gets ``lam_alive`` back."""
    k = o.shape[0]
    if lam is not None:
        cie_t = _cie_rgb_matrix(lam)
        lift = lambda rgb: _rgb_eval_at(rgb, lam)  # noqa: E731
        to_rgb = lambda spec: torch.einsum("nrk,nk->nr", cie_t, spec)  # noqa: E731
    else:
        lift = to_rgb = lambda x: x  # noqa: E731
    every = torch.ones((k,), dtype=torch.bool, device=o.device)
    hit = _closest(scene, o, d, every, config)
    passthrough = torch.zeros((), dtype=torch.int64, device=o.device)
    if scene.has_catcher and not primary and config.catcher_passthrough > 0:
        o, hit, passthrough = _catcher_passthrough(scene, o, d, hit, config)
    hit_mask = hit["hit"]
    attr = take_tri_pack(scene,
                         torch.clamp(hit["tri_id"], min=0).to(torch.int64))
    p = torch.where(hit_mask[:, None], o + hit["t"][:, None] * d, o)
    ng = attr[:, 0:3]
    if scene.bvh.instanced:
        ng = _world_normal(scene, ng, hit["inst"])
    nrm = face_forward(ng, -d)
    m = view_rows(attr[:, 12:36])
    demand_page = demand_missing = None
    if scene.demand is not None:
        tex_id = attr[:, 10].contiguous().view(torch.int32)
        uv = hit_uv(attr, hit["u"], hit["v"])
        textured = tex_id >= 0
        tex_col, resident, demand_page = demand_tex2d(
            scene.demand, torch.clamp(tex_id, min=0), uv[:, 0], uv[:, 1])
        demand_missing = hit_mask & textured & ~resident
        albedo = torch.where(textured[:, None], tex_col, m.color)
    elif scene.has_textures:
        # the id's bits go straight from the gathered row to int32: float
        # arithmetic on them could canonicalise the NaN payload of -1
        tex_id = attr[:, 10].contiguous().view(torch.int32)
        uv = hit_uv(attr, hit["u"], hit["v"])
        tex_col = sample_bilinear_wrap(scene.textures, tex_id, uv)
        albedo = torch.where((tex_id >= 0)[:, None], tex_col, m.color)
    else:
        albedo = m.color
    if lam is not None and config.dispersion != 0.0:
        # the hero wavelength disperses a transmissive material's IOR
        eta_mat = torch.where(
            m.transmission > 0.0,
            cauchy_eta(m.eta, lam[:, 0], config.dispersion), m.eta)
    else:
        eta_mat = m.eta
    out_eta = torch.where(eta_in == 1.0, eta_mat, 1.0)

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
    # the vertex, so its shadow ray is walked only where a catcher's alpha
    # still needs the answer
    u_frame, v_frame = basis_from_vector(nrm)
    l_dir, pdf, _ = bsdf_ops.bsdf_sample(
        m, eta_in, out_eta, u_frame, v_frame, nrm, view, u_all[:, 2:8]
    )
    sample_ok = pdf > 0.0
    if scene.has_catcher:
        is_catcher = (m.flags & MATERIAL_FLAG_SHADOW_CATCHER) != 0
        occl_query = hit_mask & (light_val.amax(dim=1) > 0.0) \
            & (sample_ok | is_catcher)
    else:
        occl_query = hit_mask & (light_val.amax(dim=1) > 0.0) & sample_ok
    p, wi = p.contiguous(), wi.contiguous()
    occ = _occluded(scene, p, wi, occl_query, config)

    light_c = lift(light_val)
    nee_contrib = torch.where((~occ)[:, None], light_c, 0.0)
    emitted = (torch.where(hit_mask & primary, 1.0, 0.0)[:, None]
               * lift(m.emission))
    if scene.has_catcher:
        # a catcher adds no radiance; its alpha gathers the shadowed NEE
        vert_radiance = torch.where(
            (~is_catcher)[:, None], throughput * nee_contrib, 0.0) + emitted
        alpha_set = hit_mask & ~is_catcher
        alpha_add = to_rgb(torch.where(
            (hit_mask & is_catcher)[:, None],
            throughput * torch.where(occ[:, None], light_c, 0.0), 0.0))
    else:
        vert_radiance = throughput * nee_contrib + emitted
        alpha_set, alpha_add = hit_mask, None

    f_b = bsdf_ops.bsdf_eval(m, albedo, eta_in, out_eta, nrm, view, l_dir)
    transmitted = dot(l_dir, nrm) <= 0.0
    cont = hit_mask & sample_ok
    thr_scale = (lift(f_b) * dot(nrm, l_dir).abs()[:, None]
                 / torch.clamp(pdf, min=1e-20)[:, None])
    if lam is not None:
        # a dispersive transmission collapses the non-hero wavelengths:
        # their refracted paths would differ from the hero's
        dispersive = (hit_mask & transmitted & (m.transmission > 0.0)
                      & ((eta_mat - m.eta).abs() > 1e-6))
        keep = torch.cat([torch.ones_like(dispersive)[:, None],
                          (~dispersive)[:, None].expand(k, sp.NUM_HERO - 1)],
                         dim=1)
        new_lam_alive = lam_alive & keep
        new_throughput = torch.where(
            cont[:, None] & new_lam_alive, throughput * thr_scale,
            torch.where(cont[:, None], 0.0, throughput))
        vert_radiance = torch.where(lam_alive, vert_radiance, 0.0)
    else:
        new_lam_alive = None
        new_throughput = torch.where(cont[:, None], throughput * thr_scale,
                                     throughput)
    return {
        "hit_mask": hit_mask,
        "alive": cont,
        "origin": p,
        "direction": torch.where(hit_mask[:, None], l_dir, d),
        "throughput": new_throughput,
        "lam_alive": new_lam_alive,
        "eta": torch.where(hit_mask & transmitted, out_eta, eta_in),
        "contrib": to_rgb(torch.where(cont[:, None], vert_radiance, 0.0)),
        "alpha_set": alpha_set,
        "alpha_add": alpha_add,
        "normal": nrm,
        "albedo": albedo,
        "occl_queries": occl_query.sum(),
        "passthrough_traces": passthrough,
        "shadow_origin": p,
        "shadow_dir": wi,
        "shadow_query": occl_query,
        "demand_page": demand_page,
        "demand_missing": demand_missing,
    }


@dataclasses.dataclass
class PathState:
    """The full-size per-path arrays ``trace_paths`` carries from bounce to
    bounce (N rows each; ``lam_alive`` in spectral mode, ``demand_req`` on
    a scene with a demand-texture context)."""

    o: torch.Tensor
    d: torch.Tensor
    throughput: torch.Tensor
    eta: torch.Tensor
    radiance: torch.Tensor
    alpha: torch.Tensor
    normal: torch.Tensor
    albedo: torch.Tensor
    traces: torch.Tensor
    lam_alive: torch.Tensor | None = None
    demand_req: torch.Tensor | None = None

    @classmethod
    def start(cls, origin, direction, throughput, lam_alive=None):
        """N paths before their first bounce: copies of their rays, eta 1,
        radiance, alpha, normal and albedo 0, no traces."""
        n, dev = origin.shape[0], origin.device
        f3 = lambda: torch.zeros((n, 3), dtype=torch.float32,  # noqa: E731
                                 device=dev)
        return cls(o=origin.contiguous().clone(),
                   d=direction.contiguous().clone(), throughput=throughput,
                   eta=torch.ones((n,), dtype=torch.float32, device=dev),
                   radiance=f3(), alpha=f3(), normal=f3(), albedo=f3(),
                   traces=torch.zeros((), dtype=torch.int64, device=dev),
                   lam_alive=lam_alive)


def shades_on_kernels(scene, config: RenderConfig, device) -> bool:
    """Whether ``trace_paths`` shades its bounces with ``csrc/shade.cu``'s
    kernels (``kernel_bounce``): on CUDA tensors, in RGB, on a scene
    without a demand-texture context or row-sharded triangles, walked by
    the BVH kernels. Textures, catchers and two-level tables are arguments
    of the kernels. Everything else takes ``plain_bounce``."""
    return (torch.device(device).type == "cuda" and not config.spectral
            and scene.demand is None and config.traversal != "oracle"
            and scene.pack_blocks is None)


def plain_bounce(scene, st: PathState, idx, ray_ids, key, primary: bool,
                 config: RenderConfig, lam=None) -> torch.Tensor:
    """One bounce of the lanes ``idx`` in plain PyTorch: ``bounce`` on
    their gathered state, then the scatter of its results into ``st`` ->
    the lanes' alive mask. The plain version of ``kernel_bounce``."""
    spec = () if lam is None else (lam[idx], st.lam_alive[idx])
    b = bounce(scene, st.o[idx], st.d[idx], st.throughput[idx], st.eta[idx],
               ray_ids[idx], key, primary, config, *spec)
    hm = b["hit_mask"]
    st.o[idx] = b["origin"]
    st.d[idx] = b["direction"]
    st.throughput[idx] = b["throughput"]
    if lam is not None:
        st.lam_alive[idx] = b["lam_alive"]
    st.eta[idx] = b["eta"]
    st.radiance[idx] = st.radiance[idx] + b["contrib"]
    kept = st.alpha[idx]
    if b["alpha_add"] is not None:
        kept = kept + b["alpha_add"]
    st.alpha[idx] = torch.where(b["alpha_set"][:, None], 1.0, kept)
    if primary:
        st.normal[idx] = torch.where(hm[:, None], b["normal"], 0.0)
        st.albedo[idx] = torch.where(hm[:, None], b["albedo"], 0.0)
    st.traces = (st.traces + idx.numel() + b["occl_queries"]
                 + b["passthrough_traces"])
    if scene.demand is not None:
        fold_requests(st.demand_req, b["demand_page"], b["demand_missing"])
    return b["alive"]


class CardWave:
    """The kernel path's lane-sized buffers for one wavefront of capacity n
    and ``depths`` bounces, allocated once and used at every depth: the two
    lane lists the compactions write in turn, the bounce's rays, K1's
    answer, shade's outputs, K2's answer and the alive mask, the all-true
    mask K1 walks, and one zeroed int32 workspace holding the per-depth
    lane counts (int64, ``lanes``), the lists' lengths (``counts``, one a
    depth), K1's and K2's lane counters and each compaction's scratch."""

    def __init__(self, n: int, depths: int, instanced: bool, device):
        tiles = lane_ops.tile_words(n)
        ws = torch.zeros((5 * depths + depths * tiles,), dtype=torch.int32,
                         device=device)
        self.n = n
        self.lanes = ws[:2 * depths].view(torch.int64)
        self.counts = ws[2 * depths: 3 * depths]
        self.k1_counters = ws[3 * depths: 4 * depths]
        self.k2_counters = ws[4 * depths: 5 * depths]
        self.tiles = ws[5 * depths:].view(depths, tiles)
        empty = lambda *shape, dtype=torch.float32: torch.empty(  # noqa: E731
            shape, dtype=dtype, device=device)
        self.idx = [empty(n, dtype=torch.int64), empty(n, dtype=torch.int64)]
        self.o, self.d = empty(n, 3), empty(n, 3)
        self.hit = traverse.hit_outputs(n, device, instanced)
        self.shaded = shade_ops.shade_outputs(n, device)
        self.occ = empty(n, dtype=torch.bool)
        self.alive = empty(n, dtype=torch.bool)
        self.every = torch.ones((n,), dtype=torch.bool, device=device)

    @classmethod
    def from_indices(cls, idx, st: PathState, instanced: bool):
        """A wave whose depth-0 list is the host's lane list ``idx``, with
        its length and its rays gathered from ``st``."""
        wave = cls(idx.numel(), 1, instanced, idx.device)
        wave.idx[0] = idx
        wave.counts.fill_(idx.numel())
        wave.o, wave.d = st.o[idx], st.d[idx]
        return wave

    def count(self, depth: int):
        """Depth ``depth``'s list length as the launches read it: a (1,)
        int32 view of the device's word."""
        return self.counts[depth: depth + 1]

    def compact(self, mask, st: PathState, depth: int) -> None:
        """Write depth ``depth``'s list: depth 0 from ray generation's
        ``mask`` over the identity, later depths from the last bounce's
        alive ``mask`` over depth - 1's list (``ops/lanes.py``), with its
        length, its rays from ``st`` and its count into ``lanes``."""
        first = depth == 0
        lane_ops.compact(
            mask, None if first else self.idx[(depth - 1) % 2],
            None if first else self.count(depth - 1), st.o, st.d,
            {"idx_out": self.idx[depth % 2], "count_out": self.count(depth),
             "o_out": self.o, "d_out": self.d,
             "lanes": self.lanes[depth: depth + 1],
             "tiles": self.tiles[depth]})


def kernel_bounce(scene, st: PathState, wave: CardWave, depth: int, ray_ids,
                  key, primary: bool, config: RenderConfig) -> torch.Tensor:
    """One bounce of ``wave``'s lanes at ``depth`` on the card: K1 on their
    rays, the catcher pass-through, ``shade_kernel``, K2, then
    ``resolve_kernel``, which updates ``st`` in place -> the lanes' alive
    mask (``wave.alive``). Every launch reads the list's length from the
    device and writes the wave's buffers. ``ray_ids`` must be int64. The
    result is ``plain_bounce``'s."""
    idx, count = wave.idx[depth % 2], wave.count(depth)
    o, d = wave.o, wave.d
    hit = _closest(scene, o, d, wave.every, config, count=count,
                   counter=wave.k1_counters[depth: depth + 1], out=wave.hit)
    if scene.has_catcher and not primary and config.catcher_passthrough > 0:
        live = torch.arange(wave.n, dtype=torch.int32, device=o.device) < count
        o, hit, passthrough = _catcher_passthrough(scene, o, d, hit, config,
                                                   live)
        st.traces += passthrough
    p, wi, query, rec = shade_ops.shade(scene, idx, o, d, hit, st.eta, ray_ids,
                                        key, primary, count, wave.shaded)
    occ = _occluded(scene, p, wi, query, config, count=count,
                    counter=wave.k2_counters[depth: depth + 1], out=wave.occ)
    return shade_ops.resolve(idx, rec, p, occ, query, st, primary,
                             scene.has_catcher, count, wave.alive)


def kernel_paths(scene, st: PathState, active, ray_ids, key,
                 config: RenderConfig) -> None:
    """Every bounce of a wavefront on the card, its live lanes kept in
    device memory: one compaction of ray generation's ``active``, then each
    bounce and, before every bounce but the last, the compaction of its
    alive mask. Nothing waits for the device; the per-depth lane counts go
    to the counters with the frame's download (``tracing.count_on_device``).
    """
    wave = CardWave(st.o.shape[0], config.max_depth, scene.bvh.instanced,
                    st.o.device)
    wave.compact(active, st, 0)
    for depth in range(config.max_depth):
        tracing.count("shade", "kernel", 1)
        with tracing.bounce(depth):
            alive = kernel_bounce(scene, st, wave, depth, ray_ids,
                                  fold_in(key, depth), depth == 0, config)
            if depth + 1 < config.max_depth:
                wave.compact(alive, st, depth + 1)
    tracing.count_on_device("lanes", wave.lanes)


@tracing.spanned(tracing.PATHS)
def trace_paths(scene, origin: torch.Tensor, direction: torch.Tensor,
                active: torch.Tensor, key, config: RenderConfig,
                ray_ids: torch.Tensor | None = None) -> Dict[str, torch.Tensor]:
    """Trace N paths to completion.

    ``key`` is a (2,) uint32 key (``ops.rng``); bounce ``depth`` draws its
    uniforms from ``fold_in(key, depth)`` keyed by ``ray_ids`` (default
    arange). Returns radiance, alpha, normal, albedo (N, 3) and ``traces``
    (0-dim int64 tensor), and on a scene with a demand-texture context
    ``demand_requests``, the (total_pages,) bool bitmap of the pages its
    textured hits sampled while not resident."""
    config.check_supported()
    tracing.wavefront()
    n, dev = origin.shape[0], origin.device
    if ray_ids is None:
        ray_ids = torch.arange(n, device=dev)
    lam = lam_alive = None
    if config.spectral:
        lam = sp.sample_hero_wavelengths(
            ray_uniforms(fold_in(key, 7919), ray_ids, 1)[:, 0])
        lam_alive = torch.ones_like(lam, dtype=torch.bool)
        throughput = torch.ones_like(lam)
    else:
        throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    st = PathState.start(origin, direction, throughput, lam_alive)
    if scene.demand is not None:
        st.demand_req = torch.zeros((scene.demand.total_pages,),
                                    dtype=torch.uint8, device=dev)
    if shades_on_kernels(scene, config, dev):
        tracing.count("lane_list", "device", 1)
        kernel_paths(scene, st, active.contiguous(),
                     ray_ids.to(torch.int64).contiguous(), key, config)
    else:
        tracing.count("lane_list", "host", 1)
        with tracing.sync("live_lanes"):
            idx = torch.nonzero(active).squeeze(1)
        for depth in range(config.max_depth):
            # the lanes entering this bounce, every depth counted: idx's
            # length, which the host knows since the last narrowing
            tracing.count("lanes", depth, idx.numel())
            if idx.numel() == 0:
                continue
            tracing.count("shade", "plain", 1)
            with tracing.bounce(depth):
                alive = plain_bounce(scene, st, idx, ray_ids,
                                     fold_in(key, depth), depth == 0, config,
                                     lam)
                with tracing.sync("narrow"):
                    idx = idx[alive]
    out = {"radiance": st.radiance, "alpha": st.alpha, "normal": st.normal,
           "albedo": st.albedo, "traces": st.traces}
    if scene.demand is not None:
        out["demand_requests"] = st.demand_req > 0
    return out
