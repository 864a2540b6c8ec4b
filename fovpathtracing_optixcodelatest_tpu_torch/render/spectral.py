"""Dispersion and the direct-lighting spectral renderer (counterpart of the
JAX package's ``render/spectral.py``).

``cauchy_eta`` is the dispersive IOR the hero-wavelength integrator
(``render/integrator.py`` with ``config.spectral``) gives transmissive
materials. ``spectral_render`` is the smaller renderer beside it: each
pixel traces ``NUM_HERO`` rotated wavelengths through chains of dispersive
refraction (Cauchy eta(lambda)), opaque hits shade as spectral albedo times
the probe's sky, and the result is CIE-integrated back to sRGB.
"""

from __future__ import annotations

import torch

from fovpathtracing_optixcodelatest_tpu_torch.models.material import view_rows
from fovpathtracing_optixcodelatest_tpu_torch.ops import spectrum as sp
from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse
from fovpathtracing_optixcodelatest_tpu_torch.ops.probe_sampling import (
    dir_to_uv,
    probe_eval,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops.rng import prng_key, ray_uniforms
from fovpathtracing_optixcodelatest_tpu_torch.ops.sampling import (
    dot,
    face_forward,
    fresnel_dielectric,
    normalize,
    refract,
)
from fovpathtracing_optixcodelatest_tpu_torch.ops.tonemap import postprocess


def cauchy_eta(eta_d, lam, dispersion: float = 12000.0):
    """Cauchy dispersion eta(lambda) = A + B / lambda^2, A chosen so that
    eta(589.3 nm) = ``eta_d``; ``dispersion`` is B in nm^2 (about 4200 for
    BK7 glass)."""
    a = eta_d - dispersion / (589.3 ** 2)
    return a + dispersion / (lam * lam)


def _env_at(probe, direction, lam):
    """The probe's radiance along ``direction``, lifted to a spectrum and
    read at each ray's wavelength ``lam`` (N,)."""
    rgb = probe_eval(probe, dir_to_uv(direction))
    return sp.eval_spectrum_at(sp.rgb_to_spectrum(rgb), lam[:, None])[:, 0]


def spectral_render(scene, camera, width: int, height: int,
                    dispersion: float = 12000.0, max_bounces: int = 3,
                    key=None) -> torch.Tensor:
    """(height, width, 3) uint8 sRGB: transmissive materials refract
    dispersively, opaque hits shade as spectral albedo x the probe's sky,
    misses see the probe. ``key`` defaults to ``prng_key(0)``."""
    if key is None:
        key = prng_key(0)
    dev = scene.device
    n_pix = width * height
    k = sp.NUM_HERO
    n = n_pix * k
    gy, gx = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    ndc_x = 2.0 * (gx.reshape(-1) + 0.5) / width - 1.0
    ndc_y = 2.0 * (gy.reshape(-1) + 0.5) / height - 1.0
    base_dir = normalize(ndc_x[:, None] * camera.u[None, :]
                         + ndc_y[:, None] * camera.v[None, :]
                         + camera.w[None, :])
    u = ray_uniforms(key, torch.arange(n_pix, device=dev), 1)[:, 0]
    lam = sp.sample_hero_wavelengths(u)  # (P, K)
    lam_flat = lam.reshape(-1)

    origin = camera.eye[None, :].expand(n, 3).contiguous()
    direction = torch.repeat_interleave(base_dir, k, dim=0).contiguous()
    throughput = torch.ones((n,), dtype=torch.float32, device=dev)
    radiance = torch.zeros((n,), dtype=torch.float32, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    bvh = scene.bvh
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    sky_spec = _env_at(scene.probe, up.expand(n, 3), lam_flat)

    for _ in range(max_bounces):
        hit = traverse.closest_hit(bvh.table, origin, direction, alive, 1e-3,
                                   1e16, *bvh.walk_args,
                                   **bvh.instance_kwargs)
        hm = alive & hit["hit"]
        attr = scene.tri_pack[torch.clamp(hit["tri_id"], min=0).to(torch.int64)]
        p = origin + hit["t"][:, None] * direction
        ng = attr[:, 0:3]
        nrm = face_forward(ng, -direction)
        mat = view_rows(attr[:, 12:36])

        # a miss sees the probe at this wavelength
        radiance = radiance + torch.where(
            alive & ~hit["hit"],
            throughput * _env_at(scene.probe, direction, lam_flat), 0.0)

        transmissive = mat.transmission > 0.5
        eta_l = cauchy_eta(mat.eta, lam_flat, dispersion)
        entering = dot(direction, ng) < 0.0
        eta_ratio = torch.where(entering, 1.0 / eta_l, eta_l)
        refr, ok = refract(-direction, nrm, eta_ratio)
        f = fresnel_dielectric(dot(nrm, -direction).abs(),
                               torch.where(entering, 1.0, eta_l),
                               torch.where(entering, eta_l, 1.0))
        # transmissive: refract (or reflect on total internal reflection)
        refl = direction - 2.0 * dot(direction, nrm)[:, None] * nrm
        new_dir = torch.where(ok[:, None], refr, refl)
        new_tp = throughput * torch.where(ok, 1.0 - f, 1.0)

        # opaque: ends with spectral albedo x the sky above
        alb_spec = sp.eval_spectrum_at(sp.rgb_to_spectrum(mat.color),
                                       lam_flat[:, None])[:, 0]
        lambert = torch.clamp(dot(nrm, up.expand_as(nrm)), min=0.1)
        radiance = radiance + torch.where(
            hm & ~transmissive, throughput * alb_spec * sky_spec * lambert,
            0.0)

        origin = torch.where(hm[:, None], p + 1e-3 * new_dir,
                             origin).contiguous()
        direction = torch.where(hm[:, None], new_dir, direction).contiguous()
        throughput = torch.where(hm & transmissive, new_tp, throughput)
        alive = hm & transmissive

    # paths still in glass see the probe along their last direction
    radiance = radiance + torch.where(
        alive, throughput * _env_at(scene.probe, direction, lam_flat), 0.0)

    # each hero sample a delta spectrum: integrate over the K samples
    rad_p = radiance.reshape(n_pix, k)
    xb, yb, zb = sp.cie_xyz_bar_torch(lam)
    norm = (sp.LAMBDA_MAX - sp.LAMBDA_MIN) / k / sp._Y_NORM
    xyz = torch.stack([(rad_p * xb).sum(1) * norm, (rad_p * yb).sum(1) * norm,
                       (rad_p * zb).sum(1) * norm], dim=-1)
    m = torch.as_tensor(sp.XYZ_TO_SRGB, dtype=torch.float32, device=dev)
    rgb = (xyz @ m.T).reshape(height, width, 3)
    return postprocess(rgb, exposure_stops=0.0, white=2.0)
