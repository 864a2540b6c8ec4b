"""Disney BSDF: eval / pdf / importance sample over a ray batch (counterpart
of the JAX package's ``ops/bsdf.py``, expression for expression).

Every branch is computed for every ray and selected with masks. Material
parameters come as a ``MaterialView`` over gathered (N, 24) rows.
"""

from __future__ import annotations

import torch

from fovpathtracing_optixcodelatest_tpu_torch.ops.sampling import (
    INV_2PI,
    INV_PI,
    PI,
    TWO_PI,
    cosine_sample_hemisphere,
    dot,
    fresnel_dielectric,
    local_to_world,
    reflect,
    refract,
    safe_normalize,
    schlick_fresnel,
    uniform_sample_hemisphere,
)

BSDF_REFLECTED = 0
BSDF_TRANSMITTED = 1
BSDF_SPECULAR = 2


def _rgb(x):
    """(N,) -> (N, 3) with the value in every channel."""
    return x[..., None].expand(*x.shape, 3)


def _gtr1(n_dot_h, a):
    """GTR1 NDF; a >= 1 degenerates to 1/pi."""
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    safe_log = torch.log(torch.clamp(a2, 1e-8, 0.999999))
    val = (a2 - 1.0) / (PI * safe_log * torch.where(t == 0.0, 1e-8, t))
    return torch.where(a >= 1.0, INV_PI, val)


def _gtr2(n_dot_h, a):
    """GTR2 / GGX NDF."""
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    return a2 / (PI * torch.clamp(t * t, min=1e-12))


def _smith_ggx(n_dot_v, alpha_g):
    a = alpha_g * alpha_g
    b = n_dot_v * n_dot_v
    return 1.0 / torch.clamp(
        n_dot_v + torch.sqrt(torch.clamp(a + b - a * b, min=0.0)), min=1e-8
    )


def bsdf_pdf(mat, eta_i, eta_o, n, view, light):
    """Solid-angle pdf of ``light`` given ``view``."""
    n_dot_l = dot(light, n)
    below = n_dot_l <= 0.0
    brdf_pdf_below = INV_2PI * mat.subsurface * 0.5
    bsdf_pdf_below = torch.zeros_like(brdf_pdf_below)

    f = fresnel_dielectric(dot(n, view), eta_i, eta_o)
    a = torch.clamp(mat.roughness, min=0.001)
    half = safe_normalize(light + view)
    cos_theta_half = dot(half, n).abs()
    pdf_half = _gtr2(cos_theta_half, a) * cos_theta_half
    pdf_spec = 0.25 * pdf_half / torch.clamp(dot(light, half), min=1e-6)
    pdf_diff = n_dot_l.abs() * INV_PI * (1.0 - mat.subsurface)
    bsdf_pdf_above = pdf_spec * f
    brdf_pdf_above = 0.5 * (pdf_diff + pdf_spec)

    brdf_p = torch.where(below, brdf_pdf_below, brdf_pdf_above)
    bsdf_p = torch.where(below, bsdf_pdf_below, bsdf_pdf_above)
    return brdf_p + mat.transmission * (bsdf_p - brdf_p)


def _sample_ggx_half(u, v, n, view, roughness, r1, r2):
    """GGX half-vector in the (u, v, n) frame, flipped towards ``view``."""
    a = torch.clamp(roughness, min=0.001)
    phi = r1 * TWO_PI
    cos_th = torch.sqrt(
        torch.clamp((1.0 - r2) / (1.0 + (a * a - 1.0) * r2), 0.0, 1.0)
    )
    sin_th = torch.sqrt(torch.clamp(1.0 - cos_th * cos_th, min=0.0))
    d = torch.stack(
        [sin_th * torch.cos(phi), sin_th * torch.sin(phi), cos_th], dim=-1
    )
    half = local_to_world(d, u, v, n)
    flip = dot(half, view) <= 0.0
    return torch.where(flip[..., None], -half, half)


def bsdf_sample(mat, eta_i, eta_o, u, v, n, view, uniforms):
    """Importance-sample an outgoing direction. ``uniforms`` (N, 6) =
    [branch_t, branch_f, branch_half, branch_ss, r1, r2]. Returns
    (light (N, 3), pdf (N,), sample_type (N,) int32); pdf == 0 ends the
    path (failed refraction)."""
    u_t, u_f, u_half, u_ss, r1, r2 = uniforms.unbind(-1)

    f = fresnel_dielectric(dot(n, view), eta_i, eta_o)
    half = _sample_ggx_half(u, v, n, view, mat.roughness, r1, r2)
    light_spec = reflect(view, half)
    light_diff = local_to_world(cosine_sample_hemisphere(r1, r2), u, v, n)
    d_uni = uniform_sample_hemisphere(r1, r2)
    light_ss = u * d_uni[..., 0:1] + v * d_uni[..., 1:2] - n * d_uni[..., 2:3]
    light_refr, refr_ok = refract(view, n, eta_i / eta_o)

    trans_branch = u_t < mat.transmission
    spec_in_trans = u_f < f
    diffuse_half = u_half < 0.5
    ss_pick = u_ss < mat.subsurface

    refl_light = torch.where(
        diffuse_half[..., None],
        torch.where(ss_pick[..., None], light_ss, light_diff),
        light_spec,
    )
    refl_type = torch.where(
        diffuse_half & ss_pick, BSDF_TRANSMITTED, BSDF_REFLECTED
    )
    light = torch.where(
        trans_branch[..., None],
        torch.where(spec_in_trans[..., None], light_spec, light_refr),
        refl_light,
    )
    sample_type = torch.where(
        trans_branch,
        torch.where(spec_in_trans, BSDF_REFLECTED, BSDF_SPECULAR),
        refl_type,
    ).to(torch.int32)

    pdf_smooth = bsdf_pdf(mat, eta_i, eta_o, n, view, light)
    is_specular_refr = trans_branch & ~spec_in_trans
    pdf = torch.where(
        is_specular_refr,
        torch.where(refr_ok, (1.0 - f) * mat.transmission, 0.0),
        pdf_smooth,
    )
    return light, pdf, sample_type


def bsdf_eval(mat, albedo, eta_i, eta_o, n, view, light):
    """Evaluate f(view, light); ``albedo`` is the base color (N, 3)."""
    n_dot_l = dot(light, n)
    n_dot_v = dot(n, view)
    h = safe_normalize(light + view)
    n_dot_h = dot(n, h)
    l_dot_h = dot(light, h)

    cdlin = albedo
    cdlum = 0.3 * cdlin[..., 0] + 0.6 * cdlin[..., 1] + 0.1 * cdlin[..., 2]
    ctint = torch.where(
        cdlum[..., None] > 0.0,
        cdlin / torch.clamp(cdlum[..., None], min=1e-8),
        torch.ones_like(cdlin),
    )
    cspec0_dielec = mat.specular[..., None] * 0.08 * (
        1.0 + mat.specular_tint[..., None] * (ctint - 1.0)
    )
    cspec0 = cspec0_dielec + mat.metallic[..., None] * (cdlin - cspec0_dielec)

    below = n_dot_l <= 0.0
    a = torch.clamp(mat.roughness, min=0.001)

    # transmission side
    f_v = fresnel_dielectric(n_dot_v, eta_i, eta_o)
    bsdf_below = _rgb(
        mat.transmission
        * (1.0 - f_v)
        / torch.clamp(n_dot_l.abs(), min=1e-6)
        * (1.0 - mat.metallic)
    )
    ds = _gtr2(n_dot_h, a)
    fh_dielec = fresnel_dielectric(l_dot_h, eta_i, eta_o)
    fs_trans = cspec0 + fh_dielec[..., None] * (1.0 - cspec0)
    gs = _smith_ggx(n_dot_v, a) * _smith_ggx(n_dot_l, a)
    bsdf_above = (gs * ds)[..., None] * fs_trans
    bsdf_side = torch.where(below[..., None], bsdf_below, bsdf_above)
    bsdf_side = torch.where((mat.transmission > 0.0)[..., None], bsdf_side, 0.0)

    # reflection side
    fl_abs = schlick_fresnel(n_dot_l.abs())
    fv = schlick_fresnel(n_dot_v)
    fd_ss = (1.0 - 0.5 * fl_abs) * (1.0 - 0.5 * fv)
    s = torch.sqrt(torch.clamp(mat.color, min=0.0))
    brdf_below = (
        INV_PI * (mat.subsurface * fd_ss * (1.0 - mat.metallic))[..., None] * s
    )
    brdf_below = torch.where(
        (mat.subsurface > 0.0)[..., None], brdf_below, 0.0
    )

    fh = schlick_fresnel(l_dot_h)
    fs = cspec0 + fh[..., None] * (1.0 - cspec0)
    fl = schlick_fresnel(n_dot_l)
    fd90 = 0.5 + 2.0 * l_dot_h * l_dot_h * mat.roughness
    fd = (1.0 + fl * (fd90 - 1.0)) * (1.0 + fv * (fd90 - 1.0))
    dr = _gtr1(n_dot_h, 0.1 + mat.clearcoat_gloss * (0.001 - 0.1))
    fc = 0.04 + fh * (1.0 - 0.04)
    gr = _smith_ggx(n_dot_l, 0.25) * _smith_ggx(n_dot_v, 0.25)
    brdf_above = (
        (INV_PI * fd * (1.0 - mat.metallic) * (1.0 - mat.subsurface))[..., None]
        * cdlin
        + (gs * ds)[..., None] * fs
        + _rgb(mat.clearcoat * gr * fc * dr)
    )
    brdf_side = torch.where(below[..., None], brdf_below, brdf_above)
    brdf_side = torch.where((mat.transmission < 1.0)[..., None], brdf_side, 0.0)

    return brdf_side + mat.transmission[..., None] * (bsdf_side - brdf_side)
