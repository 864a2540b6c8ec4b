"""Shading for the reference: vector helpers, the Disney BSDF (eval, pdf,
importance sample), the environment probe (Walker alias table built here
from the probe image, nearest-texel lookup) and bilinear-wrap texture
sampling, in the port's expression order so that equal inputs give equal
bits. Float tensors keep the dtype they come in."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

TWO_PI = 6.283185307179586
PI = 3.141592653589793
INV_PI = 1.0 / PI
INV_2PI = 0.5 / PI

MATERIAL_FIELDS = (
    "eta", "metallic", "subsurface", "specular", "roughness",
    "specular_tint", "anisotropic", "sheen", "sheen_tint", "clearcoat",
    "clearcoat_gloss", "transmission", "bump",
)


# --------------------------------------------------------------- vectors
def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def normalize(v, eps=1e-20):
    return v * torch.reciprocal(torch.sqrt(torch.clamp(dot(v, v), min=eps)))[..., None]


def safe_normalize(v):
    length2 = dot(v, v)
    ok = length2 > 1e-20
    inv = torch.where(
        ok, torch.reciprocal(torch.sqrt(torch.clamp(length2, min=1e-20))), 0.0)
    return v * inv[..., None]


def basis_from_vector(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    inv_xz = torch.reciprocal(torch.sqrt(torch.clamp(wx * wx + wz * wz, min=1e-20)))
    inv_yz = torch.reciprocal(torch.sqrt(torch.clamp(wy * wy + wz * wz, min=1e-20)))
    zero = torch.zeros_like(wx)
    u_a = torch.stack([-wz * inv_xz, zero, wx * inv_xz], dim=-1)
    u_b = torch.stack([zero, wz * inv_yz, -wy * inv_yz], dim=-1)
    u = torch.where((wx.abs() > wy.abs())[..., None], u_a, u_b)
    return u, cross(w, u)


def face_forward(n, v):
    return torch.where(dot(n, v)[..., None] < 0.0, -n, n)


def local_to_world(d, u, v, n):
    return u * d[..., 0:1] + v * d[..., 1:2] + n * d[..., 2:3]


def reflect(v, h):
    return 2.0 * dot(v, h)[..., None] * h - v


def refract(wi, n, eta):
    cos_i = dot(n, wi)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = eta * eta * sin2_i
    ok = sin2_t < 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = eta[..., None] * -wi + (eta * cos_i - cos_t)[..., None] * n
    return wt, ok


def schlick_fresnel(u):
    m = torch.clamp(1.0 - u, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def fresnel_dielectric(v_dot_n, eta_i, eta_t):
    sin2_t = (eta_i / eta_t) ** 2 * (1.0 - v_dot_n * v_dot_n)
    tir = sin2_t > 1.0
    l_dot_n = torch.sqrt(torch.clamp(1.0 - torch.clamp(sin2_t, max=1.0), min=0.0))
    eta = eta_t / eta_i
    denom1 = v_dot_n + eta * l_dot_n
    denom2 = l_dot_n + eta * v_dot_n
    r1 = (v_dot_n - eta * l_dot_n) / torch.where(denom1.abs() < 1e-12, 1e-12, denom1)
    r2 = (l_dot_n - eta * v_dot_n) / torch.where(denom2.abs() < 1e-12, 1e-12, denom2)
    f = 0.5 * (r1 * r1 + r2 * r2)
    return torch.where(tir, 1.0, f)


def uniform_sample_hemisphere(u1, u2):
    z = u1
    w = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u2
    return torch.stack([torch.cos(phi) * w, torch.sin(phi) * w, z], dim=-1)


def cosine_sample_hemisphere(u1, u2):
    r = torch.sqrt(u1)
    theta = TWO_PI * u2
    sx, sy = r * torch.cos(theta), r * torch.sin(theta)
    z = torch.sqrt(torch.clamp(1.0 - sx ** 2 - sy ** 2, min=0.0))
    return torch.stack([sx, sy, z], dim=-1)


# ----------------------------------------------------------------- BSDF
@dataclasses.dataclass
class Material:
    """Per-ray material fields, each (N,) or (N, 3)."""

    color: torch.Tensor
    emission: torch.Tensor
    absorption: torch.Tensor
    eta: torch.Tensor
    metallic: torch.Tensor
    subsurface: torch.Tensor
    specular: torch.Tensor
    roughness: torch.Tensor
    specular_tint: torch.Tensor
    anisotropic: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    transmission: torch.Tensor
    bump: torch.Tensor


def material_table(materials, device, dtype) -> torch.Tensor:
    """(M, 22) rows: color, emission, absorption, then ``MATERIAL_FIELDS``;
    a zero eta is inferred from specular."""
    rows = np.zeros((len(materials), 22), dtype=np.float32)
    for i, m in enumerate(materials):
        rows[i, 0:3], rows[i, 3:6], rows[i, 6:9] = (
            m["color"], m["emission"], m["absorption"])
        for j, f in enumerate(MATERIAL_FIELDS):
            v = m[f]
            if f == "eta" and v == 0.0:
                v = 2.0 / (1.0 - float(np.sqrt(0.08 * m["specular"]))) - 1.0
            rows[i, 9 + j] = v
    return torch.tensor(rows, device=device).to(dtype)


def material_view(rows: torch.Tensor) -> Material:
    kw = {"color": rows[:, 0:3], "emission": rows[:, 3:6],
          "absorption": rows[:, 6:9]}
    for j, f in enumerate(MATERIAL_FIELDS):
        kw[f] = rows[:, 9 + j]
    return Material(**kw)


def _rgb(x):
    return x[..., None].expand(*x.shape, 3)


def _gtr1(n_dot_h, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    safe_log = torch.log(torch.clamp(a2, 1e-8, 0.999999))
    val = (a2 - 1.0) / (PI * safe_log * torch.where(t == 0.0, 1e-8, t))
    return torch.where(a >= 1.0, INV_PI, val)


def _gtr2(n_dot_h, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    return a2 / (PI * torch.clamp(t * t, min=1e-12))


def _smith_ggx(n_dot_v, alpha_g):
    a = alpha_g * alpha_g
    b = n_dot_v * n_dot_v
    return 1.0 / torch.clamp(
        n_dot_v + torch.sqrt(torch.clamp(a + b - a * b, min=0.0)), min=1e-8)


def bsdf_pdf(mat, eta_i, eta_o, n, view, light):
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
    a = torch.clamp(roughness, min=0.001)
    phi = r1 * TWO_PI
    cos_th = torch.sqrt(
        torch.clamp((1.0 - r2) / (1.0 + (a * a - 1.0) * r2), 0.0, 1.0))
    sin_th = torch.sqrt(torch.clamp(1.0 - cos_th * cos_th, min=0.0))
    d = torch.stack(
        [sin_th * torch.cos(phi), sin_th * torch.sin(phi), cos_th], dim=-1)
    half = local_to_world(d, u, v, n)
    flip = dot(half, view) <= 0.0
    return torch.where(flip[..., None], -half, half)


def bsdf_sample(mat, eta_i, eta_o, u, v, n, view, uniforms):
    """-> (light (N, 3), pdf (N,)); pdf 0 ends the path."""
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
        torch.where(ss_pick[..., None], light_ss, light_diff), light_spec)
    light = torch.where(
        trans_branch[..., None],
        torch.where(spec_in_trans[..., None], light_spec, light_refr),
        refl_light)
    pdf_smooth = bsdf_pdf(mat, eta_i, eta_o, n, view, light)
    is_specular_refr = trans_branch & ~spec_in_trans
    pdf = torch.where(
        is_specular_refr,
        torch.where(refr_ok, (1.0 - f) * mat.transmission, 0.0), pdf_smooth)
    return light, pdf


def bsdf_eval(mat, albedo, eta_i, eta_o, n, view, light):
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
        torch.ones_like(cdlin))
    cspec0_dielec = mat.specular[..., None] * 0.08 * (
        1.0 + mat.specular_tint[..., None] * (ctint - 1.0))
    cspec0 = cspec0_dielec + mat.metallic[..., None] * (cdlin - cspec0_dielec)
    below = n_dot_l <= 0.0
    a = torch.clamp(mat.roughness, min=0.001)

    f_v = fresnel_dielectric(n_dot_v, eta_i, eta_o)
    bsdf_below = _rgb(
        mat.transmission * (1.0 - f_v) / torch.clamp(n_dot_l.abs(), min=1e-6)
        * (1.0 - mat.metallic))
    ds = _gtr2(n_dot_h, a)
    fh_dielec = fresnel_dielectric(l_dot_h, eta_i, eta_o)
    fs_trans = cspec0 + fh_dielec[..., None] * (1.0 - cspec0)
    gs = _smith_ggx(n_dot_v, a) * _smith_ggx(n_dot_l, a)
    bsdf_above = (gs * ds)[..., None] * fs_trans
    bsdf_side = torch.where(below[..., None], bsdf_below, bsdf_above)
    bsdf_side = torch.where((mat.transmission > 0.0)[..., None], bsdf_side, 0.0)

    fl_abs = schlick_fresnel(n_dot_l.abs())
    fv = schlick_fresnel(n_dot_v)
    fd_ss = (1.0 - 0.5 * fl_abs) * (1.0 - 0.5 * fv)
    s = torch.sqrt(torch.clamp(mat.color, min=0.0))
    brdf_below = (
        INV_PI * (mat.subsurface * fd_ss * (1.0 - mat.metallic))[..., None] * s)
    brdf_below = torch.where((mat.subsurface > 0.0)[..., None], brdf_below, 0.0)
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
        + _rgb(mat.clearcoat * gr * fc * dr))
    brdf_side = torch.where(below[..., None], brdf_below, brdf_above)
    brdf_side = torch.where((mat.transmission < 1.0)[..., None], brdf_side, 0.0)
    return brdf_side + mat.transmission[..., None] * (bsdf_side - brdf_side)


# ---------------------------------------------------------------- probe
def _alias_table(weights: np.ndarray):
    """Walker/Vose alias table by the two-pointer sweep over the weights in
    ascending order (numpy's default argsort)."""
    k = len(weights)
    total = weights.sum()
    if total <= 0:
        return np.ones(k, np.float32), np.arange(k, dtype=np.int32)
    p = weights.astype(np.float64) * (k / total)
    prob = np.ones(k, dtype=np.float64)
    alias = np.arange(k, dtype=np.int32)
    order = np.argsort(p)
    small = [i for i in order if p[i] < 1.0]
    large = [i for i in order[::-1] if p[i] >= 1.0]
    si = li = 0
    while si < len(small) and li < len(large):
        s, lg = small[si], large[li]
        prob[s] = p[s]
        alias[s] = lg
        p[lg] = (p[lg] + p[s]) - 1.0
        si += 1
        if p[lg] < 1.0:
            small.append(lg)
            li += 1
    return prob.astype(np.float32), alias.astype(np.int32)


class Probe:
    """A lat-long (H, W, 3) radiance image, sampled by luminance
    (0.3/0.6/0.1) through a Walker alias table."""

    def __init__(self, image: np.ndarray, device, dtype):
        rgb = np.asarray(image, dtype=np.float32)[..., :3]
        weight = np.maximum(
            0.3 * rgb[..., 0] + 0.6 * rgb[..., 1] + 0.1 * rgb[..., 2], 0.0)
        row_sum = weight.sum(axis=1)
        safe_row = np.where(row_sum > 0, row_sum, 1.0)
        pdf_x = weight / safe_row[:, None]
        total = row_sum.sum()
        pdf_y = row_sum / (total if total > 0 else 1.0)
        prob, alias = _alias_table(weight.reshape(-1))
        pdf_flat = (pdf_x.astype(np.float32) * pdf_y.astype(np.float32)[:, None]
                    ).reshape(-1).astype(np.float32)
        self.height, self.width = weight.shape
        t = lambda a: torch.tensor(a, device=device)  # noqa: E731
        self.data = t(rgb.reshape(-1, 3)).to(dtype)
        self.alias_prob = t(prob).to(dtype)
        self.alias_idx = t(alias.astype(np.int64))
        self.pdf_flat = t(pdf_flat).to(dtype)

    def eval(self, uv):
        w, h = self.width, self.height
        px = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
        py = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
        return self.data[py * w + px]

    def sample(self, r1, r2):
        """-> (dir (N, 3), color (N, 3), solid-angle pdf (N,))."""
        w, h = self.width, self.height
        k = w * h
        cand = torch.clamp((r1 * k).to(torch.int64), max=k - 1)
        accept = r2 < self.alias_prob[cand]
        lin = torch.where(accept, cand, self.alias_idx[cand])
        row = lin // w
        col = lin - row * w
        color = self.data[lin]
        pdf = self.pdf_flat[lin]
        u = col.to(r1.dtype) / w
        v = row.to(r1.dtype) / h
        sin_theta = torch.sin(v * PI)
        zero = sin_theta == 0.0
        pdf = torch.where(
            zero, 0.0,
            pdf * w * h / (2.0 * PI * PI * torch.where(zero, 1.0, sin_theta)))
        return uv_to_dir(torch.stack([u, v], dim=-1)), color, pdf


def dir_to_uv(d):
    theta = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.where((d[..., 0] == 0.0) & (d[..., 2] == 0.0), 0.0,
                      torch.atan2(d[..., 2], d[..., 0]))
    return torch.stack([(PI + phi) / TWO_PI, theta / PI], dim=-1)


def uv_to_dir(uv):
    theta = uv[..., 1] * PI
    phi = uv[..., 0] * TWO_PI
    sin_t = torch.sin(theta)
    return torch.stack(
        [-sin_t * torch.cos(phi), torch.cos(theta), -sin_t * torch.sin(phi)],
        dim=-1)


# ------------------------------------------------------------- textures
class Textures:
    """The images, padded to one (K, H, W, 3) block, each with its size;
    bilinear filtering with wrap addressing as CUDA's normalized
    coordinates do it: taps at (u w - 0.5, v h - 0.5), floor-mod wrapped,
    lerped in x, then in y."""

    def __init__(self, images, device, dtype):
        images = list(images) or [np.full((1, 1, 3), [1.0, 0.0, 1.0],
                                          dtype=np.float32)]
        kh = max(im.shape[0] for im in images)
        kw = max(im.shape[1] for im in images)
        data = np.zeros((len(images), kh, kw, 3), dtype=np.float32)
        sizes = np.zeros((len(images), 2), dtype=np.int64)
        for i, im in enumerate(images):
            data[i, :im.shape[0], :im.shape[1]] = im[..., :3]
            sizes[i] = (im.shape[1], im.shape[0])
        self.kh, self.kw, self.count = kh, kw, len(images)
        self.flat = torch.tensor(data.reshape(-1, 3), device=device).to(dtype)
        self.sizes = torch.tensor(sizes, device=device)

    def sample(self, tex_ids, uv):
        ids = torch.clamp(tex_ids, 0, self.count - 1)
        wh = self.sizes[ids]
        wi, hi = wh[:, 0], wh[:, 1]
        x = uv[:, 0] * wi.to(uv.dtype) - 0.5
        y = uv[:, 1] * hi.to(uv.dtype) - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = (x - x0)[:, None], (y - y0)[:, None]
        x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
        xa, xb = torch.remainder(x0i, wi), torch.remainder(x0i + 1, wi)
        ya, yb = torch.remainder(y0i, hi), torch.remainder(y0i + 1, hi)
        row = ids * self.kh

        def fetch(yy, xx):
            return self.flat[(row + yy) * self.kw + xx]

        top = fetch(ya, xa) * (1 - fx) + fetch(ya, xb) * fx
        bot = fetch(yb, xa) * (1 - fx) + fetch(yb, xb) * fx
        return top * (1 - fy) + bot * fy
