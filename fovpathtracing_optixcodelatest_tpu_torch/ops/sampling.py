"""Geometric sampling and frame helpers over (..., 3) float32 tensors
(counterpart of the JAX package's ``ops/sampling.py``)."""

from __future__ import annotations

import torch

TWO_PI = 6.283185307179586
PI = 3.141592653589793
INV_PI = 1.0 / PI
INV_2PI = 0.5 / PI


def dot(a, b):
    """Three-term dot product summed left to right, so the CPU and CUDA
    results match bit for bit (a reduction kernel may reassociate)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def normalize(v, eps=1e-20):
    return v * torch.reciprocal(torch.sqrt(torch.clamp(dot(v, v), min=eps)))[..., None]


def safe_normalize(v, fallback=None):
    """Normalize; near-zero vectors map to 0 (or ``fallback``)."""
    length2 = dot(v, v)
    ok = length2 > 1e-20
    inv = torch.where(
        ok, torch.reciprocal(torch.sqrt(torch.clamp(length2, min=1e-20))), 0.0
    )
    out = v * inv[..., None]
    if fallback is not None:
        out = torch.where(ok[..., None], out, fallback)
    return out


def luminance(c):
    return 0.3 * c[..., 0] + 0.6 * c[..., 1] + 0.1 * c[..., 2]


def luminance_rec709(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def basis_from_vector(w):
    """(u, v) orthonormal to unit w; the tangent lies in the xz-plane when
    |w.x| > |w.y|, else in the yz-plane."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    inv_xz = torch.reciprocal(torch.sqrt(torch.clamp(wx * wx + wz * wz, min=1e-20)))
    inv_yz = torch.reciprocal(torch.sqrt(torch.clamp(wy * wy + wz * wz, min=1e-20)))
    zero = torch.zeros_like(wx)
    u_a = torch.stack([-wz * inv_xz, zero, wx * inv_xz], dim=-1)
    u_b = torch.stack([zero, wz * inv_yz, -wy * inv_yz], dim=-1)
    use_a = (wx.abs() > wy.abs())[..., None]
    u = torch.where(use_a, u_a, u_b)
    return u, cross(w, u)


def onb(n):
    """The raygen frame of the reference's Onb -> (tangent, binormal): the
    binormal from the larger of |n.x| and |n.z|."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    zero = torch.zeros_like(nx)
    b_a = torch.stack([-ny, nx, zero], dim=-1)
    b_b = torch.stack([zero, -nz, ny], dim=-1)
    use_a = (nx.abs() > nz.abs())[..., None]
    binormal = normalize(torch.where(use_a, b_a, b_b))
    return cross(binormal, n), binormal


def face_forward(n, v):
    """Flip n into the hemisphere of v."""
    return torch.where(dot(n, v)[..., None] < 0.0, -n, n)


def uniform_sample_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sample_hemisphere(u1, u2):
    """z = u1 directly (not cosine-weighted)."""
    z = u1
    w = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u2
    return torch.stack([torch.cos(phi) * w, torch.sin(phi) * w, z], dim=-1)


def uniform_sample_disc(u1, u2):
    r = torch.sqrt(u1)
    theta = TWO_PI * u2
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def cosine_sample_hemisphere(u1, u2):
    s = uniform_sample_disc(u1, u2)
    z = torch.sqrt(torch.clamp(1.0 - s[..., 0] ** 2 - s[..., 1] ** 2, min=0.0))
    return torch.stack([s[..., 0], s[..., 1], z], dim=-1)


def uniform_sample_triangle(u1, u2):
    """Barycentric (u, v) uniform over a triangle."""
    r = torch.sqrt(u1)
    return 1.0 - r, u2 * r


def local_to_world(d, u, v, n):
    return u * d[..., 0:1] + v * d[..., 1:2] + n * d[..., 2:3]


def reflect(v, h):
    return 2.0 * dot(v, h)[..., None] * h - v


def refract(wi, n, eta):
    """Snell refraction; returns (wt, ok), ok False on total internal
    reflection."""
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
    """Exact dielectric Fresnel; 1 on total internal reflection."""
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
