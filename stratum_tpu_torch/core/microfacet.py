"""Microfacet building blocks (counterpart of stratum_tpu/core/microfacet.py):
Fresnel, GGX/GTR distributions, Smith masking and Heitz VNDF sampling in the
local shading frame (+z = shading normal).
"""

from __future__ import annotations

import numpy as np
import torch

from stratum_tpu_torch.core import math as smath


def schlick_fresnel(f0, cos_theta):
    w = smath.pow5(1.0 - torch.clamp(cos_theta, 0.0, 1.0))
    return f0 + (1.0 - f0) * w


def fresnel_dielectric(cos_theta_i, eta):
    """Exact unpolarized dielectric Fresnel with total internal reflection."""
    ci = torch.clamp(torch.abs(cos_theta_i), 0.0, 1.0)
    sin2_t = (1.0 - ci * ci) / torch.clamp(eta * eta, min=1e-12)
    tir = sin2_t >= 1.0
    ct = smath.safe_sqrt(1.0 - sin2_t)
    r_s = (ci - eta * ct) / torch.clamp(ci + eta * ct, min=1e-12)
    r_p = (eta * ci - ct) / torch.clamp(eta * ci + ct, min=1e-12)
    f = 0.5 * (r_s * r_s + r_p * r_p)
    return torch.where(tir, 1.0, torch.clamp(f, 0.0, 1.0))


def ggx_alpha(roughness, anisotropic):
    aspect = torch.sqrt(1.0 - 0.9 * anisotropic)
    r2 = roughness * roughness
    return torch.clamp(r2 / aspect, min=1e-4), torch.clamp(r2 * aspect, min=1e-4)


def gtr2_ndf(h, ax, ay):
    hx, hy, hz = h.unbind(-1)
    d = (hx * hx) / (ax * ax) + (hy * hy) / (ay * ay) + hz * hz
    return 1.0 / torch.clamp(np.pi * ax * ay * d * d, min=1e-20)


def smith_lambda(w, ax, ay):
    wx, wy, wz = w.unbind(-1)
    a2 = (wx * ax) ** 2 + (wy * ay) ** 2
    return 0.5 * (torch.sqrt(1.0 + a2 / torch.clamp(wz * wz, min=1e-12)) - 1.0)


def smith_g1(w, ax, ay):
    return 1.0 / (1.0 + smith_lambda(w, ax, ay))


def sample_vndf(wo, ax, ay, u1, u2):
    """Heitz 2018 visible-NDF sampling; wo.z > 0. Returns h (local)."""
    v = smath.normalize(
        torch.stack([ax * wo[..., 0], ay * wo[..., 1], wo[..., 2]], dim=-1)
    )
    lensq = v[..., 0] ** 2 + v[..., 1] ** 2
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device)
    t1 = torch.where(
        (lensq > 1e-12)[..., None],
        torch.stack(
            [-v[..., 1] * inv_len, v[..., 0] * inv_len, torch.zeros_like(inv_len)],
            dim=-1,
        ),
        x_axis.expand(v.shape),
    )
    t2 = smath.cross(v, t1)
    r = torch.sqrt(u1)
    phi = smath.TWO_PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v[..., 2])
    p2 = (1.0 - s) * smath.safe_sqrt(1.0 - p1 * p1) + s * p2
    p3 = smath.safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * v
    return smath.normalize(
        torch.stack(
            [ax * nh[..., 0], ay * nh[..., 1], torch.clamp(nh[..., 2], min=0.0)],
            dim=-1,
        )
    )


def vndf_pdf(wo, h, ax, ay):
    d = gtr2_ndf(h, ax, ay)
    g1 = smith_g1(wo, ax, ay)
    return smath.safe_div(
        g1 * d * torch.clamp(smath.dot(wo, h), min=0.0), torch.abs(wo[..., 2])
    )


def gtr1_ndf(hz, alpha):
    a2 = alpha * alpha
    denom = np.pi * torch.log(torch.clamp(a2, min=1e-12)) * (1.0 + (a2 - 1.0) * hz * hz)
    return smath.safe_div(a2 - 1.0, denom)


def sample_gtr1(alpha, u1, u2):
    a2 = alpha * alpha
    cos2 = (1.0 - torch.pow(a2, 1.0 - u1)) / torch.clamp(1.0 - a2, min=1e-12)
    cos_t = smath.safe_sqrt(cos2)
    sin_t = smath.safe_sqrt(1.0 - cos2)
    phi = smath.TWO_PI * u2
    return torch.stack(
        [sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1
    )


def reflect(w, n):
    return 2.0 * smath.dotk(w, n) * n - w


def refract(w, n, eta):
    """Refract w (pointing away from the surface) with relative IOR eta."""
    cos_i = smath.dot(w, n)
    sin2_t = (1.0 - cos_i * cos_i) / torch.clamp(eta * eta, min=1e-20)
    valid = sin2_t < 1.0
    cos_t = smath.safe_sqrt(1.0 - sin2_t)
    wt = -w / eta[..., None] + (cos_i / eta - cos_t)[..., None] * n
    return smath.normalize(wt), valid
