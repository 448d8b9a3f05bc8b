"""Core rendering math on torch tensors (counterpart of
stratum_tpu/core/math.py): the vector helpers, frames, sphere mappings and
sampling routines the path tracer calls. Vectors live on the last axis.
"""

from __future__ import annotations

import numpy as np
import torch

INV_PI = 1.0 / np.pi
TWO_PI = 2.0 * np.pi
INV_4PI = 1.0 / (4.0 * np.pi)


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def dotk(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def length(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def length_squared(v):
    return torch.sum(v * v, dim=-1)


def normalize(v, eps: float = 1e-20):
    """Safe normalize; zero vectors map to zero."""
    d = torch.sum(v * v, dim=-1, keepdim=True)
    return v * torch.rsqrt(torch.clamp(d, min=eps))


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_div(a, b, eps: float = 1e-20):
    """a/b with 0 where |b| is tiny."""
    ok = torch.abs(b) > eps
    return torch.where(ok, a / torch.where(ok, b, torch.ones_like(b)), 0.0)


def max3(v):
    return torch.amax(v, dim=-1)


def lerp(a, b, t):
    return a + (b - a) * t


def pow5(x):
    x2 = x * x
    return x2 * x2 * x


def luminance(rgb):
    """Rec.709 luminance of linear RGB, last axis = 3."""
    w = torch.tensor([0.2126, 0.7152, 0.0722], dtype=rgb.dtype, device=rgb.device)
    return torch.sum(rgb * w, dim=-1)


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


_VIRIDIS = np.asarray([
    [0.2777273272234177, 0.005407344544966578, 0.3340998053353061],
    [0.1050930431085774, 1.404613529898575, 1.384590162594685],
    [-0.3308618287255563, 0.214847559468213, 0.09509516302823659],
    [-4.634230498983486, -5.799100973351585, -19.33244095627987],
    [6.228269936347081, 14.17993336680509, 56.69055260068105],
    [4.776384997670288, -13.74514537774601, -65.35303263337234],
    [-5.435455855934631, 4.645852612178535, 26.3124352495832],
], np.float32)


def viridis(t):
    """Viridis-like colormap (the reference's quintic-style polynomial
    fit, core/math.py:120-135), t in [0, 1] -> rgb [..., 3]."""
    t = saturate(t)[..., None]
    c = torch.tensor(_VIRIDIS, device=t.device)
    acc = c[6]
    for k in range(5, -1, -1):
        acc = c[k] + t * acc
    return acc


def make_orthonormal(n):
    """Tangent/bitangent for unit normal n (Duff et al. 2017 branchless)."""
    nx, ny, nz = n.unbind(-1)
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt


def to_local(v, n):
    t, b = make_orthonormal(n)
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def to_world(v, n):
    t, b = make_orthonormal(n)
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def cartesian_to_spherical_uv(v):
    """Unit direction -> equirect uv in [0,1]^2 (azimuth atan2(z, x),
    polar angle from +y)."""
    theta = torch.atan2(v[..., 2], v[..., 0])
    u = theta * INV_PI * 0.5 + 0.5
    vv = torch.arccos(torch.clamp(v[..., 1], -1.0, 1.0)) * INV_PI
    return torch.stack([u, vv], dim=-1)


def spherical_uv_to_cartesian(uv):
    phi = (uv[..., 0] * 2.0 - 1.0) * np.pi
    theta = uv[..., 1] * np.pi
    sin_t = torch.sin(theta)
    return torch.stack(
        [sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi)],
        dim=-1,
    )


def sample_uniform_sphere(u1, u2):
    """Two uniforms -> unit direction uniform on the sphere."""
    phi = TWO_PI * u2
    cos_theta = 2.0 * u1 - 1.0
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    return torch.stack(
        [sin_theta * torch.cos(phi), cos_theta, sin_theta * torch.sin(phi)], dim=-1
    )


def sample_cos_hemisphere(u1, u2):
    """Two uniforms -> cosine-weighted direction in the local frame (+z)."""
    phi = TWO_PI * u2
    r = torch.sqrt(u1)
    return torch.stack(
        [r * torch.cos(phi), r * torch.sin(phi), safe_sqrt(1.0 - u1)], dim=-1
    )


def cosine_hemisphere_pdfW(cos_theta):
    return torch.clamp(cos_theta, min=0.0) * INV_PI


def sample_uniform_triangle(u1, u2):
    """Two uniforms -> barycentric (b1, b2) uniform over a triangle."""
    su1 = torch.sqrt(u1)
    return (1.0 - su1), (u2 * su1)
