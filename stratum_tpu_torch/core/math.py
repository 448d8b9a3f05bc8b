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


# ---------------------------------------------------------------------------
# CIE 1931 analytic fits (Wyman et al., JCGT 2013): spectra -> RGB for the
# Mitsuba loader, on the host in numpy float32
# ---------------------------------------------------------------------------

_F = np.float32


def _fma(a, b, c):
    """a * b + c with one float32 rounding (the f32 product is exact in
    float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _expf(x):
    """float32 exp as the reference's CPU backend computes it (the Cephes
    polynomial with fused multiply-adds), so the fits below agree with the
    reference's bit for bit; on [-87, 88.7] it is ``np.exp`` within 1 ulp."""
    x = np.minimum(np.maximum(np.asarray(x, np.float32), _F(-87.8)), _F(88.8))
    fx = np.floor(_fma(x, _F(1.4426950216293335), _F(0.5)))
    fx = np.minimum(np.maximum(fx, _F(-127.0)), _F(127.0))
    r = _fma(-fx, _F(0.693359375), x)
    r = _fma(-fx, _F(-0.00021219444170128554), r)
    y = _fma(r, _F(0.00019875691214110702), _F(0.001398199936375022))
    for c in (0.008333452045917511, 0.04166579619050026, 0.1666666567325592, 0.5):
        y = _fma(y, r, _F(c))
    y = _F(1.0) + _fma(y, r * r, r)
    return (y * ((fx.astype(np.int32) + 127) << 23).view(np.float32)).astype(np.float32)


def _lobe(w, center, lo, hi):
    t = (w - _F(center)) * np.where(w < center, _F(lo), _F(hi))
    return _expf(_F(-0.5) * t * t)


def cie_x_fit(wavelength):
    w = np.asarray(wavelength, np.float32)
    return (_F(0.362) * _lobe(w, 442.0, 0.0624, 0.0374)
            + _F(1.056) * _lobe(w, 599.8, 0.0264, 0.0323)
            - _F(0.065) * _lobe(w, 501.1, 0.0490, 0.0382))


def cie_y_fit(wavelength):
    w = np.asarray(wavelength, np.float32)
    return _F(0.821) * _lobe(w, 568.8, 0.0213, 0.0247) + _F(0.286) * _lobe(w, 530.9, 0.0613, 0.0322)


def cie_z_fit(wavelength):
    w = np.asarray(wavelength, np.float32)
    return _F(1.217) * _lobe(w, 437.0, 0.0845, 0.0278) + _F(0.681) * _lobe(w, 459.0, 0.0385, 0.0725)


_XYZ_TO_RGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    dtype=np.float32,
)


def integrate_spectrum_to_rgb(wavelengths: np.ndarray, values: np.ndarray) -> np.ndarray:
    """A sampled spectrum integrated against the CIE fits on 400-700 nm ->
    linear sRGB (the reference's integration for Mitsuba spectra,
    common.h:210-268)."""
    CIE_Y_INTEGRAL = 106.856895
    grid = np.arange(400.0, 701.0, 1.0, dtype=np.float32)
    vals = np.interp(grid, wavelengths, values, left=values[0], right=values[-1])
    xyz = np.stack([cie_x_fit(grid), cie_y_fit(grid), cie_z_fit(grid)], axis=0)
    XYZ = (xyz * vals[None, :]).sum(axis=1) / CIE_Y_INTEGRAL
    return np.maximum(_XYZ_TO_RGB @ XYZ, 0.0).astype(np.float32)
