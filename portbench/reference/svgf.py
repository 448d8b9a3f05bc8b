"""SVGF and the fitted ACES curve, in plain torch on [H, W, C] images.

The same mathematics as the program's denoiser states (a bilinear 4-tap
reprojection gated by instance, normal and depth; an exponential moving
average capped at ``history_limit``; luminance moments and variance with a
5 x 5 spatial fallback for young pixels; five edge-aware a-trous
iterations with the B3 kernel; demodulation by albedo), written afresh:
edge-clamped shifts are slices of a replicate-padded image. ``dtype`` is
the precision of the arithmetic (the control runs it in bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

HISTORY_LIMIT = 16.0
ITERATIONS = 5
SIGMA_L, SIGMA_N, SIGMA_Z = 4.0, 128.0, 1.0
VARIANCE_BOOST = 8.0
COS_2DEG = float(np.float32(np.cos(np.radians(2.0))))
B3 = (1.0, float(np.float32(2.0 / 3.0)), float(np.float32(1.0 / 6.0)))
LUMA = (0.2126, 0.7152, 0.0722)
ACES_IN = ((0.59719, 0.35458, 0.04823), (0.07600, 0.90834, 0.01566),
           (0.02840, 0.13383, 0.83777))
ACES_OUT = ((1.60475, -0.53108, -0.07367), (-0.10208, 1.10813, -0.00605),
            (-0.00327, -0.07276, 1.07602))


def luminance(c):
    return c[..., 0] * LUMA[0] + c[..., 1] * LUMA[1] + c[..., 2] * LUMA[2]


class Padded:
    """An image replicate-padded by ``p``: ``at(dy, dx)`` is the image
    shifted so that out[y, x] = img[clamp(y - dy), clamp(x - dx)]."""

    def __init__(self, img, p: int):
        self.h, self.w, self.p = img.shape[0], img.shape[1], p
        x = img if img.dim() == 3 else img[..., None]
        self.squeeze = img.dim() == 2
        self.pad = F.pad(x.permute(2, 0, 1)[None], (p, p, p, p), mode="replicate")[0]

    def at(self, dy: int, dx: int):
        y0, x0 = self.p - dy, self.p - dx
        out = self.pad[:, y0:y0 + self.h, x0:x0 + self.w].permute(1, 2, 0)
        return out[..., 0] if self.squeeze else out


def temporal(state: dict, radiance, gbuf: dict, dtype=torch.float32):
    """-> (new state, integrated colour, variance)."""
    f = {k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}
    g = {k: v.to(dtype) if v.is_floating_point() else v for k, v in gbuf.items()}
    radiance = radiance.to(dtype)
    h, w = radiance.shape[:2]
    color_in = radiance / torch.clamp(g["albedo"], min=1e-3)
    lum = luminance(color_in)
    mom_in = torch.stack([lum, lum * lum], dim=-1)
    uv = g["prev_uv"]
    valid = (uv[..., 0] >= 0) & (uv[..., 1] >= 0)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    acc_c = torch.zeros_like(color_in)
    acc_m = torch.zeros_like(mom_in)
    acc_h = torch.zeros_like(lum)
    acc_w = torch.zeros_like(lum)
    for dy, dx, wt in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                       (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
        yi, xi = y0 + dy, x0 + dx
        yc, xc = yi.clamp(0, h - 1), xi.clamp(0, w - 1)
        n_ok = (f["normal"][yc, xc] * g["normal"]).sum(-1) > COS_2DEG
        z_ok = (f["depth"][yc, xc] - g["depth"]).abs() < 0.1 * torch.clamp(g["depth"], min=1e-3)
        ok = (valid & (f["instance"][yc, xc] == g["instance"]) & n_ok & z_ok
              & (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))
        tw = torch.where(ok, wt, 0.0)
        acc_c = acc_c + f["color"][yc, xc] * tw[..., None]
        acc_m = acc_m + f["moments"][yc, xc] * tw[..., None]
        acc_h = acc_h + f["history"][yc, xc] * tw
        acc_w = acc_w + tw
    has = acc_w > 1e-3
    inv = torch.where(has, 1.0 / torch.clamp(acc_w, min=1e-3), 0.0)
    n = torch.where(has, torch.clamp(acc_h * inv + 1.0, max=HISTORY_LIMIT), 1.0)
    alpha = (1.0 / n)[..., None]
    prev_c, prev_m = acc_c * inv[..., None], acc_m * inv[..., None]
    color = torch.where(has[..., None], prev_c + (color_in - prev_c) * alpha, color_in)
    moments = torch.where(has[..., None], prev_m + (mom_in - prev_m) * alpha, mom_in)
    # variance: temporal from the moments, 5 x 5 spatial for young pixels
    var_t = torch.clamp(moments[..., 1] - moments[..., 0] ** 2, min=0.0)
    pl = Padded(lum, 2)
    m1 = torch.zeros_like(lum)
    m2 = torch.zeros_like(lum)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            s = pl.at(dy, dx)
            m1 = m1 + s
            m2 = m2 + s * s
    m1, m2 = m1 / 25.0, m2 / 25.0
    young = n < 4.0
    boost = torch.where(young, VARIANCE_BOOST / torch.clamp(n, min=1.0), 1.0)
    variance = torch.where(young, torch.clamp(m2 - m1 * m1, min=0.0), var_t) * boost
    new = dict(color=color, moments=moments, history=n, normal=g["normal"],
               depth=g["depth"], instance=g["instance"])
    return new, color, variance


def atrous(color, variance, gbuf: dict, dtype=torch.float32):
    """Five edge-aware a-trous iterations over the foreground."""
    normal = gbuf["normal"].to(dtype)
    fg = torch.isfinite(gbuf["depth"])
    depth = torch.where(fg, gbuf["depth"], 3.0e37).to(dtype)
    pd = Padded(depth, 1)
    dz = torch.maximum((pd.at(0, 1) - depth).abs(), (pd.at(1, 0) - depth).abs()) + 1e-4
    source = color
    for it in range(ITERATIONS):
        step = 1 << it
        pv = Padded(variance, 1)
        gvar = torch.zeros_like(variance)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                gvar = gvar + (2.0 - abs(dy)) * (2.0 - abs(dx)) * pv.at(dy, dx)
        sigma = SIGMA_L * torch.sqrt(gvar / 16.0) + 1e-6
        lum_c = luminance(color)
        pk = Padded(torch.cat([color, variance[..., None], normal, depth[..., None],
                               lum_c[..., None]], dim=-1), 2 * step)
        acc = torch.zeros_like(color)
        acc_v = torch.zeros_like(variance)
        wsum = torch.zeros_like(variance)
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                nb = pk.at(dy * step, dx * step)
                w_l = torch.exp(-(nb[..., 8] - lum_c).abs() / sigma)
                w_n = torch.clamp((nb[..., 4:7] * normal).sum(-1), min=0.0) ** SIGMA_N
                w_z = torch.exp(-(nb[..., 7] - depth).abs()
                                / (SIGMA_Z * dz * (abs(dy) + abs(dx) + 1e-3) * step + 1e-6))
                wgt = B3[abs(dy)] * B3[abs(dx)] * w_l * w_n * w_z
                acc = acc + nb[..., 0:3] * wgt[..., None]
                acc_v = acc_v + nb[..., 3] * wgt * wgt
                wsum = wsum + wgt
        color = torch.where(fg[..., None], acc / torch.clamp(wsum, min=1e-6)[..., None], source)
        variance = acc_v / torch.clamp(wsum * wsum, min=1e-6)
    return color


def denoise(state: dict, radiance, gbuf: dict, dtype=torch.float32):
    """One SVGF pass -> (new state, denoised radiance), both f32."""
    new, color, variance = temporal(state, radiance, gbuf, dtype)
    out = atrous(color, variance, gbuf, dtype) * torch.clamp(gbuf["albedo"].to(dtype), min=1e-3)
    return {k: v.float() if v.is_floating_point() else v for k, v in new.items()}, out.float()


def aces(c, dtype=torch.float32):
    """The fitted ACES curve, clamped to [0, 1]."""
    c = c.to(dtype)

    def mat(m, x):
        return torch.stack([x[..., 0] * r[0] + x[..., 1] * r[1] + x[..., 2] * r[2] for r in m],
                           dim=-1)

    v = mat(ACES_IN, c)
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return torch.clamp(mat(ACES_OUT, a / b), 0.0, 1.0).float()
