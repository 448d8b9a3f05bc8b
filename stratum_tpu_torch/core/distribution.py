"""Piecewise-constant 1D/2D sampling distributions (counterpart of
stratum_tpu/core/distribution.py). Builders are host-side numpy (f32, the
reference's dtype); samplers run on torch tensors of any leading shape.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Dist1D(NamedTuple):
    """pdf[N] (mean 1 over [0,1)) and inclusive cdf[N+1], cdf[0]=0,
    cdf[N]=1; batched over leading axes for the 2D conditional."""

    pdf: torch.Tensor
    cdf: torch.Tensor

    @property
    def size(self) -> int:
        return self.pdf.shape[-1]


def build_dist1d(weights) -> Dist1D:
    w = np.maximum(np.asarray(weights, np.float32), np.float32(0.0))
    total = np.sum(w, axis=-1, keepdims=True, dtype=np.float32)
    n = w.shape[-1]
    safe_w = np.where(total > 0.0, w, np.ones_like(w))
    safe_total = np.where(total > 0.0, total, np.float32(n))
    pdf = (safe_w * (np.float32(n) / safe_total)).astype(np.float32)
    cdf = np.cumsum(safe_w / safe_total, axis=-1, dtype=np.float32)
    cdf = np.concatenate([np.zeros_like(cdf[..., :1]), cdf], axis=-1)
    cdf[..., -1] = 1.0
    return Dist1D(pdf=pdf, cdf=cdf)


def sample_dist1d(dist: Dist1D, u):
    """Inverse-CDF sample -> (index, u remapped into the cell, density)."""
    idx = torch.searchsorted(dist.cdf, u.contiguous(), right=True) - 1
    idx = torch.clamp(idx, 0, dist.size - 1)
    c0 = dist.cdf[idx]
    c1 = dist.cdf[idx + 1]
    du = (u - c0) / torch.clamp(c1 - c0, min=1e-20)
    return idx, du, dist.pdf[idx]


class Dist2D(NamedTuple):
    """Marginal over rows + conditional over columns per row."""

    marginal: Dist1D
    cond_pdf: torch.Tensor  # [H, W]
    cond_cdf: torch.Tensor  # [H, W+1]

    @property
    def shape(self):
        return tuple(self.cond_pdf.shape)


def build_dist2d(weights) -> Dist2D:
    w = np.maximum(np.asarray(weights, np.float32), np.float32(0.0))
    marginal = build_dist1d(np.sum(w, axis=-1, dtype=np.float32))
    cond = build_dist1d(w)
    return Dist2D(marginal=marginal, cond_pdf=cond.pdf, cond_cdf=cond.cdf)


def sample_dist2d(dist: Dist2D, u1, u2):
    """Sample uv in [0,1)^2 -> (uv[..., 2], joint density)."""
    h, w = dist.shape
    row, du1, pdf_row = sample_dist1d(dist.marginal, u1)
    cond_cdf = dist.cond_cdf[row]  # [..., W+1]
    col = torch.sum((cond_cdf <= u2[..., None]).to(torch.int64), dim=-1) - 1
    col = torch.clamp(col, 0, w - 1)
    c0 = torch.gather(cond_cdf, -1, col[..., None])[..., 0]
    c1 = torch.gather(cond_cdf, -1, col[..., None] + 1)[..., 0]
    du2 = (u2 - c0) / torch.clamp(c1 - c0, min=1e-20)
    pdf_col = dist.cond_pdf[row, col]
    u = (col.to(torch.float32) + du2) / w
    v = (row.to(torch.float32) + du1) / h
    return torch.stack([u, v], dim=-1), pdf_row * pdf_col



def dist2d_pdf(dist: Dist2D, uv):
    """Joint density at uv in [0,1)^2."""
    h, w = dist.shape
    col = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
    row = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
    return dist.marginal.pdf[row] * dist.cond_pdf[row, col]


def build_env_dist2d(luminance_hw) -> Dist2D:
    """Environment-map distribution: luminance [H, W] weighted by the
    sin(theta) of each row's center (numpy)."""
    lum = np.asarray(luminance_hw, np.float32)
    h = lum.shape[0]
    theta = (np.arange(h, dtype=np.float32) + 0.5) / h * np.pi
    return build_dist2d(lum * np.sin(theta)[:, None])
