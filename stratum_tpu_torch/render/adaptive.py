"""Adaptive sampling: variance-guided per-pixel sample allocation
(counterpart of stratum_tpu/render/adaptive.py).

After ``pilot`` uniform rounds, each round traces one more sample for the L
pixels with the largest marginal-variance score ``var / count^2`` (the
variance smoothed over 5x5 pixels), through the same ``trace_path`` on the
chosen pixel coordinates (the pixel-keyed RNG samples a scattered subset
exactly as a full frame would), and adds it back per pixel. Scores depend
only on earlier rounds, so each pixel's mean stays unbiased given the
allocation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.render import integrator as sintegrator


class AdaptiveState:
    """Per-pixel running sums, flat [n] over the pixel domain."""

    def __init__(self, accum, accum_sq, count):
        self.accum = accum  # [n, 3] radiance sum
        self.accum_sq = accum_sq  # [n] luminance^2 sum
        self.count = count  # [n] f32 samples per pixel


def init_state(num_pixels: int, device="cuda") -> AdaptiveState:
    """Zeroed sums on ``device`` (the card unless the caller asks for the CPU)."""
    f32 = dict(dtype=torch.float32, device=device)
    return AdaptiveState(torch.zeros((num_pixels, 3), **f32), torch.zeros((num_pixels,), **f32),
                         torch.zeros((num_pixels,), **f32))


def _topk_pixels(cfg, accum, accum_sq, count, L: int):
    """The L pixels of largest smoothed marginal variance -> (flat idx,
    px, py). Equal scores keep the lower index first, as ``lax.top_k``
    does: a stable descending sort (``torch.topk`` promises no tie order)."""
    n = cfg.width * cfg.height
    c1 = torch.clamp(count, min=1.0)
    mean = smath.luminance(accum) / c1
    var = torch.clamp(accum_sq / c1 - mean * mean, min=0.0)
    # a 5x5 box average ("SAME", zero padding) steadies the few-sample
    # variances: noise is locally stationary
    k = torch.full((1, 1, 5, 5), 1.0 / 25.0, dtype=torch.float32, device=var.device)
    var = F.conv2d(var.reshape(1, 1, cfg.height, cfg.width), k, padding=2).reshape(n)
    score = (var + 1e-8) / c1 ** 2
    idx = torch.sort(score, descending=True, stable=True).indices[:L]
    return idx, (idx % cfg.width).to(torch.int32), (idx // cfg.width).to(torch.int32)


def _adaptive_round(scene, view, cfg, accum, accum_sq, count, L: int, seed):
    """One round: a sample for each of the top-L pixels."""
    idx, px, py = _topk_pixels(cfg, accum, accum_sq, count, L)
    rad, _ = sintegrator.trace_path(scene, view, cfg, seed, px, py)
    return (accum.index_add(0, idx, rad),
            accum_sq.index_add(0, idx, smath.luminance(rad) ** 2),
            count.index_add(0, idx, torch.ones_like(count[:L])))


def _uniform_round(scene, view, cfg, accum, accum_sq, count, seed):
    rad, _ = sintegrator.trace_path(scene, view, cfg, seed)
    return accum + rad, accum_sq + smath.luminance(rad) ** 2, count + 1.0


def render_adaptive(scene, view, cfg, total_rays_budget_spp: float, pilot: int = 2,
                    frac: float = 0.25, seed0: int = 0):
    """Render with an average of ``total_rays_budget_spp`` camera samples
    per pixel: ``pilot`` uniform rounds, then top-``frac`` rounds until the
    budget is spent -> (image [H, W, 3], state)."""
    n = cfg.width * cfg.height
    st = init_state(n, scene.device)
    accum, accum_sq, count = st.accum, st.accum_sq, st.count
    spent = 0.0
    seed = seed0
    for _ in range(min(pilot, int(total_rays_budget_spp))):
        accum, accum_sq, count = _uniform_round(scene, view, cfg, accum, accum_sq, count, seed)
        spent += 1.0
        seed += 1
    L = max(int(round(n * frac)), 1)
    while spent + frac <= total_rays_budget_spp + 1e-6:
        accum, accum_sq, count = _adaptive_round(scene, view, cfg, accum, accum_sq, count, L,
                                                 seed)
        spent += L / n
        seed += 1
    img = accum / torch.clamp(count, min=1.0)[:, None]
    return img.reshape(cfg.height, cfg.width, 3), AdaptiveState(accum, accum_sq, count)
