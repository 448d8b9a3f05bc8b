"""SVGF-style denoiser: temporal reprojection and variance-guided a-trous
filtering (counterpart of stratum_tpu/render/denoise.py).

- ``temporal_accumulate``: a bilinear 4-tap reprojection of the history,
  each tap gated by instance, normal and depth, an exponential moving
  average capped by ``history_limit``, and the first two luminance moments;
- ``estimate_variance``: variance from the moments, with a 5x5 spatial
  fallback and a boost for young pixels;
- ``atrous_filter``: edge-aware a-trous iterations with luminance, depth
  and normal edge-stopping weights and a dilation of 2^i.

Plain torch ops on [H, W, C] images on the device of their inputs. A shift
is an edge-clamped copy (the reference's ``jnp.pad(mode="edge")`` and a
slice) made by two row and column index gathers; inside an a-trous
iteration the colour, variance, normal, depth and colour luminance of a
pixel are shifted together as one 9-channel image, one copy a tap.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.render.aov import GBuffer

_COS_2DEG = np.float32(np.cos(np.radians(2.0)))


@dataclasses.dataclass(frozen=True)
class DenoiseConfig:
    history_limit: float = 16.0  # EMA cap
    atrous_iterations: int = 5
    sigma_luminance: float = 4.0  # luminance edge sigma boost
    sigma_normal: float = 128.0  # normal edge-stopping power
    sigma_depth: float = 1.0
    variance_boost: float = 8.0  # young-pixel variance boost
    demodulate_albedo: bool = True
    # a-trous tap pattern: "atrous" | "box3" | "box5" | "subsampled" |
    # "box3_subsampled" | "box5_subsampled"
    filter_type: str = "atrous"
    # > 0: the output of a-trous iteration history_tap - 1 becomes the
    # temporal history's colour, so the next frame accumulates on a
    # partly filtered image
    history_tap: int = 0
    # "none" | "sample_count" | "variance" | "weight_sum"
    debug_mode: str = "none"


class DenoiseState(NamedTuple):
    """Cross-frame history."""

    color: torch.Tensor  # f32 [H, W, 3] accumulated (demodulated) colour
    moments: torch.Tensor  # f32 [H, W, 2] E[l], E[l^2]
    history: torch.Tensor  # f32 [H, W] accumulated frame count
    normal: torch.Tensor  # f32 [H, W, 3] the previous frame's normals
    depth: torch.Tensor  # f32 [H, W]
    instance: torch.Tensor  # i32 [H, W]


def init_state(height: int, width: int, device="cuda") -> DenoiseState:
    """An empty history on ``device`` (the card unless the caller asks for
    the CPU)."""
    f32 = dict(dtype=torch.float32, device=device)
    return DenoiseState(
        color=torch.zeros((height, width, 3), **f32),
        moments=torch.zeros((height, width, 2), **f32),
        history=torch.zeros((height, width), **f32),
        normal=torch.zeros((height, width, 3), **f32),
        depth=torch.full((height, width), torch.inf, **f32),
        instance=torch.full((height, width), -1, dtype=torch.int32, device=device),
    )


def _tap(img, yi, xi):
    """img[clamp(yi), clamp(xi)] for integer index images yi, xi."""
    h, w = img.shape[:2]
    return img[torch.clamp(yi, 0, h - 1).long(), torch.clamp(xi, 0, w - 1).long()]


def temporal_accumulate(state: DenoiseState, radiance, gbuf: GBuffer, cfg: DenoiseConfig,
                        with_aux: bool = False):
    """Reproject the history and blend -> (new state, integrated colour,
    variance); with ``with_aux`` also a dict of the reprojection weight sum
    and the history length. ``radiance`` and ``gbuf`` may be a band of
    rows of the image whose history ``state`` holds: ``prev_uv`` maps
    into the whole history."""
    h, w = state.color.shape[:2]
    color_in = radiance
    if cfg.demodulate_albedo:
        color_in = radiance / torch.clamp(gbuf.albedo, min=1e-3)
    lum = smath.luminance(color_in)
    moments_in = torch.stack([lum, lum * lum], dim=-1)

    # 4-tap bilinear history lookup at prev_uv; floor (not truncation)
    # keeps the reference's taps where prev_uv is -1
    uv = gbuf.prev_uv
    valid_uv = (uv[..., 0] >= 0) & (uv[..., 1] >= 0)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = x - x0
    fy = y - y0
    weights = [(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy]
    offsets = [(0, 0), (0, 1), (1, 0), (1, 1)]
    # the history's float fields as one image: one gather a tap
    hist = torch.cat([state.color, state.moments, state.history[..., None],
                      state.normal, state.depth[..., None]], dim=-1)
    acc_c = torch.zeros_like(color_in)
    acc_m = torch.zeros_like(moments_in)
    acc_h = torch.zeros(radiance.shape[:2], dtype=torch.float32, device=radiance.device)
    acc_w = torch.zeros(radiance.shape[:2], dtype=torch.float32, device=radiance.device)
    for (dy, dx), wgt in zip(offsets, weights):
        yi = y0 + dy
        xi = x0 + dx
        tap = _tap(hist, yi, xi)
        same_inst = _tap(state.instance, yi, xi) == gbuf.instance
        n_ok = smath.dot(tap[..., 6:9], gbuf.normal) > _COS_2DEG
        z_ok = torch.abs(tap[..., 9] - gbuf.depth) < 0.1 * torch.clamp(gbuf.depth, min=1e-3)
        ok = (valid_uv & same_inst & n_ok & z_ok & (yi >= 0) & (yi < h) & (xi >= 0)
              & (xi < w))
        tw = torch.where(ok, wgt, 0.0)
        acc_c = acc_c + tap[..., 0:3] * tw[..., None]
        acc_m = acc_m + tap[..., 3:5] * tw[..., None]
        acc_h = acc_h + tap[..., 5] * tw
        acc_w = acc_w + tw
    has_hist = acc_w > 1e-3
    inv_w = torch.where(has_hist, 1.0 / torch.clamp(acc_w, min=1e-3), 0.0)
    prev_c = acc_c * inv_w[..., None]
    prev_m = acc_m * inv_w[..., None]
    prev_n = acc_h * inv_w

    n = torch.where(has_hist, torch.clamp(prev_n + 1.0, max=cfg.history_limit), 1.0)
    alpha = 1.0 / n
    hh = has_hist[..., None]
    color = torch.where(hh, prev_c + (color_in - prev_c) * alpha[..., None], color_in)
    moments = torch.where(hh, prev_m + (moments_in - prev_m) * alpha[..., None], moments_in)
    variance = estimate_variance(moments, n, lum, cfg)
    new_state = DenoiseState(color=color, moments=moments, history=n, normal=gbuf.normal,
                             depth=gbuf.depth, instance=gbuf.instance)
    if with_aux:
        return new_state, color, variance, {"weight_sum": acc_w, "history": n}
    return new_state, color, variance


_INDEX_CACHE: dict = {}


def _clamped_index(n: int, d: int, device):
    """clamp(arange(n) - d, 0, n - 1) as int64 on ``device``, cached."""
    key = (n, d, str(device))
    idx = _INDEX_CACHE.get(key)
    if idx is None:
        idx = torch.clamp(torch.arange(n, device=device) - d, 0, n - 1)
        _INDEX_CACHE[key] = idx
    return idx


def _shift(img, dy: int, dx: int):
    """Edge-clamped static shift: out[y, x] = img[clamp(y - dy), clamp(x - dx)]
    (an exact copy, as the reference's edge padding and slice)."""
    h, w = img.shape[:2]
    if dy:
        img = img.index_select(0, _clamped_index(h, dy, img.device))
    if dx:
        img = img.index_select(1, _clamped_index(w, dx, img.device))
    return img


def estimate_variance(moments, history, lum, cfg: DenoiseConfig):
    """Variance from the moments, with a 5x5 spatial moment fallback for
    pixels with fewer than 4 frames of history."""
    var_t = torch.clamp(moments[..., 1] - moments[..., 0] ** 2, min=0.0)
    m1 = torch.zeros_like(lum)
    m2 = torch.zeros_like(lum)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            lv = _shift(lum, dy, dx)
            m1 = m1 + lv
            m2 = m2 + lv * lv
    m1 = m1 / 25.0
    m2 = m2 / 25.0
    var_s = torch.clamp(m2 - m1 * m1, min=0.0)
    young = history < 4.0
    boost = torch.where(young, cfg.variance_boost / torch.clamp(history, min=1.0), 1.0)
    return torch.where(young, var_s, var_t) * boost


_ATROUS_W = np.asarray([1.0, 2.0 / 3.0, 1.0 / 6.0], np.float32)  # B3 spline


def _filter_taps(filter_type: str, it: int):
    """(dy, dx, kernel weight) taps of one filter iteration, centre
    included; ``subsampled`` alternates its 2-step axis by iteration
    parity, the ``*_subsampled`` types start with a box."""
    if filter_type == "atrous":
        return [
            (dy, dx, float(_ATROUS_W[abs(dy)] * _ATROUS_W[abs(dx)]))
            for dy in range(-2, 3)
            for dx in range(-2, 3)
        ]
    if filter_type == "box3":
        return [(dy, dx, 1.0) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    if filter_type == "box5":
        return [(dy, dx, 1.0) for dy in range(-2, 3) for dx in range(-2, 3)]
    if filter_type == "subsampled":
        taps = [
            (0, 0, 1.0),
            (-1, 1, 1.0), (1, 1, 1.0), (-1, -1, 1.0), (1, -1, 1.0),
        ]
        if it % 2 == 0:
            taps += [(0, -2, 1.0), (0, 2, 1.0)]
        else:
            taps += [(-2, 0, 1.0), (2, 0, 1.0)]
        return taps
    if filter_type == "box3_subsampled":
        return _filter_taps("box3" if it == 0 else "subsampled", it)
    if filter_type == "box5_subsampled":
        return _filter_taps("box5" if it == 0 else "subsampled", it)
    raise ValueError(f"unknown filter_type {filter_type!r}")


def atrous_filter(color, variance, gbuf: GBuffer, cfg: DenoiseConfig):
    """Edge-aware a-trous iterations -> (filtered colour, the output of
    iteration ``cfg.history_tap - 1`` or None). Only foreground pixels are
    filtered: background depth (inf) is held at a finite 3.0e37 sentinel
    so no inf - inf reaches a weight, and background pixels keep their
    input colour. Colour stays demodulated if ``cfg.demodulate_albedo``."""
    normal = gbuf.normal
    foreground = torch.isfinite(gbuf.depth)
    depth = torch.where(foreground, gbuf.depth, 3.0e37)
    input_color = color
    dzdx = torch.abs(_shift(depth, 0, 1) - depth)
    dzdy = torch.abs(_shift(depth, 1, 0) - depth)
    dz = torch.maximum(dzdx, dzdy) + 1e-4
    fg3 = foreground[..., None]

    tap_color = None
    for it in range(cfg.atrous_iterations):
        step = 1 << it
        # 3x3-gaussian-prefiltered variance for the luminance sigma
        gvar = torch.zeros_like(variance)
        gw = 0.0
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                k = [1.0, 2.0, 1.0][dy + 1] * [1.0, 2.0, 1.0][dx + 1]
                gvar = gvar + k * _shift(variance, dy, dx)
                gw += k
        sigma_l = cfg.sigma_luminance * torch.sqrt(gvar / gw) + 1e-6
        lum_c = smath.luminance(color)
        # colour | variance | normal | depth | colour luminance
        pack = torch.cat([color, variance[..., None], normal, depth[..., None],
                          lum_c[..., None]], dim=-1)

        acc = torch.zeros_like(color)
        acc_v = torch.zeros_like(variance)
        wsum = torch.zeros_like(variance)
        for dy, dx, kw in _filter_taps(cfg.filter_type, it):
            nb = _shift(pack, dy * step, dx * step)
            c_n, v_n, n_n, z_n, l_n = (nb[..., 0:3], nb[..., 3], nb[..., 4:7], nb[..., 7],
                                       nb[..., 8])
            w_l = torch.exp(-torch.abs(l_n - lum_c) / sigma_l)
            w_n = torch.clamp(smath.dot(n_n, normal), min=0.0) ** cfg.sigma_normal
            w_z = torch.exp(
                -torch.abs(z_n - depth)
                / (cfg.sigma_depth * dz * (abs(dy) + abs(dx) + 1e-3) * step + 1e-6)
            )
            wgt = kw * w_l * w_n * w_z
            acc = acc + c_n * wgt[..., None]
            acc_v = acc_v + v_n * wgt * wgt
            wsum = wsum + wgt
        color = acc / torch.clamp(wsum, min=1e-6)[..., None]
        color = torch.where(fg3, color, input_color)
        variance = acc_v / torch.clamp(wsum * wsum, min=1e-6)
        if it + 1 == cfg.history_tap:
            tap_color = color
    return color, tap_color


def denoise(state: DenoiseState, radiance, gbuf: GBuffer, cfg: DenoiseConfig | None = None):
    """One SVGF pass -> (new state, denoised radiance); with
    ``cfg.debug_mode`` other than "none" the second output is that debug
    view (viridis of the history length, the variance or the reprojection
    weight sum) instead."""
    cfg = cfg or DenoiseConfig()
    new_state, color, variance, aux = temporal_accumulate(state, radiance, gbuf, cfg,
                                                          with_aux=True)
    filtered, tap_color = atrous_filter(color, variance, gbuf, cfg)
    if tap_color is not None:
        # the next frame's history starts from the partly filtered colour;
        # the moments and the history count stay
        new_state = new_state._replace(color=tap_color)
    if cfg.demodulate_albedo:
        filtered = filtered * torch.clamp(gbuf.albedo, min=1e-3)
    if cfg.debug_mode != "none":
        if cfg.debug_mode == "sample_count":
            dbg = smath.viridis(torch.clamp(aux["history"] / max(cfg.history_limit, 1.0), 0, 1))
        elif cfg.debug_mode == "variance":
            dbg = smath.viridis(torch.clamp(variance, 0.0, 1.0))
        elif cfg.debug_mode == "weight_sum":
            dbg = smath.viridis(torch.clamp(aux["weight_sum"], 0.0, 1.0))
        else:
            raise ValueError(f"unknown debug_mode {cfg.debug_mode!r}")
        return new_state, dbg
    return new_state, filtered
