"""Tone mapping operators and auto-exposure (counterpart of
stratum_tpu/render/tonemap.py): the operator set under the reference's
``TonemapMode`` names and string values, the frame max used for exposure
normalisation and the cross-frame exposure EMA.

``tonemap`` takes a tensor or a numpy array and returns a tensor on the
input's device (the CPU for an array).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.utils import profiler as sprof


class TonemapMode(enum.Enum):
    RAW = "raw"
    REINHARD = "reinhard"
    REINHARD_EXTENDED = "reinhard_extended"
    REINHARD_LUMINANCE = "reinhard_luminance"
    REINHARD_LUMINANCE_EXTENDED = "reinhard_luminance_extended"
    UNCHARTED2 = "uncharted2"
    FILMIC = "filmic"
    ACES = "aces"
    ACES_APPROX = "aces_approx"
    VIRIDIS_R = "viridis_r"
    VIRIDIS_LENGTH = "viridis_length"


def _reinhard(c):
    return c / (1.0 + c)


def _reinhard_extended(c, max_c):
    return c * (1.0 + c / torch.clamp(max_c * max_c, min=1e-8)) / (1.0 + c)


def _reinhard_luminance(c):
    return c / (1.0 + smath.luminance(c)[..., None])


def _reinhard_luminance_extended(c, max_l):
    lum = smath.luminance(c)[..., None]
    num = lum * (1.0 + lum / torch.clamp(max_l * max_l, min=1e-8))
    return c * smath.safe_div(num, lum * (1.0 + lum))


def _uncharted2_partial(c):
    a, b, cc, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((c * (a * c + cc * b) + d * e) / (c * (a * c + b) + d * f)) - e / f


def _uncharted2(c):
    exposure_bias = 2.0
    w = torch.tensor(11.2, dtype=torch.float32, device=c.device)
    return _uncharted2_partial(c * exposure_bias) / _uncharted2_partial(w)


def _filmic(c):
    # Hejl-Burgess-Dawson filmic curve; its baked 2.2 gamma is undone so
    # every operator returns linear values
    x = torch.clamp(c - 0.004, min=0.0)
    out = (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)
    return out ** 2.2


_ACES_IN = np.array(
    [
        [0.59719, 0.35458, 0.04823],
        [0.07600, 0.90834, 0.01566],
        [0.02840, 0.13383, 0.83777],
    ],
    np.float32,
)
_ACES_OUT = np.array(
    [
        [1.60475, -0.53108, -0.07367],
        [-0.10208, 1.10813, -0.00605],
        [-0.00327, -0.07276, 1.07602],
    ],
    np.float32,
)


def _mat3(m, c):
    """Row-major 3x3 ``m`` applied to colours c [..., 3], as three
    elementwise dot products (no batched matmul)."""
    m = torch.tensor(m, device=c.device)
    return torch.stack([torch.sum(c * m[i], dim=-1) for i in range(3)], dim=-1)


def _aces_fitted(c):
    v = _mat3(_ACES_IN, c)
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return torch.clamp(_mat3(_ACES_OUT, a / b), 0.0, 1.0)


def _aces_approx(c):
    v = c * 0.6
    a, b, cc, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((v * (a * v + b)) / (v * (cc * v + d) + e), 0.0, 1.0)


def _as_tensor(image):
    if torch.is_tensor(image):
        return image.to(torch.float32)
    return torch.as_tensor(np.asarray(image, np.float32))


def reduce_max_color(image):
    """(max rgb component, max luminance) over the image, as 0-d tensors."""
    c = _as_tensor(image)
    return torch.amax(c), torch.amax(smath.luminance(c))


def exposure_ema(prev_max, cur_max, alpha: float = 0.1):
    """Exponential moving average of the frame max (stable auto-exposure)."""
    return prev_max + (cur_max - prev_max) * alpha


def tonemap(image, mode: TonemapMode = TonemapMode.RAW, exposure: float = 0.0,
            max_value=None):
    """Exposure (in stops), then the operator. The LDR operators return
    linear values in [0, 1]; the display encoding (sRGB) is applied when
    the image is saved (io/image.py)."""
    span = sprof.enter("tonemap")
    out = _tonemap(image, mode, exposure, max_value)
    sprof.end(span)
    return out


def _tonemap(image, mode: TonemapMode, exposure: float, max_value):
    c = _as_tensor(image) * (2.0 ** exposure)
    if max_value is None:
        max_value = torch.clamp(torch.amax(c), min=1e-4)
    else:
        max_value = torch.as_tensor(max_value, dtype=torch.float32, device=c.device)
    if mode == TonemapMode.RAW:
        return c
    if mode == TonemapMode.REINHARD:
        return _reinhard(c)
    if mode == TonemapMode.REINHARD_EXTENDED:
        return _reinhard_extended(c, max_value)
    if mode == TonemapMode.REINHARD_LUMINANCE:
        return _reinhard_luminance(c)
    if mode == TonemapMode.REINHARD_LUMINANCE_EXTENDED:
        return _reinhard_luminance_extended(c, max_value)
    if mode == TonemapMode.UNCHARTED2:
        return _uncharted2(c)
    if mode == TonemapMode.FILMIC:
        return _filmic(c)
    if mode == TonemapMode.ACES:
        return _aces_fitted(c)
    if mode == TonemapMode.ACES_APPROX:
        return _aces_approx(c)
    if mode == TonemapMode.VIRIDIS_R:
        return smath.viridis(c[..., 0] / max_value)
    if mode == TonemapMode.VIRIDIS_LENGTH:
        return smath.viridis(smath.length(c) / max_value)
    raise ValueError(f"unknown tonemap mode {mode}")
