"""Image error metrics: MSE / RMSE / SMAPE / average / relative MSE
(counterpart of stratum_tpu/utils/compare.py; the reference's
ImageComparer and image_compare kernel, src/Node/ImageComparer.cpp:50-89,
src/Shaders/kernels/image_compare.hlsl:14-48). Each is a torch reduction in
float32 on the inputs' device (numpy arrays and lists go to the CPU); the
result is a 0-d tensor.
"""

from __future__ import annotations

import torch


def _f32(x, device=None):
    if torch.is_tensor(x):
        return x.to(device=device or x.device, dtype=torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _pair(a, b):
    a = _f32(a)
    return a, _f32(b, a.device)


def mse(a, b):
    a, b = _pair(a, b)
    d = a - b
    return torch.mean(d * d)


def rmse(a, b):
    return torch.sqrt(mse(a, b))


def smape(a, b, eps: float = 1e-2):
    """Symmetric mean absolute percentage error per the reference kernel:
    |a-b| / (|a| + |b| + eps), averaged (image_compare.hlsl:23-33)."""
    a, b = _pair(a, b)
    return torch.mean(torch.abs(a - b) / (torch.abs(a) + torch.abs(b) + eps))


def average(a):
    return torch.mean(_f32(a))


def relative_mse(a, ref, eps: float = 1e-2):
    """MSE normalized by reference luminance^2, the usual progressive-
    rendering convergence metric."""
    a, ref = _pair(a, ref)
    d = a - ref
    return torch.mean(d * d / (ref * ref + eps))
