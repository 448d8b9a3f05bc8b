"""Keyframe splines for animation (counterpart of
stratum_tpu/core/spline.py): cubic Hermite evaluation with constant
extrapolation, on tensors."""

from __future__ import annotations

from enum import IntEnum
from typing import NamedTuple

import torch


class ExtrapolateMode(IntEnum):
    CONSTANT = 0
    LINEAR = 1
    CYCLE = 2
    CYCLE_OFFSET = 3
    BOUNCE = 4


class TangentMode(IntEnum):
    MANUAL = 0
    FLAT = 1
    LINEAR = 2
    SMOOTH = 3
    STEP = 4


class Spline(NamedTuple):
    times: torch.Tensor  # [K]
    values: torch.Tensor  # [K, D]
    tangents_in: torch.Tensor  # [K, D]
    tangents_out: torch.Tensor  # [K, D]
    extrapolate: int = ExtrapolateMode.CONSTANT


def make_linear_spline(times, values, device=None) -> Spline:
    times = torch.as_tensor(times, dtype=torch.float32, device=device)
    values = torch.atleast_2d(torch.as_tensor(values, dtype=torch.float32, device=device))
    dt = torch.diff(times)
    dv = torch.diff(values, dim=0) / dt[:, None]
    tan = torch.cat([dv, dv[-1:]], dim=0)
    tan_in = torch.cat([dv[:1], dv], dim=0)
    return Spline(times, values, tan_in, tan, ExtrapolateMode.CONSTANT)


def evaluate(spline: Spline, t):
    """Cubic Hermite evaluation with constant extrapolation; ``t`` a
    scalar or [N] -> [D] or [N, D]."""
    times, values = spline.times, spline.values
    k = times.shape[0]
    t = torch.as_tensor(t, dtype=torch.float32, device=times.device)
    tc = torch.clamp(t, times[0], times[-1])
    idx = torch.clamp(torch.searchsorted(times, tc, right=True) - 1, 0, k - 2)
    t0, t1 = times[idx], times[idx + 1]
    dt = torch.clamp(t1 - t0, min=1e-12)
    u = ((tc - t0) / dt)[..., None]
    dt = dt[..., None]
    p0, p1 = values[idx], values[idx + 1]
    m0 = spline.tangents_out[idx] * dt
    m1 = spline.tangents_in[idx + 1] * dt
    u2 = u * u
    u3 = u2 * u
    h00 = 2 * u3 - 3 * u2 + 1
    h10 = u3 - 2 * u2 + u
    h01 = -2 * u3 + 3 * u2
    h11 = u3 - u2
    return h00 * p0 + h10 * m0 + h01 * p1 + h11 * m1
