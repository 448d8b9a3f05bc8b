"""Weighted reservoir sampling (counterpart of stratum_tpu/core/reservoir.py).

``update`` keeps a candidate with probability weight / total weight, and
the unbiased contribution weight is ``W = total / (M * p_hat)``. Batched
over lanes; ``sample`` is a dict of per-lane tensors. Merging two
reservoirs is an update with the other's weighted total.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stratum_tpu_torch.core import math as smath


class Reservoir(NamedTuple):
    """One reservoir per lane."""

    sample: dict  # {name: tensor [N, ...]}
    target_pdf: torch.Tensor  # [N] p_hat of the kept sample
    total_weight: torch.Tensor  # [N] sum of candidate weights
    m: torch.Tensor  # [N] number of candidates seen


def init_reservoir(sample_zero: dict, n: int) -> Reservoir:
    dev = next(iter(sample_zero.values())).device
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    return Reservoir(sample=sample_zero, target_pdf=zeros, total_weight=zeros, m=zeros)


def _select(keep, a: dict, b: dict) -> dict:
    return {k: torch.where(keep.view(keep.shape + (1,) * (a[k].dim() - 1)), a[k], b[k])
            for k in a}


def update(res: Reservoir, candidate: dict, target_pdf, weight, u) -> Reservoir:
    """Stream one candidate with resampling weight ``weight``; it is kept
    with probability weight / total."""
    total = res.total_weight + weight
    keep = (u * torch.clamp(total, min=1e-20)) < weight
    return Reservoir(
        sample=_select(keep, candidate, res.sample),
        target_pdf=torch.where(keep, target_pdf, res.target_pdf),
        total_weight=total,
        m=res.m + 1.0,
    )


def merge(res: Reservoir, other: Reservoir, u) -> Reservoir:
    """Merge ``other`` into ``res`` (temporal / spatial reuse)."""
    w_other = other.target_pdf * contribution_weight(other) * other.m
    total = res.total_weight + w_other
    keep = (u * torch.clamp(total, min=1e-20)) < w_other
    return Reservoir(
        sample=_select(keep, other.sample, res.sample),
        target_pdf=torch.where(keep, other.target_pdf, res.target_pdf),
        total_weight=total,
        m=res.m + other.m,
    )


def contribution_weight(res: Reservoir):
    """W = total / (M * p_hat)."""
    return smath.safe_div(res.total_weight, res.m * torch.clamp(res.target_pdf, min=1e-20))
