"""Hit records and the self-intersection-robust ray offset (counterpart of
stratum_tpu/ops/intersect.py:31-53, 170-185)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

T_MAX = float(np.float32(3.4e38))


class HitRecord(NamedTuple):
    """Closest-hit result per ray."""

    t: torch.Tensor  # f32 [N]; T_MAX on miss
    tri: torch.Tensor  # i32 [N]; -1 on miss
    bary: torch.Tensor  # f32 [N, 2]
    # fused hit payload [N, 88] (SceneData.slot_payload row of the winner)
    payload: torch.Tensor | None = None
    # slot-mode intermediate: the winning slot [N] i32 (-1 miss) with tri,
    # bary and payload not yet resolved (block_trace.finalize_hit does that)
    slot: torch.Tensor | None = None

    @property
    def hit(self):
        return self.tri >= 0


def ray_offset(position, geometric_normal):
    """Offset a point off a surface along +-normal before re-tracing
    (integer-lattice method)."""
    of_i = (geometric_normal * 256.0).to(torch.int32)
    p_i_bits = position.view(torch.int32)
    shifted = torch.where(position < 0.0, p_i_bits - of_i, p_i_bits + of_i)
    p_i = shifted.view(torch.float32)
    return torch.where(
        torch.abs(position) < 1.0 / 32.0,
        position + geometric_normal * (1.0 / 65536.0),
        p_i,
    )
