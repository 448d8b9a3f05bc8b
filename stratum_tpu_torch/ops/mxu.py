"""Plucker features of triangles and rays (counterpart of
stratum_tpu/ops/mxu.py:46-82). With ray features R = [d, o x d, o, 1] and a
per-triangle [10, 4] block, the four Moller-Trumbore quantities
(a, u_num, v_num, t_num) of a ray against a triangle are R @ block. The
dense MXU tracer itself waits for the Cornell path (ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from stratum_tpu_torch.core import math as smath


def build_tri_features(positions, indices, valid_mask=None) -> np.ndarray:
    """[T, 10, 4] f32 feature blocks (host numpy); invalid rows are zero."""
    pos = np.asarray(positions, np.float32)
    idx = np.asarray(indices)
    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    n = np.cross(e1, e2)
    z = np.zeros_like(n)
    feat = np.stack(
        [
            np.stack([-n, np.cross(p0, e2), -np.cross(p0, e1), z], axis=-1),
            np.stack([z, e2, -e1, z], axis=-1),
            np.stack([z, z, z, n], axis=-1),
        ],
        axis=1,
    ).reshape(-1, 9, 4)
    zeros = np.zeros_like(p0[:, 0])
    const_row = np.stack(
        [zeros, zeros, zeros, -np.sum(p0 * n, axis=-1)], axis=-1
    )[:, None, :]
    feat = np.concatenate([feat, const_row], axis=1).astype(np.float32)
    if valid_mask is not None:
        feat = np.where(np.asarray(valid_mask)[:, None, None], feat, 0.0)
    return feat.astype(np.float32)


def ray_features(origin, direction):
    """[N, 10] ray features [d, o x d, o, 1]."""
    m = smath.cross(origin, direction)
    return torch.cat([direction, m, origin, torch.ones_like(origin[..., :1])], dim=-1)
