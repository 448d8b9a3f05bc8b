"""Animation ops: linear-blend skinning and blend shapes (counterpart of
stratum_tpu/ops/anim.py)."""

from __future__ import annotations

import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.core import transform as xform


def skin_vertices(positions, normals, bone_ids, bone_weights, bone_matrices):
    """4-bone linear-blend skinning: positions [V, 3], normals [V, 3],
    bone_ids [V, 4], bone_weights [V, 4] (rows sum to 1), bone_matrices
    [B, 3, 4] -> (positions', normals'). Normals go through the blended
    linear part (near-rigid bones assumed, as in the reference)."""
    mats = bone_matrices[bone_ids.long()]  # [V, 4, 3, 4]
    blended = torch.sum(mats * bone_weights[..., None, None], dim=1)  # [V, 3, 4]
    p = xform.transform_point(blended, positions)
    n = xform.transform_vector(blended, normals)
    return p, smath.normalize(n)


def blend_shapes(positions, normals, shape_deltas, shape_normal_deltas, weights):
    """Blend-shape morphing: base + sum_k w_k * delta_k; shape_deltas
    [K, V, 3], weights [K]."""
    p = positions + torch.einsum("k,kvc->vc", weights, shape_deltas)
    n = normals
    if shape_normal_deltas is not None:
        n = smath.normalize(normals + torch.einsum("k,kvc->vc", weights, shape_normal_deltas))
    return p, n
