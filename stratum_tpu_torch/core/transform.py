"""Affine transforms and the perspective projection (counterpart of
stratum_tpu/core/transform.py, the part the camera path calls).
Transforms are row-major ``[..., 3, 4]`` affines; camera space looks down
+z; projections are reversed-z with an infinite far plane.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stratum_tpu_torch.core import math as smath


def _linear_apply(m, v):
    return (
        m[..., :, 0] * v[..., None, 0]
        + m[..., :, 1] * v[..., None, 1]
        + m[..., :, 2] * v[..., None, 2]
    )


def transform_vector(m, v):
    return _linear_apply(m[..., :3], v)


def transform_point(m, p):
    """Apply a [..., 3, 4] affine to points [..., 3]."""
    return _linear_apply(m[..., :3], p) + m[..., 3]


def inverse(m):
    """Inverse of a 3x4 affine through the 3x3 adjugate (transform.py:72-82)."""
    a = m[..., :3]
    c0 = smath.cross(a[..., 1], a[..., 2])
    c1 = smath.cross(a[..., 2], a[..., 0])
    c2 = smath.cross(a[..., 0], a[..., 1])
    det = smath.dot(a[..., 0], c0)[..., None, None]
    inv_lin = torch.stack([c0, c1, c2], dim=-2) / det
    inv_trans = -_linear_apply(inv_lin, m[..., 3])
    return torch.cat([inv_lin, inv_trans[..., None]], dim=-1)


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world [3, 4] (numpy f32): camera at eye looking toward
    target, +z forward. Host-side, for scene building."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)

    def nrm(v):
        return v / np.sqrt(np.maximum(np.sum(v * v), np.float32(1e-20)))

    fwd = nrm(target - eye)
    right = nrm(np.cross(up, fwd))
    true_up = np.cross(fwd, right)
    lin = np.stack([right, true_up, fwd], axis=-1)
    return np.concatenate([lin, eye[:, None]], axis=-1).astype(np.float32)


class ProjectionData(NamedTuple):
    scale: torch.Tensor  # [2]
    offset: torch.Tensor  # [2]
    near_plane: torch.Tensor  # scalar; sign encodes handedness
    far_plane: torch.Tensor  # scalar (orthographic only)
    sensor_area: torch.Tensor  # scalar
    vertical_fov: torch.Tensor  # scalar; < 0 means orthographic


def make_perspective(fovy, aspect, offset=(0.0, 0.0), znear=0.001,
                     device=None) -> ProjectionData:
    """Perspective projection; aspect = height/width."""
    sy = 1.0 / np.tan(float(fovy) / 2.0)
    sx = float(aspect) * sy
    sensor_area = 4.0 / max(sx * sy, 1e-12)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return ProjectionData(
        scale=f32([sx, sy]),
        offset=f32(list(offset)),
        near_plane=f32(znear),
        far_plane=f32(0.0),
        sensor_area=f32(sensor_area),
        vertical_fov=f32(fovy),
    )


def project_point(proj: ProjectionData, p):
    """Camera-space point -> clip coordinates [..., 4], reversed z with an
    infinite far plane (transform.py:193-219; perspective, as back_project)."""
    return torch.stack([
        p[..., 0] * proj.scale[0] + p[..., 2] * proj.offset[0],
        p[..., 1] * proj.scale[1] + p[..., 2] * proj.offset[1],
        torch.abs(proj.near_plane).expand(p[..., 0].shape),
        p[..., 2] * torch.sign(proj.near_plane),
    ], dim=-1)


def back_project(proj: ProjectionData, ndc_xy):
    """NDC [-1,1]^2 -> camera-space point on the near plane (perspective;
    orthographic projections are not on the port's path)."""
    sign_n = torch.sign(proj.near_plane)
    x = proj.near_plane * (ndc_xy[..., 0] * sign_n - proj.offset[0]) / proj.scale[0]
    y = proj.near_plane * (ndc_xy[..., 1] * sign_n - proj.offset[1]) / proj.scale[1]
    z = proj.near_plane.expand(x.shape)
    return torch.stack([x, y, z], dim=-1)
