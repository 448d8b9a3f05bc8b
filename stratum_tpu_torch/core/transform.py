"""Affine transforms and the perspective projection (counterpart of
stratum_tpu/core/transform.py, the part the camera path calls).
Transforms are row-major ``[..., 3, 4]`` affines; camera space looks down
+z; projections are reversed-z with an infinite far plane.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _linear_apply(m, v):
    return (
        m[..., :, 0] * v[..., None, 0]
        + m[..., :, 1] * v[..., None, 1]
        + m[..., :, 2] * v[..., None, 2]
    )


def transform_vector(m, v):
    return _linear_apply(m[..., :3], v)


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


def back_project(proj: ProjectionData, ndc_xy):
    """NDC [-1,1]^2 -> camera-space point on the near plane (perspective;
    orthographic projections are not on the port's path)."""
    sign_n = torch.sign(proj.near_plane)
    x = proj.near_plane * (ndc_xy[..., 0] * sign_n - proj.offset[0]) / proj.scale[0]
    y = proj.near_plane * (ndc_xy[..., 1] * sign_n - proj.offset[1]) / proj.scale[1]
    z = proj.near_plane.expand(x.shape)
    return torch.stack([x, y, z], dim=-1)
