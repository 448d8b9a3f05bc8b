"""Quaternions as [..., 4] tensors (x, y, z, w) (counterpart of
stratum_tpu/core/quaternion.py)."""

from __future__ import annotations

import torch

from stratum_tpu_torch.core import math as smath


def identity(dtype=torch.float32, device=None):
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def from_angle_axis(angle, axis):
    axis = smath.normalize(torch.as_tensor(axis, dtype=torch.float32))
    half = torch.as_tensor(angle, dtype=torch.float32, device=axis.device) * 0.5
    return torch.cat([axis * torch.sin(half)[..., None], torch.cos(half)[..., None]], dim=-1)


def mul(a, b):
    """Hamilton product a*b."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def conjugate(q):
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype, device=q.device)


def rotate_vector(q, v):
    """Rotate vector v by unit quaternion q (q v q*)."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * smath.cross(u, v)
    return v + w * t + smath.cross(u, t)


def to_matrix(q):
    """Unit quaternion -> 3x3 rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )
