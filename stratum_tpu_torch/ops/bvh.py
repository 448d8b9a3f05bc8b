"""Morton codes (counterpart of stratum_tpu/ops/bvh.py:62-79). The LBVH
tracer itself is not on the port's path (ROADMAP Queue 1)."""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _expand_bits(v):
    """Spread the low 10 bits of v (int64) over 30 bits."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3(xyz01):
    """[..., 3] coords in [0,1] -> 30-bit Morton codes as int64 (the uint32
    values of the reference, bit for bit)."""
    q = torch.clamp(xyz01 * 1024.0, 0.0, 1023.0).to(torch.int64)
    return (
        (_expand_bits(q[..., 0]) << 2)
        | (_expand_bits(q[..., 1]) << 1)
        | _expand_bits(q[..., 2])
    ) & _M32
