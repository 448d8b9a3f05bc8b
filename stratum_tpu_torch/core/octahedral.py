"""Octahedral unit-vector packing (counterpart of
stratum_tpu/core/octahedral.py): a direction as two snorm16 lanes of one
32-bit word.

Torch has no uint32 arithmetic, so a packed word is held as int64 in
[0, 2^32) (as ``ops/hashgrid.py`` holds its keys); ``unpack_unit`` takes
any integer tensor and reads its low 32 bits.
"""

from __future__ import annotations

import torch


def _oct_wrap(v):
    return (1.0 - torch.abs(v.flip(-1))) * torch.where(v >= 0.0, 1.0, -1.0)


def encode_oct(n):
    """Unit vector [..., 3] -> octahedral coords [..., 2] in [-1, 1]."""
    n = n / torch.sum(torch.abs(n), dim=-1, keepdim=True)
    xy = n[..., :2]
    return torch.where(n[..., 2:3] >= 0.0, xy, _oct_wrap(xy))


def decode_oct(f):
    """Octahedral coords [..., 2] -> unit vector [..., 3]."""
    z = 1.0 - torch.abs(f[..., 0]) - torch.abs(f[..., 1])
    t = torch.clamp(-z, min=0.0)[..., None]
    xy = f + torch.where(f >= 0.0, -t, t)
    v = torch.cat([xy, z[..., None]], dim=-1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def pack_unit(n):
    """Unit vector [..., 3] -> the packed word (int64 in [0, 2^32))."""
    q = torch.round(torch.clamp(encode_oct(n), -1.0, 1.0) * 32767.0).to(torch.int64)
    u = q & 0xFFFF
    return u[..., 0] | (u[..., 1] << 16)


def unpack_unit(p):
    """Packed word -> unit vector [..., 3]."""
    p = p.to(torch.int64) & 0xFFFFFFFF
    lo = p & 0xFFFF
    hi = (p >> 16) & 0xFFFF
    lo = torch.where(lo >= 32768, lo - 65536, lo)
    hi = torch.where(hi >= 32768, hi - 65536, hi)
    return decode_oct(torch.stack([lo, hi], dim=-1).to(torch.float32) / 32767.0)
