"""Trace-local wavefront sorting (counterpart of stratum_tpu/ops/raysort.py):
rays enter the closest tracer in (direction bucket, origin morton) order and
the hit record scatters back to the caller's lane order. Dead lanes
(t_max <= 0) sort to the tail, where whole ray blocks produce no candidates.
Keys are the reference's uint32 words, held as int64, bit for bit.
"""

from __future__ import annotations

import torch

from stratum_tpu_torch.ops.bvh import morton3
from stratum_tpu_torch.ops.intersect import HitRecord, T_MAX
from stratum_tpu_torch.utils import profiler as sprof

DIR_BITS = 5


def ray_key(origin, direction, t_max, lo, hi, dir_bits: int = DIR_BITS):
    """uint32 coherence key (int64-held); dead lanes get the max key."""
    q = (origin - lo) / torch.clamp(hi - lo, min=1e-9)
    dx, dy, dz = direction.unbind(-1)
    octant = (dx > 0).to(torch.int64) | ((dy > 0).to(torch.int64) << 1) | (
        (dz > 0).to(torch.int64) << 2
    )
    extra = max(dir_bits - 3, 0)
    if extra > 0:
        half = extra // 2
        ax = torch.abs(direction)
        dom = torch.argmax(ax, dim=-1)
        denom = torch.clamp(torch.amax(ax, dim=-1), min=1e-9)
        u1 = torch.where(dom == 0, dy, torch.where(dom == 1, dz, dx)) / denom
        v1 = torch.where(dom == 0, dz, torch.where(dom == 1, dx, dy)) / denom

        def qb(x, b):
            return torch.clamp(
                ((x * 0.5 + 0.5) * (1 << b)).to(torch.int64), 0, (1 << b) - 1
            )

        dbits = (octant << extra) | (qb(u1, extra - half) << half) | qb(v1, half)
    else:
        dbits = octant
    key = (dbits << (32 - dir_bits)) | (morton3(q) >> dir_bits)
    return torch.where(t_max > 0, key, 0xFFFFFFFF)


def sorted_closest(closest, lo, hi, dir_bits: int = DIR_BITS):
    """Wrap a closest tracer with trace-local sorting: one packed row
    gather in; out, (t, slot) of a slot-mode tracer, else (t, tri, bary).
    Only the closest tracer is wrapped; occlusion waves stay unsorted (the
    10M-row sort costs more than it buys there)."""

    def closest_sorted(o, d, tm=None):
        span = sprof.begin("sort")
        if tm is None:
            tm = torch.full(o.shape[:1], T_MAX, dtype=torch.float32, device=o.device)
        key = ray_key(o, d, tm, lo, hi, dir_bits)
        order = torch.argsort(key, stable=True)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=order.device)
        packed = torch.cat([o, d, tm[:, None]], dim=-1)[order]
        h = closest(packed[:, 0:3], packed[:, 3:6], packed[:, 6].contiguous())
        if h.slot is None:  # a tracer whose hits carry triangle ids
            out = HitRecord(t=h.t[inv], tri=h.tri[inv], bary=h.bary[inv])
        else:
            slot = h.slot[inv]
            out = HitRecord(
                t=h.t[inv], tri=torch.where(slot >= 0, 0, -1).to(torch.int32),
                bary=torch.zeros_like(o[:, :2]), slot=slot,
            )
        sprof.end(span)
        return out

    return closest_sorted
