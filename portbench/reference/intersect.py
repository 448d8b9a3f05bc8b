"""Closest and any hits over the raw triangles, in plain torch.

Moller-Trumbore against every triangle of every chunk of 256 consecutive
triangles whose box a ray enters. The boxes are the chunks' own min / max,
widened by a margin, so the cull never drops a triangle a ray hits: the
answers are those of testing every triangle. A hit counts for
1e-4 < t < t_max; an occlusion segment ends at t_max * (1 - 1e-3), the
program's stated contract for shadow rays. ``dtype`` is the precision of
the triangle test (the control runs it in bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 256
T_MIN = 1e-4
SHADOW_EPS = float(np.float32(1.0 - 1e-3))  # the f32 factor the contract states
T_MAX = float(np.float32(3.4e38))  # an unbounded ray
RAY_BATCH = 512  # rays whose chunk boxes are tested at once
PAIR_BATCH = 2048  # (ray, chunk) pairs tested at once


class Triangles:
    """World triangles [T, 3, 3] f32 on a device, with chunk boxes."""

    def __init__(self, tri: torch.Tensor):
        self.count = tri.shape[0]
        pad = (-self.count) % CHUNK
        v = torch.cat([tri, tri[-1:].expand(pad, 3, 3)]) if pad else tri
        self.v0 = v[:, 0].contiguous()
        self.e1 = (v[:, 1] - v[:, 0]).contiguous()
        self.e2 = (v[:, 2] - v[:, 0]).contiguous()
        ch = v.view(-1, CHUNK * 3, 3)
        lo, hi = ch.amin(dim=1), ch.amax(dim=1)
        margin = 1e-5 * (hi - lo).abs().amax() + 1e-6
        self.lo, self.hi = lo - margin, hi + margin
        self.chunks = lo.shape[0]


def _enter(tris: Triangles, o, d, t_max):
    """[R, C] bool: the ray's segment [0, t_max] meets the chunk's box."""
    inv = 1.0 / torch.where(d == 0, torch.full_like(d, 1e-30), d)
    t0 = (tris.lo[None] - o[:, None]) * inv[:, None]
    t1 = (tris.hi[None] - o[:, None]) * inv[:, None]
    tn = torch.minimum(t0, t1).amax(dim=-1).clamp(min=0.0)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    return (tn <= tf) & (tn <= t_max[:, None])


def _mt(v0, e1, e2, o, d, dtype):
    """Moller-Trumbore of rays [P, 3] against triangles [P, K, 3] -> (t, u,
    v) [P, K] f32, t = inf where the ray misses the triangle."""
    v0, e1, e2 = v0.to(dtype), e1.to(dtype), e2.to(dtype)
    o, d = o.to(dtype)[:, None], d.to(dtype)[:, None]
    p = torch.linalg.cross(d.expand_as(e2), e2)
    det = (e1 * p).sum(-1)
    ok = det.abs() > 1e-30
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), 0.0)
    s = o - v0
    u = (s * p).sum(-1) * inv
    q = torch.linalg.cross(s, e1)
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > T_MIN)
    t = torch.where(hit, t, torch.full_like(t, float("inf")))
    return t.float(), u.float(), v.float()


def _pairs(tris: Triangles, o, d, t_max):
    """Every (ray, chunk) pair whose box the ray enters -> (ray, chunk)."""
    rays, chunks = [], []
    for s in range(0, o.shape[0], RAY_BATCH):
        r, c = torch.nonzero(_enter(tris, o[s:s + RAY_BATCH], d[s:s + RAY_BATCH],
                                    t_max[s:s + RAY_BATCH]), as_tuple=True)
        rays.append(r + s)
        chunks.append(c)
    return torch.cat(rays), torch.cat(chunks)


def closest(tris: Triangles, o, d, t_max, dtype=torch.float32):
    """(t [R], triangle [R], u [R], v [R]): the nearest hit below t_max,
    the lowest triangle index on equal t; t = inf and triangle -1 on a
    miss."""
    n = o.shape[0]
    dev = o.device
    ray, chunk = _pairs(tris, o, d, t_max)
    lane = torch.arange(CHUNK, device=dev)
    parts = []  # per pair: nearest t, its triangle, u, v
    for s in range(0, ray.shape[0], PAIR_BATCH):
        r, c = ray[s:s + PAIR_BATCH], chunk[s:s + PAIR_BATCH]
        k = c[:, None] * CHUNK + lane[None]
        t, u, v = _mt(tris.v0[k], tris.e1[k], tris.e2[k], o[r], d[r], dtype)
        t = torch.where((k < tris.count) & (t < t_max[r, None]), t, float("inf"))
        tk, j = t.min(dim=1)  # the first (lowest index) of equal minima
        j = j[:, None]
        parts.append((tk, k.gather(1, j)[:, 0], u.gather(1, j)[:, 0], v.gather(1, j)[:, 0]))
    inf = torch.full((n,), float("inf"), device=dev)
    if not parts:
        return inf, torch.full((n,), -1, dtype=torch.int64, device=dev), inf * 0, inf * 0
    tk, kk, uk, vk = (torch.cat(x) for x in zip(*parts))
    best_t = inf.scatter_reduce(0, ray, tk, reduce="amin")
    big = torch.iinfo(torch.int64).max
    take = (tk == best_t[ray]) & torch.isfinite(tk)
    best_k = torch.full((n,), big, dtype=torch.int64, device=dev).scatter_reduce(
        0, ray, torch.where(take, kk, big), reduce="amin")
    sel = take & (kk == best_k[ray])
    best_u = torch.zeros((n,), device=dev)
    best_v = torch.zeros((n,), device=dev)
    best_u[ray[sel]] = uk[sel]
    best_v[ray[sel]] = vk[sel]
    best_k = torch.where(torch.isfinite(best_t), best_k, -1)
    return best_t, best_k, best_u, best_v


def occluded(tris: Triangles, o, d, t_max, dtype=torch.float32):
    """bool [R]: some triangle is hit with 1e-4 < t < t_max * (1 - 1e-3)."""
    n = o.shape[0]
    dev = o.device
    limit = t_max * SHADOW_EPS
    blocked = torch.zeros((n,), dtype=torch.bool, device=dev)
    ray, chunk = _pairs(tris, o, d, limit)
    lane = torch.arange(CHUNK, device=dev)
    for s in range(0, ray.shape[0], PAIR_BATCH):
        r, c = ray[s:s + PAIR_BATCH], chunk[s:s + PAIR_BATCH]
        k = c[:, None] * CHUNK + lane[None]
        t, _, _ = _mt(tris.v0[k], tris.e1[k], tris.e2[k], o[r], d[r], dtype)
        hit = ((k < tris.count) & (t < limit[r, None])).any(dim=1)
        blocked[r[hit]] = True
    return blocked & (limit > 0)
