"""Hit records, the brute-force tracers and the self-intersection-robust
ray offset (counterpart of stratum_tpu/ops/intersect.py:31-185).

``intersect_brute_force`` / ``occluded_brute_force`` test every triangle
and are the exact oracle (``tracer="brute"``). Beside the reference's
triangle chunks they also walk the rays in chunks of ``RAY_CHUNK``: a ray's
result does not depend on the rays beside it, and a 1080p wave against a
few hundred triangles would otherwise hold tens of GB of [rays, chunk]
temporaries.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stratum_tpu_torch.core import math as smath

T_MIN = 0.0
T_MAX = float(np.float32(3.4e38))
_SHADOW_EPS = float(np.float32(1.0 - 1e-3))
RAY_CHUNK = 131072  # rays per pass of the brute-force and dense tracers


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


def ray_chunked(fn, origin, direction, extra, ray_chunk: int = RAY_CHUNK):
    """``fn(o, d, *extra)`` on blocks of at most ``ray_chunk`` rays, the
    results (a tensor or a NamedTuple of tensors) joined along the rays."""
    n = origin.shape[0]
    if n <= ray_chunk:
        return fn(origin, direction, *extra)
    parts = [
        fn(origin[s:s + ray_chunk], direction[s:s + ray_chunk],
           *(e[s:s + ray_chunk] for e in extra))
        for s in range(0, n, ray_chunk)
    ]
    if isinstance(parts[0], tuple):
        return type(parts[0])(*(None if x[0] is None else torch.cat(x) for x in zip(*parts)))
    return torch.cat(parts)


def _tri_corners(positions, indices):
    p0 = positions[indices[:, 0]]
    e1 = positions[indices[:, 1]] - p0
    e2 = positions[indices[:, 2]] - p0
    return p0, e1, e2


def moller_trumbore(origin, direction, p0, e1, e2, t_min=T_MIN, t_max=None):
    """Batched Moller-Trumbore: rays [..., 3] against triangles [K, 3]
    broadcast to [..., K]. Returns (t, u, v, valid)."""
    if t_max is None:
        t_max = T_MAX
    o = origin[..., None, :]
    d = direction[..., None, :]
    h = smath.cross(d, e2)
    a = smath.dot(e1, h)
    inv_a = torch.where(torch.abs(a) > 1e-12, 1.0 / torch.where(a != 0, a, 1.0), 0.0)
    s = o - p0
    u = smath.dot(s, h) * inv_a
    q = smath.cross(s, e1)
    v = smath.dot(d, q) * inv_a
    t = smath.dot(e2, q) * inv_a
    valid = (
        (torch.abs(a) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > t_min) & (t < t_max)
    )
    return t, u, v, valid


def _chunks(positions, indices, chunk):
    """Triangle corners in chunks of ``chunk`` with their ids; the padded
    rows reuse triangle 0 and are masked by id >= T."""
    num_tris = indices.shape[0]
    chunk = min(chunk, num_tris)
    num_chunks = -(-num_tris // chunk)
    idx_p = torch.nn.functional.pad(indices, (0, 0, 0, num_chunks * chunk - num_tris))
    p0, e1, e2 = _tri_corners(positions, idx_p.long())
    ids = torch.arange(num_chunks * chunk, dtype=torch.int32, device=indices.device)
    return [(p0[s:s + chunk], e1[s:s + chunk], e2[s:s + chunk], ids[s:s + chunk])
            for s in range(0, num_chunks * chunk, chunk)], num_tris


def intersect_brute_force(origin, direction, positions, indices, t_min=1e-4,
                          t_max=None, chunk=512) -> HitRecord:
    """Closest hit by testing every triangle, chunked to bound memory; the
    first index wins a tie inside a chunk, a later chunk only when strictly
    closer."""
    if t_max is None:
        t_max = torch.full(origin.shape[:-1], T_MAX, dtype=torch.float32,
                           device=origin.device)
    chunks, num_tris = _chunks(positions, indices, chunk)

    def run(o, d, tm):
        best_t = torch.full(o.shape[:-1], T_MAX, dtype=torch.float32, device=o.device)
        best_tri = torch.full(o.shape[:-1], -1, dtype=torch.int32, device=o.device)
        best_uv = torch.zeros(o.shape[:-1] + (2,), dtype=torch.float32, device=o.device)
        for cp0, ce1, ce2, cids in chunks:
            t, u, v, valid = moller_trumbore(o, d, cp0, ce1, ce2, t_min, tm[..., None])
            valid &= cids < num_tris
            t = torch.where(valid, t, T_MAX)
            tk, k = torch.min(t, dim=-1)
            closer = tk < best_t
            best_t = torch.where(closer, tk, best_t)
            best_tri = torch.where(closer, cids[k], best_tri)
            uk = torch.gather(u, -1, k[..., None])[..., 0]
            vk = torch.gather(v, -1, k[..., None])[..., 0]
            best_uv = torch.where(closer[..., None], torch.stack([uk, vk], dim=-1), best_uv)
        return HitRecord(t=best_t, tri=best_tri, bary=best_uv)

    return ray_chunked(run, origin, direction, (t_max,))


def occluded_brute_force(origin, direction, t_max, positions, indices,
                         t_min=1e-4, chunk=512):
    """Any-hit query: True where the segment [t_min, t_max * (1 - 1e-3)] is
    blocked."""
    chunks, num_tris = _chunks(positions, indices, chunk)

    def run(o, d, tm):
        limit = tm * _SHADOW_EPS
        blocked = torch.zeros(o.shape[:-1], dtype=torch.bool, device=o.device)
        for cp0, ce1, ce2, cids in chunks:
            _, _, _, valid = moller_trumbore(o, d, cp0, ce1, ce2, t_min, limit[..., None])
            blocked |= (valid & (cids < num_tris)).any(dim=-1)
        return blocked

    return ray_chunked(run, origin, direction, (t_max,))


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
