"""Plucker features and the dense tracer (counterpart of
stratum_tpu/ops/mxu.py:46-232). With ray features R = [d, o x d, o, 1] and
a per-triangle [10, 4] block, the four Moller-Trumbore quantities
(a, u_num, v_num, t_num) of a ray against a triangle are R @ block.

``intersect_mxu`` / ``occluded_mxu`` test every triangle of a small scene
(``tracer="mxu"``, what ``auto`` picks at <= 16,384 triangles): per chunk of
``chunk`` triangles one [rays, 10] x [10, 4 * chunk] f32 product, then
validity, a per-ray argmin and the strict-``<`` merge across chunks as
torch glue. The reference computes the product in XLA outside any Pallas
kernel (``Precision.HIGHEST``), so here it is ``torch.matmul`` in full f32:
:func:`full_f32` turns TF32 off around it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.ops.intersect import RAY_CHUNK, T_MAX, HitRecord, ray_chunked

_EPS_A = 1e-12


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


@contextlib.contextmanager
def full_f32():
    """CUDA f32 matrix products in full f32 (no TF32) inside the block,
    through ``torch.backends.cuda.matmul.fp32_precision`` where this torch
    has it (reading the legacy flags after it is set raises), else the
    legacy ``allow_tf32``."""
    m = torch.backends.cuda.matmul
    name, off = (("fp32_precision", "ieee") if hasattr(m, "fp32_precision")
                 else ("allow_tf32", False))
    before = getattr(m, name)
    setattr(m, name, off)
    try:
        yield
    finally:
        setattr(m, name, before)


def _chunk_quants(rays, feat_chunk):
    """rays [N, 10] x feat [C, 10, 4] -> (a, u, v, t) each [N, C]."""
    c = feat_chunk.shape[0]
    with full_f32():
        out = torch.matmul(rays, feat_chunk.permute(1, 0, 2).reshape(10, c * 4))
    out = out.view(rays.shape[0], c, 4)
    a = out[..., 0]
    inv_a = torch.where(torch.abs(a) > _EPS_A, 1.0 / torch.where(a != 0, a, 1.0), 0.0)
    return a, out[..., 1] * inv_a, out[..., 2] * inv_a, out[..., 3] * inv_a


def _feature_chunks(tri_features, chunk):
    num_tris = tri_features.shape[0]
    chunk = min(chunk, num_tris)
    num_chunks = -(-num_tris // chunk)
    feat = torch.nn.functional.pad(tri_features, (0, 0, 0, 0, 0, num_chunks * chunk - num_tris))
    return feat.view(num_chunks, chunk, 10, 4), chunk


def _valid(a, u, v, t, t_min, limit):
    return ((torch.abs(a) > _EPS_A) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > t_min) & (t < limit[..., None]))


def intersect_mxu(origin, direction, tri_features, t_min=1e-4, t_max=None,
                  chunk=1024, ray_chunk=RAY_CHUNK) -> HitRecord:
    """Closest hit against all triangles by chunked Plucker products. Ties:
    the first triangle of a chunk wins (argmin), a later chunk only when
    strictly closer."""
    if t_max is None:
        t_max = torch.full(origin.shape[:-1], T_MAX, dtype=torch.float32,
                           device=origin.device)
    feat, chunk = _feature_chunks(tri_features, chunk)

    def run(o, d, tm):
        rays = ray_features(o, d)
        best_t = torch.full(o.shape[:-1], T_MAX, dtype=torch.float32, device=o.device)
        best_tri = torch.full(o.shape[:-1], -1, dtype=torch.int32, device=o.device)
        best_uv = torch.zeros(o.shape[:-1] + (2,), dtype=torch.float32, device=o.device)
        for c in range(feat.shape[0]):
            a, u, v, t = _chunk_quants(rays, feat[c])
            t = torch.where(_valid(a, u, v, t, t_min, tm), t, T_MAX)
            k = torch.argmin(t, dim=-1, keepdim=True)
            tk = torch.gather(t, -1, k)[..., 0]
            closer = tk < best_t
            best_t = torch.where(closer, tk, best_t)
            best_tri = torch.where(closer, c * chunk + k[..., 0].to(torch.int32), best_tri)
            uv = torch.cat([torch.gather(u, -1, k), torch.gather(v, -1, k)], dim=-1)
            best_uv = torch.where(closer[..., None], uv, best_uv)
        return HitRecord(t=best_t, tri=best_tri, bary=best_uv)

    return ray_chunked(run, origin, direction, (t_max,), ray_chunk)


def occluded_mxu(origin, direction, t_max, tri_features, t_min=1e-4, chunk=1024,
                 ray_chunk=RAY_CHUNK):
    """Any-hit shadow query by the same products: True where a triangle is
    hit before t_max * (1 - 1e-3)."""
    feat, _ = _feature_chunks(tri_features, chunk)

    def run(o, d, tm):
        rays = ray_features(o, d)
        limit = tm * float(np.float32(1.0 - 1e-3))
        blocked = torch.zeros(o.shape[:-1], dtype=torch.bool, device=o.device)
        for c in range(feat.shape[0]):
            blocked |= _valid(*_chunk_quants(rays, feat[c]), t_min, limit).any(dim=-1)
        return blocked

    return ray_chunked(run, origin, direction, (t_max,), ray_chunk)
