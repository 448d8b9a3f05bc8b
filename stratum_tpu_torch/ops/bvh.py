"""LBVH: a Morton-ordered binary BVH and its stackless traversal
(counterpart of stratum_tpu/ops/bvh.py; ``tracer="bvh"``).

Build (numpy): triangle centroids -> 30-bit Morton codes in the scene box;
a stable sort orders triangles along the Z-curve; an implicit complete
binary tree over leaves of ``LEAF_SIZE`` consecutive triangles, its boxes
reduced level by level. Nodes are stored in DFS preorder, so each node needs
one skip link (the index after its subtree) and traversal keeps one node
index per ray.

Traversal (torch): every ray holds one DFS index; a step tests the node's
box and descends (``i + 1``) or follows the skip link, and a leaf tests its
``LEAF_SIZE`` triangles with Moller-Trumbore. The reference steps every lane
of the wave in a ``while_loop``; here each step runs on the lanes still
walking (a lane's result does not depend on the others), and the host asks
after each step whether any is left.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stratum_tpu_torch.ops.intersect import SHADOW_EPS, T_MAX, HitRecord, moller_trumbore

_M32 = 0xFFFFFFFF
LEAF_SIZE = 4
_BIG = np.float32(3.0e37)


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


class BVHData(NamedTuple):
    """Flattened DFS-ordered BVH."""

    aabb_lo: torch.Tensor  # f32 [num_nodes, 3]
    aabb_hi: torch.Tensor  # f32 [num_nodes, 3]
    skip: torch.Tensor  # i32 [num_nodes] DFS index after this subtree
    leaf_first: torch.Tensor  # i32 [num_nodes] first slot in sorted_tris, -1 internal
    sorted_tris: torch.Tensor  # i32 [num_leaves * LEAF_SIZE] tri ids, -1 padding
    tri_p0: torch.Tensor  # f32 [num_leaves * LEAF_SIZE, 3] corners in sorted order
    tri_e1: torch.Tensor  # f32 [num_leaves * LEAF_SIZE, 3]
    tri_e2: torch.Tensor  # f32 [num_leaves * LEAF_SIZE, 3]

    @property
    def num_nodes(self) -> int:
        return self.skip.shape[0]


def _dfs_layout(depth: int):
    """DFS indices and skip links of the complete binary tree with 2^depth
    leaves: node (level l, position p) has preorder index
    ``l + sum_k bit_k(p) * (2^(depth-k+1) - 1)``.
    -> (per-level (dfs, skip) arrays, total nodes)."""
    levels = []
    total = 2 ** (depth + 1) - 1
    for lv in range(depth + 1):
        p = np.arange(2 ** lv, dtype=np.int64)
        dfs = np.full(2 ** lv, lv, np.int64)
        for k in range(1, lv + 1):
            dfs += ((p >> (lv - k)) & 1) * (2 ** (depth - k + 1) - 1)
        subtree = 2 ** (depth - lv + 1) - 1
        levels.append((dfs.astype(np.int32), (dfs + subtree).astype(np.int32)))
    return levels, total


def build_bvh(positions, indices, valid_mask=None) -> BVHData:
    """The LBVH over triangles (numpy in and out). ``valid_mask`` excludes
    padding triangles: they sort last and take -1 ids and empty boxes."""
    pos = np.asarray(positions, np.float32)
    idx = np.asarray(indices)
    num_tris = idx.shape[0]
    valid = np.ones(num_tris, bool) if valid_mask is None else np.asarray(valid_mask, bool)
    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    centroid = (p0 + p1 + p2) / np.float32(3.0)
    lo_pts = np.where(valid[:, None], np.minimum(np.minimum(p0, p1), p2), _BIG)
    hi_pts = np.where(valid[:, None], np.maximum(np.maximum(p0, p1), p2), -_BIG)
    scene_lo = lo_pts.min(axis=0)
    extent = np.maximum(hi_pts.max(axis=0) - scene_lo, np.float32(1e-9))
    with np.errstate(over="ignore"):  # no valid triangle: every code is replaced below
        codes = morton3(torch.from_numpy((centroid - scene_lo) / extent)).numpy()
    codes = np.where(valid, codes, _M32)
    order = np.argsort(codes, kind="stable").astype(np.int32)

    leaves_needed = max(1, (num_tris + LEAF_SIZE - 1) // LEAF_SIZE)
    num_leaves = max(1, 1 << int(np.ceil(np.log2(leaves_needed))))
    depth = int(np.log2(num_leaves))
    slots = num_leaves * LEAF_SIZE
    sorted_tris = np.full(slots, -1, np.int32)
    sorted_tris[:num_tris] = np.where(valid[order], order, -1)
    ok = (sorted_tris >= 0)[:, None]
    g = np.maximum(sorted_tris, 0)
    sp0 = np.where(ok, p0[g], _BIG)
    sp1 = np.where(ok, p1[g], _BIG)
    sp2 = np.where(ok, p2[g], _BIG)
    tri_p0 = np.where(ok, sp0, np.float32(0.0))
    tri_e1 = np.where(ok, sp1 - sp0, np.float32(0.0))
    tri_e2 = np.where(ok, sp2 - sp0, np.float32(0.0))
    slo = np.minimum(np.minimum(sp0, sp1), sp2).reshape(num_leaves, LEAF_SIZE, 3)
    shi = np.where(ok, np.maximum(np.maximum(sp0, sp1), sp2), -_BIG)
    level_lo = [slo.min(axis=1)]
    level_hi = [shi.reshape(num_leaves, LEAF_SIZE, 3).max(axis=1)]
    for _ in range(depth):
        level_lo.append(np.minimum(level_lo[-1][0::2], level_lo[-1][1::2]))
        level_hi.append(np.maximum(level_hi[-1][0::2], level_hi[-1][1::2]))
    level_lo.reverse()  # level_lo[l] is level l, the root first
    level_hi.reverse()

    levels, total = _dfs_layout(depth)
    aabb_lo = np.full((total, 3), _BIG, np.float32)
    aabb_hi = np.full((total, 3), -_BIG, np.float32)
    skip = np.zeros(total, np.int32)
    leaf_first = np.full(total, -1, np.int32)
    for lv, (dfs_idx, skip_idx) in enumerate(levels):
        aabb_lo[dfs_idx] = level_lo[lv]
        aabb_hi[dfs_idx] = level_hi[lv]
        skip[dfs_idx] = skip_idx
    leaf_first[levels[depth][0]] = np.arange(num_leaves, dtype=np.int32) * LEAF_SIZE
    return BVHData(
        aabb_lo=aabb_lo, aabb_hi=aabb_hi, skip=skip, leaf_first=leaf_first,
        sorted_tris=sorted_tris, tri_p0=tri_p0, tri_e1=tri_e1, tri_e2=tri_e2,
    )


def _safe_inv(d):
    s = torch.where(d >= 0.0, 1.0, -1.0)
    return s / torch.clamp(torch.abs(d), min=1e-20)


def _leaf_hit(bvh: BVHData, first, origin, direction, t_min, t_best):
    """The closest of the LEAF_SIZE triangles from slot ``first`` per ray
    -> (t, tri id, bary); the lowest slot wins a tie."""
    slots = first[:, None] + torch.arange(LEAF_SIZE, device=first.device)
    tids = bvh.sorted_tris[slots]
    t, u, v, valid = moller_trumbore(origin, direction, bvh.tri_p0[slots],
                                     bvh.tri_e1[slots], bvh.tri_e2[slots],
                                     t_min, t_best[:, None])
    t = torch.where(valid & (tids >= 0), t, T_MAX)
    tk, k = torch.min(t, dim=-1, keepdim=True)
    uv = torch.cat([torch.gather(u, -1, k), torch.gather(v, -1, k)], dim=-1)
    return tk[:, 0], torch.gather(tids, -1, k)[:, 0], uv


def _step(bvh: BVHData, i, origin, inv_d, t_min, bound):
    """The box test of the lanes at nodes ``i`` against ``bound`` -> (box
    hit, the node's first leaf slot or -1 for an inner node)."""
    lo, hi = bvh.aabb_lo[i], bvh.aabb_hi[i]
    t0 = (lo - origin) * inv_d
    t1 = (hi - origin) * inv_d
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    box_hit = (tn <= tf) & (tf >= t_min) & (tn <= bound)
    return box_hit, bvh.leaf_first[i]


def traverse_closest(bvh: BVHData, origin, direction, t_min=1e-4, t_max=None) -> HitRecord:
    """Stackless closest-hit traversal over a ray wavefront [N, 3]."""
    n, dev = origin.shape[0], origin.device
    num_nodes = bvh.num_nodes
    if t_max is None:
        t_max = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
    inv_d = _safe_inv(direction)
    best_t = torch.clamp(t_max, max=T_MAX).clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_uv = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    act = torch.arange(n, device=dev)
    while act.numel():
        i = node[act]
        o, bt = origin[act], best_t[act]
        box_hit, first = _step(bvh, i, o, inv_d[act], t_min, bt)
        leaf = first >= 0
        do = box_hit & leaf
        lanes = torch.nonzero(do).squeeze(1)
        if lanes.numel():
            tk, ids, uvk = _leaf_hit(bvh, first[lanes].long(), o[lanes],
                                     direction[act[lanes]], t_min, bt[lanes])
            closer = tk < bt[lanes]
            dst = act[lanes[closer]]
            best_t[dst] = tk[closer]
            best_tri[dst] = ids[closer]
            best_uv[dst] = uvk[closer]
        nxt = torch.where(box_hit & ~leaf, i + 1, bvh.skip[i].long())
        node[act] = nxt
        act = act[nxt < num_nodes]
    best_t = torch.where(best_tri >= 0, best_t, T_MAX)
    return HitRecord(t=best_t, tri=best_tri, bary=best_uv)


def traverse_occluded(bvh: BVHData, origin, direction, t_max, t_min=1e-4):
    """Any-hit traversal: a lane stops as soon as something blocks the
    segment up to t_max * (1 - 1e-3)."""
    n, dev = origin.shape[0], origin.device
    num_nodes = bvh.num_nodes
    inv_d = _safe_inv(direction)
    limit = t_max * SHADOW_EPS
    blocked = torch.zeros((n,), dtype=torch.bool, device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    act = torch.arange(n, device=dev)
    while act.numel():
        i = node[act]
        o, lim = origin[act], limit[act]
        box_hit, first = _step(bvh, i, o, inv_d[act], t_min, lim)
        leaf = first >= 0
        do = box_hit & leaf
        lanes = torch.nonzero(do).squeeze(1)
        if lanes.numel():
            tk, ids, _ = _leaf_hit(bvh, first[lanes].long(), o[lanes],
                                   direction[act[lanes]], t_min, lim[lanes])
            hit = (ids >= 0) & (tk < lim[lanes])
            blocked[act[lanes[hit]]] = True
        nxt = torch.where(box_hit & ~leaf, i + 1, bvh.skip[i].long())
        node[act] = nxt
        act = act[(nxt < num_nodes) & ~blocked[act]]
    return blocked
