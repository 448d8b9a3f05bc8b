"""The fat-leaf BVH, per-block leaf entry distances and the packet tracer
(counterpart of stratum_tpu/ops/packet.py:75-233, 284-475).

The block tracer (ops/block_trace.py) walks this structure on the main
path. The packet tracer (``tracer="packet"``) is the reference's XLA block
traversal: rays in blocks of ``block``; per block, the min entry distance to
every leaf box, the leaves in front-to-back order of that entry, and one
[B, K] Plucker test per visited leaf, until the next entry lies beyond the
block's worst committed hit (closest) or every lane is blocked (occluded).
The reference's ``while_loop`` per block becomes a loop over the blocks of
a group in lockstep, each step testing one leaf for every block still
walking; the host asks after each step whether any is left.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stratum_tpu_torch.ops import mxu as smxu
from stratum_tpu_torch.ops.intersect import SHADOW_EPS, T_MAX, HitRecord
from stratum_tpu_torch.utils.native import sah_order

DEFAULT_BLOCK = 2048
DEFAULT_GROUP = 32  # blocks walked together
ENTRY_ELEMS = 1 << 24  # [blocks, B, leaves] elements per entry pass


class FatBVH(NamedTuple):
    """Single-level fat-leaf hierarchy over SAH-ordered triangles."""

    leaf_lo: torch.Tensor  # f32 [L, 3]
    leaf_hi: torch.Tensor  # f32 [L, 3]
    leaf_feat: torch.Tensor  # f32 [L, K, 10, 4] Plucker blocks (0 = padding)
    leaf_tri: torch.Tensor  # i32 [L, K] original tri ids (-1 = padding, at the tail)

    @property
    def num_leaves(self) -> int:
        return self.leaf_lo.shape[0]


def leaf_counts(fat: FatBVH) -> torch.Tensor:
    """Real triangles per leaf, int32 [L]: slots [0, count) of a leaf hold
    triangles, the rest is padding (zero features) that no ray can hit."""
    return (fat.leaf_tri >= 0).sum(dim=1, dtype=torch.int32)


def build_fat_bvh_sah(positions, indices, valid_mask=None,
                      leaf_size: int = 256, features=None) -> FatBVH:
    """Fat leaves from the native binned-SAH builder (numpy out). Raises if
    the native builder cannot be built or run: a Morton build would silently
    change every candidate list. ``features``: the triangles'
    ``build_tri_features`` under the same mask, where the caller has them."""
    pos_np = np.asarray(positions, np.float32)
    idx_np = np.asarray(indices, np.int32)
    num_tris = idx_np.shape[0]
    valid_np = (
        np.ones(num_tris, bool) if valid_mask is None else np.asarray(valid_mask)
    )
    vids = np.nonzero(valid_np)[0].astype(np.int32)
    if len(vids) == 0:
        raise ValueError("scene has no valid triangles")
    order, offsets = sah_order(pos_np, idx_np[vids], leaf_size)
    order = vids[order]
    num_leaves = len(offsets) - 1
    slots = np.full((num_leaves, leaf_size), -1, np.int32)
    for leaf in range(num_leaves):
        seg = order[offsets[leaf]:offsets[leaf + 1]]
        slots[leaf, :len(seg)] = seg
    # the block kernel visits slots [0, count) of a leaf: padding at the tail
    count = (slots >= 0).sum(axis=1)
    assert ((slots >= 0) == (np.arange(leaf_size) < count[:, None])).all()
    flat = slots.reshape(-1)
    gather = np.maximum(flat, 0)
    p0 = pos_np[idx_np[gather, 0]]
    p1 = pos_np[idx_np[gather, 1]]
    p2 = pos_np[idx_np[gather, 2]]
    ok = (flat >= 0)[:, None]
    big = np.float32(3e37)
    lo = np.where(ok, np.minimum(np.minimum(p0, p1), p2), big)
    hi = np.where(ok, np.maximum(np.maximum(p0, p1), p2), -big)
    leaf_lo = lo.reshape(num_leaves, leaf_size, 3).min(axis=1)
    leaf_hi = hi.reshape(num_leaves, leaf_size, 3).max(axis=1)
    feats = (smxu.build_tri_features(pos_np, idx_np, valid_np) if features is None
             else np.asarray(features, np.float32))
    leaf_feat = np.where(
        (flat >= 0)[:, None, None], feats[gather], np.float32(0.0)
    ).reshape(num_leaves, leaf_size, 10, 4)
    return FatBVH(
        leaf_lo=leaf_lo.astype(np.float32),
        leaf_hi=leaf_hi.astype(np.float32),
        leaf_feat=leaf_feat.astype(np.float32),
        leaf_tri=slots,
    )


def empty_fat_bvh(leaf_size: int = 256) -> FatBVH:
    """One leaf with no triangle (numpy): the fat BVH of a scene whose
    geometry is all analytic spheres. No ray enters its inverted box."""
    big = np.float32(3e37)
    return FatBVH(
        leaf_lo=np.full((1, 3), big, np.float32),
        leaf_hi=np.full((1, 3), -big, np.float32),
        leaf_feat=np.zeros((1, leaf_size, 10, 4), np.float32),
        leaf_tri=np.full((1, leaf_size), -1, np.int32),
    )


def safe_inv(direction):
    """1/d with the reference's +-1e20 stand-in for |d| <= 1e-20."""
    return torch.where(
        torch.abs(direction) > 1e-20,
        1.0 / direction,
        torch.sign(direction) * 1e20 + 1e20,
    )


def _block_entries(box_lo, box_hi, origin, direction, t_min, t_clip):
    """Min-over-block entry distance to every box: origin/direction
    [nb, B, 3], t_clip [nb, B], boxes [G, 3] -> [nb, G] (inf where the whole
    block misses or enters beyond its t_clip). The reference chunks the
    box axis at 256; every box's entry is independent of the others, so one
    pass over all G boxes gives the same values, and callers chunk the block
    axis to bound the [nb, B, G] temporaries."""
    inv_d = safe_inv(direction)
    tn = None
    tf = None
    for ax in range(3):
        o = origin[..., ax:ax + 1]
        i = inv_d[..., ax:ax + 1]
        t0 = (box_lo[:, ax] - o) * i  # [nb, B, G]
        t1 = (box_hi[:, ax] - o) * i
        lo_t, hi_t = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = lo_t if tn is None else torch.maximum(tn, lo_t)
        tf = hi_t if tf is None else torch.minimum(tf, hi_t)
    hit = (tn <= tf) & (tf >= t_min) & (tn < t_clip[..., None])
    entry = torch.where(hit, torch.clamp(tn, min=0.0), float("inf"))
    return torch.amin(entry, dim=1)


def _leaf_test(fat: FatBVH, rays, leaves, best_t, t_min):
    """One [B, K] Plucker test per block against its leaf ``leaves[b]``:
    rays [nb, B, 10], best_t [nb, B] -> (t with T_MAX where invalid, u, v)
    each [nb, B, K], and the leaves' tri ids [nb, K]."""
    feat = fat.leaf_feat[leaves]  # [nb, K, 10, 4]
    tids = fat.leaf_tri[leaves]
    nb, k = feat.shape[:2]
    with smxu.full_f32():
        out = torch.matmul(rays, feat.permute(0, 2, 1, 3).reshape(nb, 10, k * 4))
    out = out.view(nb, rays.shape[1], k, 4)
    a = out[..., 0]
    inv_a = torch.where(torch.abs(a) > smxu._EPS_A, 1.0 / torch.where(a != 0, a, 1.0), 0.0)
    u, v, t = out[..., 1] * inv_a, out[..., 2] * inv_a, out[..., 3] * inv_a
    valid = (
        (torch.abs(a) > smxu._EPS_A) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > t_min) & (t < best_t[..., None]) & (tids >= 0)[:, None, :]
    )
    return torch.where(valid, t, T_MAX), u, v, tids


def _candidates(fat: FatBVH, o, d, t_min, t_clip):
    """Per block the leaves in front-to-back order of the block's entry
    distance, the sorted entries and the count of finite ones."""
    step = max(1, ENTRY_ELEMS // (o.shape[1] * fat.num_leaves))
    entry = torch.cat([
        _block_entries(fat.leaf_lo, fat.leaf_hi, o[s:s + step], d[s:s + step], t_min,
                       t_clip[s:s + step])
        for s in range(0, o.shape[0], step)
    ])  # [nb, L]
    order = torch.argsort(entry, dim=1, stable=True)
    sorted_entry = torch.gather(entry, 1, order)
    return order, sorted_entry, torch.isfinite(sorted_entry).sum(dim=1)


def _closest_group(fat: FatBVH, o, d, t_min, t_max):
    """Closest hits of a group of blocks [nb, B, 3]."""
    nb, b = o.shape[:2]
    n_leaves = fat.num_leaves
    order, sorted_entry, num_cand = _candidates(fat, o, d, t_min, t_max)
    rays = smxu.ray_features(o, d)
    best_t = torch.clamp(t_max, max=T_MAX).clone()
    best_tri = torch.full((nb, b), -1, dtype=torch.int32, device=o.device)
    best_uv = torch.zeros((nb, b, 2), dtype=torch.float32, device=o.device)
    c = torch.zeros(nb, dtype=torch.int64, device=o.device)
    while True:
        cc = torch.clamp(c, max=n_leaves - 1)[:, None]
        go = (c < num_cand) & (torch.gather(sorted_entry, 1, cc)[:, 0] < best_t.amax(dim=1))
        act = torch.nonzero(go).squeeze(1)
        if not act.numel():
            break
        bt = best_t[act]
        t, u, v, tids = _leaf_test(fat, rays[act], order[act, cc[act, 0]], bt, t_min)
        tk, k = torch.min(t, dim=-1, keepdim=True)
        closer = tk[..., 0] < bt
        best_t[act] = torch.where(closer, tk[..., 0], bt)
        best_tri[act] = torch.where(closer, torch.gather(tids, 1, k[..., 0]), best_tri[act])
        uv = torch.cat([torch.gather(u, -1, k), torch.gather(v, -1, k)], dim=-1)
        best_uv[act] = torch.where(closer[..., None], uv, best_uv[act])
        c[act] += 1
    best_t = torch.where(best_tri >= 0, best_t, T_MAX)
    return best_t, best_tri, best_uv


def _occluded_group(fat: FatBVH, o, d, t_min, t_max):
    """Blocked flags of a group of blocks [nb, B, 3]."""
    nb, b = o.shape[:2]
    n_leaves = fat.num_leaves
    limit = t_max * SHADOW_EPS
    order, _, num_cand = _candidates(fat, o, d, t_min, limit)
    rays = smxu.ray_features(o, d)
    blocked = torch.zeros((nb, b), dtype=torch.bool, device=o.device)
    c = torch.zeros(nb, dtype=torch.int64, device=o.device)
    while True:
        act = torch.nonzero((c < num_cand) & ~blocked.all(dim=1)).squeeze(1)
        if not act.numel():
            break
        leaves = order[act, torch.clamp(c[act], max=n_leaves - 1)]
        bl = blocked[act]
        t, _, _, _ = _leaf_test(fat, rays[act], leaves, torch.where(bl, 0.0, limit[act]), t_min)
        blocked[act] = bl | (t < T_MAX).any(dim=-1)
        c[act] += 1
    return blocked


def _grouped(fn, fat, origin, direction, t_max, block, group):
    """Pad the wave to whole blocks (origin 0, direction 1, t_max 0, as the
    reference pads) and run ``fn`` on groups of ``group`` blocks."""
    n = origin.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    o = torch.nn.functional.pad(origin, (0, 0, 0, pad)).view(nb, block, 3)
    d = torch.nn.functional.pad(direction, (0, 0, 0, pad), value=1.0).view(nb, block, 3)
    tm = torch.nn.functional.pad(t_max, (0, pad)).view(nb, block)
    parts = [fn(fat, o[s:s + group], d[s:s + group], tm[s:s + group])
             for s in range(0, nb, group)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(x).flatten(0, 1)[:n] for x in zip(*parts))
    return torch.cat(parts).flatten(0, 1)[:n]


def packet_closest(fat: FatBVH, origin, direction, t_min=1e-4, t_max=None,
                   block: int = DEFAULT_BLOCK, group: int = DEFAULT_GROUP) -> HitRecord:
    """Closest hit over the wavefront (triangle ids, as the dense tracers)."""
    if t_max is None:
        t_max = torch.full(origin.shape[:1], T_MAX, dtype=torch.float32, device=origin.device)
    t, tri, uv = _grouped(lambda f, o, d, tm: _closest_group(f, o, d, t_min, tm),
                          fat, origin, direction, t_max, block, group)
    return HitRecord(t=t, tri=tri, bary=uv)


def packet_occluded(fat: FatBVH, origin, direction, t_max, t_min=1e-4,
                    block: int = DEFAULT_BLOCK, group: int = DEFAULT_GROUP):
    """Any-hit query: True where a triangle lies before t_max * (1 - 1e-3)."""
    return _grouped(lambda f, o, d, tm: _occluded_group(f, o, d, t_min, tm),
                    fat, origin, direction, t_max, block, group)
