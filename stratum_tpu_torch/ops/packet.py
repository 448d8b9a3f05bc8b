"""The fat-leaf BVH and per-block leaf entry distances (counterpart of
stratum_tpu/ops/packet.py:75-233, 284-332). The packet tracer itself is not
on the port's path: the block tracer (ops/block_trace.py) walks this
structure.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stratum_tpu_torch.ops import mxu as smxu
from stratum_tpu_torch.utils.native import sah_order


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
                      leaf_size: int = 256) -> FatBVH:
    """Fat leaves from the native binned-SAH builder (numpy out). Raises if
    the native builder cannot be built or run: a Morton build would silently
    change every candidate list."""
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
    feats = smxu.build_tri_features(pos_np, idx_np, valid_np)
    leaf_feat = np.where(
        (flat >= 0)[:, None, None], feats[gather], np.float32(0.0)
    ).reshape(num_leaves, leaf_size, 10, 4)
    return FatBVH(
        leaf_lo=leaf_lo.astype(np.float32),
        leaf_hi=leaf_hi.astype(np.float32),
        leaf_feat=leaf_feat.astype(np.float32),
        leaf_tri=slots,
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
