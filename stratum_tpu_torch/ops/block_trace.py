"""Block-BVH tracer: candidate prep in torch, the leaf loop in CUDA
(counterpart of stratum_tpu/ops/pallas_trace.py).

Kernels of this module (source ``csrc/block_trace.cu``):

* K1, closest hit: replaces ``pallas_trace._kernel_gs`` in closest mode,
  reached through ``pallas_closest`` (pallas_trace.py:1781).
* K2, any-hit: the same kernel with ``OCCLUDED = true``, replacing
  ``_kernel_gs(occluded=True)`` reached through ``pallas_occluded``
  (pallas_trace.py:1905).

``block_closest`` / ``block_occluded`` launch the kernel when the rays lie
on a CUDA device and use ``block_closest_plain`` / ``block_occluded_plain``
only when they lie on the CPU. There is no fallback from one to the other:
a CUDA tensor launches the kernel or raises. ``LAUNCHES`` counts kernel
launches (and nothing else), so a run can show that its path went through
the kernels.

Results are slot-mode: ``slot = leaf * K + row`` (int32, -1 on a miss), and
:func:`finalize_hit` resolves a slot to triangle, barycentrics and the fused
shading/material payload with one row gather. Closest hits are exact-f32
Moller-Trumbore in Plucker form with the reference accept rule; equal t
keeps the lower slot.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from stratum_tpu_torch.ops import mxu as smxu
from stratum_tpu_torch.ops.intersect import HitRecord, T_MAX
from stratum_tpu_torch.ops.packet import FatBVH, _block_entries, safe_inv

BLOCK = 2048  # rays per candidate list (one 2048-lane ray block)
GS = 4  # leaves per candidate group (the reference's default GS)
T_MIN = 1e-4  # block entries ignore boxes the ray leaves before this
SHADOW_EPS = float(np.float32(1.0 - 1e-3))
# blocks per _block_entries pass: bounds the [blocks, BLOCK, G] temporaries
# (64 x 2048 x 190 f32 = 100 MB each at the atrium's G)
ENTRY_CHUNK_BLOCKS = 64
PLAIN_RAY_CHUNK = 1 << 20
PLAIN_MM_ROWS = 65536

LAUNCHES = {"closest": 0, "occluded": 0}


class Prepared(NamedTuple):
    """Per-wave kernel inputs; rays padded to ``nb * BLOCK`` (nb a multiple
    of 8) with direction 1.0 and t_max 0 in the padding."""

    rays: torch.Tensor  # f32 [Np, 10] Plucker ray features
    t_max: torch.Tensor  # f32 [Np]
    origin: torch.Tensor  # f32 [Np, 3]
    inv_dir: torch.Tensor  # f32 [Np, 3]
    cand: torch.Tensor  # i32 [nb, G] group ids, front to back
    centry: torch.Tensor  # f32 [nb, G] entry distances (3e38 past ncand)
    ncand: torch.Tensor  # i32 [nb]
    n: int  # rays before padding


def group_boxes(fat: FatBVH):
    """AABBs of the G = ceil(L / GS) groups of consecutive leaves; members
    past L are padded with inverted boxes."""
    L = fat.num_leaves
    G = -(-L // GS)
    big = 3.0e37
    pad = G * GS - L
    lo = torch.nn.functional.pad(fat.leaf_lo, (0, 0, 0, pad), value=big)
    hi = torch.nn.functional.pad(fat.leaf_hi, (0, 0, 0, pad), value=-big)
    return lo.reshape(G, GS, 3).amin(dim=1), hi.reshape(G, GS, 3).amax(dim=1)


def _prepare(fat: FatBVH, origin, direction, t_max) -> Prepared:
    """Candidate prep (pallas_trace.py:1685-1767, group mode): per 2048-ray
    block, the entry distance to every leaf group, sorted front to back
    (stable, like jnp.argsort), with the count of groups the block reaches.
    Dead lanes (t_max = 0) contribute no entries."""
    n = origin.shape[0]
    block = BLOCK
    nb = -(-n // block)
    nb = -(-nb // 8) * 8
    pad = nb * block - n
    o = torch.nn.functional.pad(origin, (0, 0, 0, pad))
    d = torch.nn.functional.pad(direction, (0, 0, 0, pad), value=1.0)
    tm = torch.nn.functional.pad(t_max, (0, pad))
    glo, ghi = group_boxes(fat)
    ob, db, tb = o.view(nb, block, 3), d.view(nb, block, 3), tm.view(nb, block)
    entries = torch.cat([
        _block_entries(glo, ghi, ob[s:s + ENTRY_CHUNK_BLOCKS],
                       db[s:s + ENTRY_CHUNK_BLOCKS], T_MIN,
                       tb[s:s + ENTRY_CHUNK_BLOCKS])
        for s in range(0, nb, ENTRY_CHUNK_BLOCKS)
    ])
    sorted_entry, order = torch.sort(entries, dim=1, stable=True)
    finite = torch.isfinite(sorted_entry)
    return Prepared(
        rays=smxu.ray_features(o, d).contiguous(),
        t_max=tm.contiguous(),
        origin=o.contiguous(),
        inv_dir=safe_inv(d).contiguous(),
        cand=order.to(torch.int32).contiguous(),
        centry=torch.where(finite, sorted_entry, 3.0e38).contiguous(),
        ncand=finite.sum(dim=1).to(torch.int32),
        n=n,
    )


def _lib():
    from stratum_tpu_torch.utils import cuda_build

    lib = cuda_build.load("block_trace")
    if not getattr(lib, "_stratum_bound", False):
        ptrs = [ctypes.c_void_p] * 10
        ints = [ctypes.c_int] * 5
        lib.block_trace_closest.argtypes = ptrs + ints + [ctypes.c_void_p] * 3
        lib.block_trace_occluded.argtypes = ptrs + ints + [ctypes.c_void_p] * 2
        lib.block_trace_closest.restype = ctypes.c_int
        lib.block_trace_occluded.restype = ctypes.c_int
        lib._stratum_bound = True
    return lib


def _check(x: torch.Tensor, name, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(fat: FatBVH, prep: Prepared, occluded: bool):
    """One kernel launch over every ray block of a prepared wave."""
    dev = prep.rays.device
    if dev.type != "cuda":
        raise ValueError("the block-trace kernel runs on CUDA tensors only")
    L, K = fat.leaf_tri.shape
    nb, G = prep.cand.shape
    np_ = nb * BLOCK
    f32, i32 = torch.float32, torch.int32
    for x, name, dt, shape in (
        (prep.rays, "rays", f32, (np_, 10)),
        (prep.t_max, "t_max", f32, (np_,)),
        (prep.origin, "origin", f32, (np_, 3)),
        (prep.inv_dir, "inv_dir", f32, (np_, 3)),
        (prep.cand, "cand", i32, (nb, G)),
        (prep.centry, "centry", f32, (nb, G)),
        (prep.ncand, "ncand", i32, (nb,)),
        (fat.leaf_lo, "leaf_lo", f32, (L, 3)),
        (fat.leaf_hi, "leaf_hi", f32, (L, 3)),
        (fat.leaf_feat, "leaf_feat", f32, (L, K, 10, 4)),
    ):
        _check(x, name, dt, shape, dev)
    if G * GS < L:
        raise ValueError(f"{G} groups of {GS} do not cover {L} leaves")
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = [
        prep.rays.data_ptr(), prep.t_max.data_ptr(), prep.origin.data_ptr(),
        prep.inv_dir.data_ptr(), prep.cand.data_ptr(), prep.centry.data_ptr(),
        prep.ncand.data_ptr(), fat.leaf_lo.data_ptr(), fat.leaf_hi.data_ptr(),
        fat.leaf_feat.data_ptr(), nb, G, L, K, GS,
    ]
    if occluded:
        blocked = torch.empty(np_, dtype=torch.uint8, device=dev)
        rc = lib.block_trace_occluded(*args, blocked.data_ptr(), stream)
        outs = (blocked,)
    else:
        t = torch.empty(np_, dtype=f32, device=dev)
        slot = torch.empty(np_, dtype=i32, device=dev)
        rc = lib.block_trace_closest(*args, t.data_ptr(), slot.data_ptr(), stream)
        outs = (t, slot)
    if rc != 0:
        raise RuntimeError(f"block_trace kernel launch failed: cudaError {rc}")
    LAUNCHES["occluded" if occluded else "closest"] += 1
    return outs


def _slot_record(t, slot) -> HitRecord:
    return HitRecord(
        t=t, tri=torch.where(slot >= 0, 0, -1).to(torch.int32),
        bary=torch.zeros(t.shape + (2,), dtype=t.dtype, device=t.device),
        slot=slot,
    )


def _default_t_max(origin, t_max):
    if t_max is None:
        return torch.full(origin.shape[:1], T_MAX, dtype=torch.float32,
                          device=origin.device)
    return t_max


def block_closest(fat: FatBVH, origin, direction, t_max=None) -> HitRecord:
    """Closest hit per ray as a slot-mode HitRecord. CUDA tensors run the
    kernel (K1); CPU tensors run :func:`block_closest_plain`."""
    t_max = _default_t_max(origin, t_max)
    if origin.device.type == "cpu":
        return block_closest_plain(fat, origin, direction, t_max)
    prep = _prepare(fat, origin, direction, t_max)
    t, slot = launch(fat, prep, occluded=False)
    return _slot_record(t[:prep.n], slot[:prep.n])


def block_occluded(fat: FatBVH, origin, direction, t_max):
    """Any-hit before t_max * (1 - 1e-3): bool [N]. CUDA tensors run
    the kernel (K2); CPU tensors run :func:`block_occluded_plain`."""
    if origin.device.type == "cpu":
        return block_occluded_plain(fat, origin, direction, t_max)
    prep = _prepare(fat, origin, direction, t_max * SHADOW_EPS)
    (blocked,) = launch(fat, prep, occluded=True)
    return blocked[:prep.n].bool()


# ---------------------------------------------------------------------------
# plain torch versions: same contract, no candidate lists
# ---------------------------------------------------------------------------

def _leaf_slab(lo, hi, origin, inv_d):
    """Per-ray (tn, tf) against one box, tn clamped at 0 (the kernel's
    pretest formula)."""
    t0 = (lo - origin) * inv_d
    t1 = (hi - origin) * inv_d
    tn = torch.clamp(torch.amax(torch.minimum(t0, t1), dim=-1), min=0.0)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    return tn, tf


def _classify(q):
    """[m, K, 4] (a, u_num, v_num, t_num) -> (abs_a, stn, valid) with the
    reference accept rule (pallas_trace._mt_classify)."""
    a, u, v, t = q.unbind(-1)
    s = torch.sign(a)
    abs_a, su, sv, stn = a * s, u * s, v * s, t * s
    valid = (
        (abs_a > 1e-12) & (abs_a < 1e37) & (su >= 0.0) & (sv >= 0.0)
        & (su + sv <= abs_a) & (stn > 1e-4 * abs_a)
    )
    return abs_a, stn, valid


def _plain_walk(fat: FatBVH, origin, direction, bound, occluded: bool):
    """Every leaf whose AABB a ray reaches before its current bound, in leaf
    order, exact f32 MT over all K slots. Rays are walked in chunks of
    PLAIN_RAY_CHUNK and each leaf's wanting rays in matmuls of at most
    PLAIN_MM_ROWS rows, so a full 1080p wave fits beside the scene."""
    L, K = fat.leaf_tri.shape
    feat = fat.leaf_feat.permute(0, 2, 1, 3).reshape(L, 10, K * 4)
    best = bound.clone()
    slot = torch.full(best.shape, -1, dtype=torch.int32, device=best.device)
    for s in range(0, origin.shape[0], PLAIN_RAY_CHUNK):
        o = origin[s:s + PLAIN_RAY_CHUNK]
        rf = smxu.ray_features(o, direction[s:s + PLAIN_RAY_CHUNK])
        inv_d = safe_inv(direction[s:s + PLAIN_RAY_CHUNK])
        b = best[s:s + PLAIN_RAY_CHUNK]
        sl = slot[s:s + PLAIN_RAY_CHUNK]
        for leaf in range(L):
            tn, tf = _leaf_slab(fat.leaf_lo[leaf], fat.leaf_hi[leaf], o, inv_d)
            want = torch.nonzero((tn <= tf) & (tn < b)).squeeze(1)
            for m in range(0, want.numel(), PLAIN_MM_ROWS):
                idx = want[m:m + PLAIN_MM_ROWS]
                q = (rf[idx] @ feat[leaf]).view(-1, K, 4)
                abs_a, stn, valid = _classify(q)
                if occluded:
                    hit = (valid & (stn < b[idx, None] * abs_a)).any(dim=1)
                    b[idx[hit]] = 0.0
                    continue
                tt = torch.where(
                    valid, stn / torch.where(valid, abs_a, 1.0), float("inf")
                )
                tk, k = torch.min(tt, dim=1)
                closer = tk < b[idx]
                b[idx[closer]] = tk[closer]
                sl[idx[closer]] = (leaf * K + k[closer]).to(torch.int32)
    return best, slot


def block_closest_plain(fat: FatBVH, origin, direction, t_max=None) -> HitRecord:
    """Plain torch twin of :func:`block_closest` (same outputs)."""
    t_max = _default_t_max(origin, t_max)
    best, slot = _plain_walk(fat, origin, direction, t_max, occluded=False)
    return _slot_record(torch.where(slot >= 0, best, T_MAX), slot)


def block_occluded_plain(fat: FatBVH, origin, direction, t_max):
    """Plain torch twin of :func:`block_occluded` (same outputs)."""
    limit = t_max * SHADOW_EPS
    best, _ = _plain_walk(fat, origin, direction, limit, occluded=True)
    return (best <= 0.0) & (limit > 0.0)


def finalize_hit(slot_payload, origin, direction, h: HitRecord) -> HitRecord:
    """Resolve a slot-mode record with ONE [N, 88] payload row gather:
    triangle id, barycentrics (MT coefficients against the caller-order ray
    features) and the fused shading/material payload
    (pallas_trace.py:1877-1902)."""
    if h.slot is None:
        return h
    hit = h.slot >= 0
    payload = slot_payload[torch.clamp(h.slot, min=0).long()]
    tri = torch.where(hit, payload[:, 62].to(torch.int32), -1)
    rf = smxu.ray_features(origin, direction)
    a = torch.zeros_like(h.t)
    u_num = torch.zeros_like(h.t)
    v_num = torch.zeros_like(h.t)
    for f in range(10):
        a = a + rf[:, f] * payload[:, 32 + f * 3 + 0]
        u_num = u_num + rf[:, f] * payload[:, 32 + f * 3 + 1]
        v_num = v_num + rf[:, f] * payload[:, 32 + f * 3 + 2]
    inv_a = torch.where(torch.abs(a) > 1e-12, 1.0 / a, 0.0)
    bary = torch.stack([u_num * inv_a, v_num * inv_a], dim=-1)
    bary = torch.where(hit[:, None], bary, 0.0)
    return HitRecord(t=h.t, tri=tri, bary=bary, payload=payload, slot=None)
