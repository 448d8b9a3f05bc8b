"""Binned pair-stream tracer (counterpart of stratum_tpu/ops/binned.py):
pairs of (ray group, leaf) binned by leaf, one leaf per 128-lane bin.

Kernels of this module (source ``csrc/binned.cu``):

* K5, the bin step: replaces ``binned._bin_kernel`` (binned.py:68), reached
  through ``_binned_trace`` (:124) and its ``pl.pallas_call`` (:362) from
  ``pallas_closest_binned`` (:460) and ``pallas_occluded_binned`` (:554).
* The emission kernel: replaces the reference's emission, the jnp
  ``emit_slice`` inside ``_binned_trace`` (:146-275; a ``lax.scan`` over
  64-leaf chunks inside ``lax.map``), which is not a Pallas kernel.

The pipeline, in the reference's order:

1. **Emit.** Every ``g`` consecutive rays form a group. Per-ray slab tests
   (``em="ray"``, reduced to per-group bits) or one interval test per group
   (``em="group"``, conservative) against every leaf AABB give each group its
   passing leaves; ``count`` [NG] is the raw number and the first ``pcap`` of
   them, in leaf order, fill a [NG, pcap] table. Groups with no live lane
   (every t bound 0) emit nothing.
2. **Sort.** The pairs, sorted by leaf (pair id ascending within a leaf),
   cut to ``mcap``.
3. **Pad.** Each leaf's run is padded to a multiple of ``sb * 128 / g``
   pairs, so each 128-lane bin holds pairs of one leaf.
4. **Bin step** (K5). For each lane (one pair, one ray of its group) whose
   own ray passes the emission's slab test of the bin's leaf (``em="ray"``'s
   per-ray bit), the closest valid triangle among the leaf's real ones under
   the reference accept rule, folded into the ray's answer as a 64-bit
   ``(t bits << 32) | slot`` minimum (positive f32 bit patterns order like
   their values, and a minimum does not depend on the order the lanes land
   in). A lane whose ray misses the box, or is dead, has no hit there.
5. **Resolve.** That per-ray minimum is the closest hit; occlusion tests it
   against ``t_max * (1 - 1e-3)``.

The emission kernel holds the leaf boxes in shared memory: all of them
where they fit its budget (``EMIT_SMEM_BUDGET``), else tiles of
``EMIT_TILE`` leaves streamed in leaf order (:func:`emit_tile_leaves`);
both give the same count and slots. ``emit_mode="tiled"`` forces tiles on
any scene, for checks; the render path never sets it.

Steps 1 and 4 run as kernels when the rays lie on a CUDA device (no
fallback: a build or launch failure raises) and as their plain versions,
:func:`_emit` and :func:`bin_min_plain`, only when they lie on the CPU;
sort and padding are the same torch code on both. ``LAUNCHES`` counts kernel
launches. Dropped pairs (``pcap`` or ``mcap`` overflow) are misses, as in
the reference; ``stats`` counts them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from stratum_tpu_torch.ops.block_trace import (
    SHADOW_EPS,
    T_MIN,
    _check,
    _classify,
    _default_t_max,
    _slot_record,
    leaf_rows,
    mt_quantities,
    pack_key,
)
from stratum_tpu_torch.ops.intersect import T_MAX
from stratum_tpu_torch.ops.mxu import ray_features
from stratum_tpu_torch.ops.packet import FatBVH, leaf_counts, safe_inv

LANES = 128  # lanes per bin
LEAF_PAD = 64  # the plain emission pads the leaf axis to a multiple of this with NaN boxes
# slab tests per plain emission pass: bounds the [rays, leaves] temporaries to
# 128 MB of f32 each (a ray chunk, whole groups, against every leaf)
EMIT_ELEMS = 1 << 25
MISS = (0x7F800000 << 32) | 0x7FFFFFFF  # +inf t, no slot: above every hit
PLAIN_LANES = 1 << 16  # lanes per plain-version MT pass
EMIT_SMEM_BUDGET = 227 * 1024  # shared memory an emission CTA may use (csrc kMaxSmem)
EMIT_CHUNK = 32  # leaves per chunk box of the emission kernel (csrc kChunk)
EMIT_TILE = 2048  # leaves per tile past the budget (49 KB of boxes)
FORCED_TILES = 4  # emit_mode="tiled" cuts the leaves into at least this many tiles

LAUNCHES = {"emit": 0, "closest": 0, "occluded": 0}


class Bins(NamedTuple):
    """One wave's binned pairs, the bin step's input."""

    bin_leaf: torch.Tensor  # i32 [nbins] leaf of each 128-lane bin
    pair_id: torch.Tensor  # i32 [nbins * 128 / g] group * pcap + p; -1 = padding
    rays: torch.Tensor  # f32 [n, 10] Plucker ray features
    origin: torch.Tensor  # f32 [n, 3] (the bin step's slab pretest)
    inv_dir: torch.Tensor  # f32 [n, 3] safe_inv(direction)
    t_bound: torch.Tensor  # f32 [n] emission bound (0 = a dead lane)
    t_min: float
    g: int
    pcap: int
    stats: dict  # pairs, dropped_pcap, dropped_mcap, bins_used (python ints)
    lost: torch.Tensor  # bool [n]: the lane's group dropped a pair

    @property
    def n(self) -> int:
        return self.rays.shape[0]


def _slab_pass(lo, hi, o, inv, tb, t_min):
    """Per-ray slab tests of S rays against Lx boxes -> bool [S, Lx]
    (binned.py:247-270): subtract, multiply, min, max and compares only,
    so the kernels compute the same bits."""
    t0x = (lo[None, :, 0] - o[:, 0:1]) * inv[:, 0:1]  # [S, Lx]
    t1x = (hi[None, :, 0] - o[:, 0:1]) * inv[:, 0:1]
    t0y = (lo[None, :, 1] - o[:, 1:2]) * inv[:, 1:2]
    t1y = (hi[None, :, 1] - o[:, 1:2]) * inv[:, 1:2]
    t0z = (lo[None, :, 2] - o[:, 2:3]) * inv[:, 2:3]
    t1z = (hi[None, :, 2] - o[:, 2:3]) * inv[:, 2:3]
    tn = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.clamp_min(torch.minimum(t0z, t1z), 0.0),
    )
    tf = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.maximum(t0z, t1z),
    )
    return (tn <= tf) & (tf >= t_min) & (tn < tb[:, None])


def _pass_ray(lo, hi, o, inv, tb, t_min, g):
    """Per-ray slab tests reduced to group bits (binned.py:223-246)."""
    return _slab_pass(lo, hi, o, inv, tb, t_min).view(-1, g, lo.shape[0]).any(dim=1)


def _pass_group(lo, hi, o, inv, tb, t_min, g):
    """One interval-arithmetic slab test per (group, leaf) over the group's
    live lanes (binned.py:152-221): passes whenever any live ray could, so
    it only adds pairs the bin step then rejects."""
    big = 3.0e38
    alive = (tb > 0.0)[:, None]

    def gmin(x):
        return torch.where(alive, x, big).view(-1, g, 3).amin(dim=1)

    def gmax(x):
        return torch.where(alive, x, -big).view(-1, g, 3).amax(dim=1)

    o_lo, o_hi, i_lo, i_hi = gmin(o), gmax(o), gmin(inv), gmax(inv)
    tb_g = tb.view(-1, g).amax(dim=1)
    ngs = o_lo.shape[0]
    tn_lo = torch.zeros((ngs, lo.shape[0]), dtype=o.dtype, device=o.device)
    tf_hi = torch.full_like(tn_lo, big)
    for a in range(3):
        ol, oh, il, ih = (x[:, a:a + 1] for x in (o_lo, o_hi, i_lo, i_hi))
        bt = []
        for b in (lo[None, :, a], hi[None, :, a]):
            u_lo, u_hi = b - oh, b - ol
            p1, p2, p3, p4 = u_lo * il, u_lo * ih, u_hi * il, u_hi * ih
            bt.append((
                torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
                torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)),
            ))
        tn_lo = torch.maximum(tn_lo, torch.minimum(bt[0][0], bt[1][0]))
        tf_hi = torch.minimum(tf_hi, torch.maximum(bt[0][1], bt[1][1]))
    return (tn_lo <= tf_hi) & (tf_hi >= t_min) & (tn_lo < tb_g[:, None])


def _emit(fat: FatBVH, o, inv, tb, t_min, g, pcap, em):
    """Step 1 on a wave padded to whole groups, plain version of
    :func:`emit_launch` -> (count [NG] raw, slots [NG, pcap] i32, -1 past
    the group's passing leaves). The leaf axis is padded to a multiple of
    64 with NaN boxes, like the reference's 64-leaf chunks (a NaN box
    passes no test; an inverted one would pass every ray's)."""
    ng = o.shape[0] // g
    L = fat.num_leaves
    L64 = -(-L // LEAF_PAD) * LEAF_PAD
    lo = torch.nn.functional.pad(fat.leaf_lo, (0, 0, 0, L64 - L), value=float("nan"))
    hi = torch.nn.functional.pad(fat.leaf_hi, (0, 0, 0, L64 - L), value=float("nan"))
    dev = o.device
    count = torch.zeros(ng, dtype=torch.int32, device=dev)
    slots = torch.full((ng, pcap), -1, dtype=torch.int32, device=dev)
    live = torch.nonzero(tb.view(ng, g).amax(dim=1) > 0).squeeze(1)
    test = _pass_ray if em == "ray" else _pass_group
    step = max(1, EMIT_ELEMS // ((g if em == "ray" else 1) * L64))
    lane = torch.arange(g, device=dev)
    leaf_ids = torch.arange(L64, dtype=torch.int32, device=dev)
    for s in range(0, live.numel(), step):
        grp = live[s:s + step]
        rows = (grp[:, None] * g + lane).reshape(-1)
        pg = test(lo, hi, o[rows], inv[rows], tb[rows], t_min, g)  # [ngs, L64]
        cum = torch.cumsum(pg, dim=1)
        dest = torch.where(pg & (cum <= pcap), cum - 1, pcap)  # column pcap: discarded
        table = torch.full((grp.numel(), pcap + 1), -1, dtype=torch.int32, device=dev)
        table.scatter_(1, dest, leaf_ids.expand(grp.numel(), L64))
        count[grp] = cum[:, -1].to(torch.int32)
        slots[grp] = table[:, :pcap]
    return count, slots


def _lib():
    from stratum_tpu_torch.utils import cuda_build

    lib = cuda_build.load("binned")
    if not getattr(lib, "_stratum_bound", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.binned_emit.argtypes = [ptr] * 5 + [i32] * 6 + [f32] + [ptr] * 3
        lib.binned_min.argtypes = [ptr] * 10 + [i32] * 5 + [f32] + [ptr] * 2
        lib.binned_info.argtypes = [i32] * 4 + [ptr]
        for fn in (lib.binned_emit, lib.binned_min, lib.binned_info):
            fn.restype = ctypes.c_int
        lib._stratum_bound = True
    return lib


def emit_smem(tile: int, g: int, pcap: int) -> int:
    """Dynamic shared memory (bytes) of an emission CTA holding ``tile``
    leaf boxes and their chunk boxes (24 B each) and its groups' slot rows."""
    return 24 * (tile + -(-tile // EMIT_CHUNK)) + 4 * (LANES // g) * pcap


def emit_tile_leaves(num_leaves: int, g: int, pcap: int, mode: str = "auto") -> int:
    """Leaf boxes an emission CTA holds at a time: every leaf where they fit
    ``EMIT_SMEM_BUDGET``, else ``EMIT_TILE``; ``mode="tiled"`` forces tiles
    (a multiple of 32 leaves, at least ``FORCED_TILES`` of them where the
    scene has the leaves)."""
    if mode not in ("auto", "tiled"):
        raise ValueError(f"emit_mode must be 'auto' or 'tiled', not {mode!r}")
    if mode == "tiled":
        per = -(-num_leaves // FORCED_TILES)
        return min(EMIT_TILE, max(EMIT_CHUNK, -(-per // EMIT_CHUNK) * EMIT_CHUNK))
    if emit_smem(num_leaves, g, pcap) <= EMIT_SMEM_BUDGET:
        return num_leaves
    return EMIT_TILE


def emit_launch(fat: FatBVH, o, inv, tb, t_min, g, pcap, em, emit_mode: str = "auto"):
    """One emission-kernel launch over a wave padded to whole groups: the
    same (count, slots) as :func:`_emit`, bit for bit. The leaf boxes go
    through shared memory in tiles of :func:`emit_tile_leaves` leaves
    (one tile where they all fit)."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError("the emission kernel runs on CUDA tensors only")
    L = fat.num_leaves
    npad = o.shape[0]
    if npad % g:
        raise ValueError(f"{npad} rays are not whole groups of {g}")
    if pcap < 1:
        raise ValueError(f"pcap ({pcap}) must be at least 1")
    for x, name, shape in ((o, "origin", (npad, 3)), (inv, "inv_dir", (npad, 3)),
                           (tb, "t_bound", (npad,)), (fat.leaf_lo, "leaf_lo", (L, 3)),
                           (fat.leaf_hi, "leaf_hi", (L, 3))):
        _check(x, name, torch.float32, shape, dev)
    tile = emit_tile_leaves(L, g, pcap, emit_mode)
    ng = npad // g
    count = torch.empty(ng, dtype=torch.int32, device=dev)
    slots = torch.empty((ng, pcap), dtype=torch.int32, device=dev)
    if ng == 0:
        return count, slots
    rc = _lib().binned_emit(
        o.data_ptr(), inv.data_ptr(), tb.data_ptr(), fat.leaf_lo.data_ptr(),
        fat.leaf_hi.data_ptr(), npad, L, tile, g, pcap, int(em == "group"), t_min,
        count.data_ptr(), slots.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"binned emission kernel launch failed: cudaError {rc}")
    LAUNCHES["emit"] += 1
    return count, slots


def emit(fat: FatBVH, o, inv, tb, t_min, g, pcap, em, emit_mode: str = "auto"):
    """Step 1: the emission kernel on CUDA tensors (``emit_mode`` as
    :func:`emit_tile_leaves`), :func:`_emit` on CPU ones."""
    if o.device.type == "cpu":
        return _emit(fat, o, inv, tb, t_min, g, pcap, em)
    return emit_launch(fat, o, inv, tb, t_min, g, pcap, em, emit_mode)


def pad_wave(origin, direction, t_bound, g: int):
    """The emission's input: the wave padded to whole groups of ``g`` (origin
    0, direction 1.0, bound 0: dead lanes) -> contiguous (origin, inverse
    direction, bound)."""
    pad = -origin.shape[0] % g
    return (torch.nn.functional.pad(origin, (0, 0, 0, pad)).contiguous(),
            safe_inv(torch.nn.functional.pad(direction, (0, 0, 0, pad), value=1.0)).contiguous(),
            torch.nn.functional.pad(t_bound, (0, pad)).contiguous())


def bin_pairs(fat: FatBVH, origin, direction, t_bound, t_min=T_MIN, g: int = 8,
              pcap: int = 16, mcap: int | None = None, sb: int = 1,
              em: str = "ray") -> Bins:
    """Steps 1-3 (emit, sort, pad) of a wave whose rays emit pairs while
    their leaf entry is below ``t_bound`` (0 = a dead lane)."""
    if g < 1 or LANES % g:
        raise ValueError(f"g ({g}) must divide {LANES}")
    if em not in ("ray", "group"):
        raise ValueError(f"unknown emission mode {em!r}")
    if sb < 1:
        raise ValueError(f"sb ({sb}) must be at least 1")
    n = origin.shape[0]
    dev = origin.device
    if mcap is None:
        mcap = max(n // 2, 1 << 14)
    o, inv, tb = pad_wave(origin, direction, t_bound, g)
    count, slots = emit(fat, o, inv, tb, t_min, g, pcap, em)

    # 2. sort the pairs by leaf (stable: pair ids ascend within a leaf)
    kept = torch.clamp(count, max=pcap)
    pid = torch.nonzero(
        (torch.arange(pcap, device=dev)[None, :] < kept[:, None]).view(-1)
    ).squeeze(1)
    key = slots.view(-1)[pid]
    order = torch.sort(key, stable=True).indices
    pairs = pid.numel()
    lost_grp = count > pcap
    if pairs > mcap:
        lost_grp[pid[order[mcap:]] // pcap] = True
        order = order[:mcap]
    skey, spid = key[order], pid[order].to(torch.int32)

    # 3. pad each leaf's run to whole steps of sb bins
    pw = sb * (LANES // g)
    L = fat.num_leaves
    runs = torch.bincount(skey, minlength=L)  # kept pairs per leaf
    steps = (runs + pw - 1) // pw
    start = torch.cumsum(runs, dim=0) - runs  # a leaf's first sorted pair
    pstart = (torch.cumsum(steps, dim=0) - steps) * pw  # and its first padded slot
    dst = pstart[skey] + torch.arange(skey.numel(), device=dev) - start[skey]
    # one host sync for the table size and the drop count
    nsteps, dropped_pcap = torch.stack(
        [steps.sum(), torch.clamp(count - pcap, min=0).sum()]).tolist()
    pair_id = torch.full((nsteps * pw,), -1, dtype=torch.int32, device=dev)
    pair_id[dst] = spid
    bin_leaf = torch.repeat_interleave(torch.arange(L, dtype=torch.int32, device=dev),
                                       steps * sb, output_size=nsteps * sb)
    stats = {
        "pairs": pairs,
        "dropped_pcap": dropped_pcap,
        "dropped_mcap": max(pairs - mcap, 0),
        "bins_used": nsteps,  # the reference counts steps of sb bins
    }
    return Bins(
        bin_leaf=bin_leaf,
        pair_id=pair_id,
        rays=ray_features(origin, direction).contiguous(),
        origin=o[:n], inv_dir=inv[:n], t_bound=tb[:n], t_min=float(t_min),
        g=g, pcap=pcap, stats=stats,
        lost=lost_grp.repeat_interleave(g)[:n],
    )


def launch(fat: FatBVH, bins: Bins, kind: str):
    """One K5 launch over every bin -> i64 [n] ``(t bits << 32) | slot``
    minima (MISS where no lane of the ray hit). ``kind`` ("closest" or
    "occluded") names the counter it adds to."""
    dev = bins.rays.device
    if dev.type != "cuda":
        raise ValueError("the binned kernel runs on CUDA tensors only")
    L, K = fat.leaf_tri.shape
    nbins = bins.bin_leaf.shape[0]
    n = bins.n
    counts = leaf_counts(fat)
    f32, i32 = torch.float32, torch.int32
    for x, name, dt, shape in (
        (bins.bin_leaf, "bin_leaf", i32, (nbins,)),
        (bins.pair_id, "pair_id", i32, (nbins * LANES // bins.g,)),
        (bins.rays, "rays", f32, (n, 10)),
        (bins.origin, "origin", f32, (n, 3)),
        (bins.inv_dir, "inv_dir", f32, (n, 3)),
        (bins.t_bound, "t_bound", f32, (n,)),
        (fat.leaf_lo, "leaf_lo", f32, (L, 3)),
        (fat.leaf_hi, "leaf_hi", f32, (L, 3)),
        (counts, "leaf_count", i32, (L,)),
        (fat.leaf_feat, "leaf_feat", f32, (L, K, 10, 4)),
    ):
        _check(x, name, dt, shape, dev)
    words = torch.full((n,), MISS, dtype=torch.int64, device=dev)
    if nbins == 0:
        return words
    rc = _lib().binned_min(
        bins.bin_leaf.data_ptr(), bins.pair_id.data_ptr(), bins.rays.data_ptr(),
        bins.origin.data_ptr(), bins.inv_dir.data_ptr(), bins.t_bound.data_ptr(),
        fat.leaf_lo.data_ptr(), fat.leaf_hi.data_ptr(), counts.data_ptr(),
        fat.leaf_feat.data_ptr(), nbins, n, K, bins.g, bins.pcap, bins.t_min,
        words.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"binned kernel launch failed: cudaError {rc}")
    LAUNCHES[kind] += 1
    return words


def kernel_info(kernel: str, num_leaves: int = 0, g: int = 8, pcap: int = 16) -> dict:
    """Registers per thread, static and dynamic shared memory (bytes),
    resident CTAs per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)
    and local (spill) bytes per thread of the compiled K5 (``kernel="bin"``)
    or emission kernel (``"emit"``, whose shared memory depends on the leaf
    count, through :func:`emit_tile_leaves`, ``g`` and ``pcap``; its
    ``tile_leaves`` is added). K5's also holds its schedule: ``run_bins``
    bins per CTA, each leaf of a run visited once per ``pass_lanes`` lanes
    that pass the pretest."""
    if kernel not in ("bin", "emit"):
        raise ValueError(f"kernel must be 'bin' or 'emit', not {kernel!r}")
    names = ("registers", "static_smem", "dynamic_smem", "ctas_per_sm", "local_bytes")
    if kernel == "bin":
        names += ("run_bins", "pass_lanes")
    out = (ctypes.c_int * 7)()
    tile = emit_tile_leaves(num_leaves, g, pcap) if kernel == "emit" else 0
    rc = _lib().binned_info(int(kernel == "emit"), tile, g, pcap, out)
    if rc != 0:
        raise RuntimeError(f"binned_info failed: cudaError {rc}")
    info = dict(zip(names, out))
    if kernel == "emit":
        info["tile_leaves"] = tile
    return info


def lane_rays(bins: Bins):
    """Per lane of every bin: (its ray, whether it carries a pair of a real
    ray). Lane ``j`` of a bin is ray ``j % g`` of the bin's pair ``j // g``."""
    pair = bins.pair_id.repeat_interleave(bins.g)
    ray = (pair // bins.pcap) * bins.g + torch.arange(pair.numel(), device=pair.device) % bins.g
    return ray, (pair >= 0) & (ray < bins.n)


def bin_min_plain(fat: FatBVH, bins: Bins):
    """Plain torch twin of :func:`launch` (same output): leaf run by leaf
    run, the lanes whose own ray passes the leaf's slab test, exact f32 MT
    against the leaf's real triangles, lower slot on equal t, folded per ray
    with ``scatter_reduce("amin")``."""
    dev = bins.rays.device
    L, K = fat.leaf_tri.shape
    rows = leaf_rows(fat)
    nv = leaf_counts(fat).tolist()
    words = torch.full((bins.n,), MISS, dtype=torch.int64, device=dev)
    ray, ok = lane_rays(bins)
    leaves, runs = torch.unique_consecutive(bins.bin_leaf, return_counts=True)
    ends = (torch.cumsum(runs, dim=0) * LANES).tolist()
    for leaf, start, end in zip(leaves.tolist(), [0] + ends[:-1], ends):
        if leaf < 0 or nv[leaf] == 0:
            continue  # an empty bin or leaf: misses only
        lo, hi = fat.leaf_lo[leaf:leaf + 1], fat.leaf_hi[leaf:leaf + 1]
        for s in range(start, end, PLAIN_LANES):
            sl = slice(s, min(s + PLAIN_LANES, end))
            r = ray[sl][ok[sl]]
            r = r[_slab_pass(lo, hi, bins.origin[r], bins.inv_dir[r], bins.t_bound[r],
                             bins.t_min)[:, 0]]
            if r.numel() == 0:
                continue
            q = mt_quantities(bins.rays[r], rows[leaf, :, :nv[leaf] * 4])
            abs_a, stn, valid = _classify(q)
            tt = torch.where(valid, stn / torch.where(valid, abs_a, 1.0), float("inf"))
            tk, k = torch.min(tt, dim=1)
            hit = torch.isfinite(tk)
            word = pack_key(tk, leaf * K + k)
            words.scatter_reduce_(0, r[hit], word[hit], "amin")
    return words


def bin_min(fat: FatBVH, bins: Bins, kind: str):
    """The bin step: K5 on CUDA tensors, :func:`bin_min_plain` on CPU ones."""
    if bins.rays.device.type == "cpu":
        return bin_min_plain(fat, bins)
    return launch(fat, bins, kind)


def unpack(words):
    """``(t bits << 32) | slot`` words -> (t f32, slot i32); t = +inf on a
    miss."""
    t = (words >> 32).to(torch.int32).view(torch.float32)
    return t, (words & 0xFFFFFFFF).to(torch.int32)


def binned_closest(fat: FatBVH, origin, direction, t_max=None, t_min=T_MIN,
                   g: int = 8, pcap: int = 16, mcap: int | None = None,
                   sb: int = 1, em: str = "ray", with_stats: bool = False):
    """Closest hit per ray as a slot-mode HitRecord (``finalize_hit``
    resolves it), counterpart of ``pallas_closest_binned``. With
    ``with_stats``, returns (HitRecord, Bins) so the caller reads
    ``stats`` and the lanes whose group dropped a pair."""
    t_max = _default_t_max(origin, t_max)
    bins = bin_pairs(fat, origin, direction, t_max, t_min, g, pcap, mcap, sb, em)
    t, slot = unpack(bin_min(fat, bins, "closest"))
    hit = (t < t_max) & (t < T_MAX)
    h = _slot_record(torch.where(hit, t, T_MAX), torch.where(hit, slot, -1))
    return (h, bins) if with_stats else h


def binned_occluded(fat: FatBVH, origin, direction, t_max, t_min=T_MIN,
                    g: int = 8, pcap: int = 16, mcap: int | None = None,
                    sb: int = 1, em: str = "ray", with_stats: bool = False):
    """Any-hit before t_max * (1 - 1e-3): bool [N], counterpart of
    ``pallas_occluded_binned`` (a ray is blocked when its closest binned
    hit lies below that limit). With ``with_stats``: (blocked, Bins)."""
    limit = t_max * SHADOW_EPS
    bins = bin_pairs(fat, origin, direction, limit, t_min, g, pcap, mcap, sb, em)
    t, _ = unpack(bin_min(fat, bins, "occluded"))
    blocked = t < limit
    return (blocked, bins) if with_stats else blocked
