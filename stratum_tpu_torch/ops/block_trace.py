"""Block-BVH tracer: the list phase and the leaf loop in one CUDA kernel
(counterpart of stratum_tpu/ops/pallas_trace.py).

Kernels of this module (source ``csrc/block_trace.cu``):

* K1, closest hit: replaces ``pallas_trace._kernel_gs`` in closest mode,
  reached through ``pallas_closest`` (pallas_trace.py:1781).
* K2, any-hit: the same kernel with ``OCCLUDED = true``, replacing
  ``_kernel_gs(occluded=True)`` reached through ``pallas_occluded``
  (pallas_trace.py:1905).
* K3, the same kernel at a group size of 1 (``gs=1``): candidates are
  single leaves, which is what ``pallas_trace._kernel`` (:532) and
  ``_kernel_occ`` (:958) compute; ``_run_blocks`` picks those when gs == 1.
* K4 (``_kernel_ring`` :742, ``_kernel_occ_ring`` :1117) only reorders the
  TPU kernel's commits and gives the same results, so K1-K3 compute it.

The reference builds one front-to-back list of leaf groups per 2048-lane
block in XLA before its kernel runs (``pallas_trace._prepare``). Here each
CTA of 128 rays builds its own list inside the kernel; :func:`_prepare`
only pads the rays to whole CTAs and computes their features, inverse
directions and the group boxes. :func:`candidate_lists` is the plain
version of the list phase: at ``block=2048`` it is the reference's list bit
for bit, and at ``block=128`` with ``live_only=True`` it is what each CTA
of the kernel builds.

The group size ``gs`` is an argument of the prep and the wrappers (``GS`` =
4 is the reference's default); the plain versions do not depend on it.

Two list modes (:func:`resolve_list_mode`). Up to ``AUTO_SHARED_KEYS`` keys
(G groups padded to a power of two) a CTA computes every group's entry and
sorts all of them in shared memory ("shared"; the kernel takes up to
``MAX_LIST_KEYS``). Past that it culls ("culled"): a coarse level of super-groups of ``SUPER_SIZE`` consecutive
groups (:func:`super_boxes`, the exact min / max of their members) is
tested first, only the members of the super-groups some live ray reaches
get an entry, and only the finite keys are kept and sorted, in shared memory
(``CULL_LIST_KEYS`` at most). The culling is conservative in f32: a
member's box lies inside its super-group's and both roundings of the slab
formula are monotone, so a group a ray reaches never sits in a super-group
it misses (the argument is written out in ``csrc/block_trace.cu``).
:func:`culled_lists` is the plain version of this two-level phase. A CTA
whose reached keys exceed ``CULL_LIST_KEYS`` overflows: it computes every
entry and sorts all keys in its own row of a scratch buffer of
``LIST_SCRATCH_BYTES`` (the wave launches in chunks of CTAs that reuse it),
so no scene size is refused and no host synchronisation decides anything.
``list_mode="shared"`` forces the shared mode where the keys fit,
``list_mode="culled"`` the culled mode on any scene, and
``list_mode="global"`` sends every CTA down the overflow path (the design
before the culling); these are for checks, and the render path never sets
them. ``stats="phases"`` reports each CTA's overflow flag and the clock
cycles of its list phase and its walk.

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
from typing import NamedTuple, Optional

import numpy as np
import torch

from stratum_tpu_torch.ops import mxu as smxu
from stratum_tpu_torch.ops.intersect import HitRecord, T_MAX
from stratum_tpu_torch.ops.packet import FatBVH, _block_entries, leaf_counts, safe_inv

BLOCK = 2048  # rays per candidate list of the reference (one 2048-lane block)
CTA = 128  # rays per CTA of the kernel, each CTA with its own list
GS = 4  # default leaves per candidate group (the reference's GS)
T_MIN = 1e-4  # block entries ignore boxes the ray leaves before this
SHADOW_EPS = float(np.float32(1.0 - 1e-3))
MAX_LIST_KEYS = 4096  # shared mode: list keys a CTA sorts in shared memory (csrc kMaxKeys)
# "auto" takes the shared mode up to this many keys and culls past it: on the
# atrium at gs = 1 (1,024 keys) the culled mode is the faster (chip_smoke.py
# phase 9's forced modes), at gs = 4 (256 keys) the shared one
AUTO_SHARED_KEYS = 512
SUPER_SIZE = 64  # culled mode: groups per super-group
CULL_LIST_KEYS = 2048  # culled mode: reached keys a CTA sorts in shared memory (a power of two)
LIST_SCRATCH_BYTES = 1 << 29  # the culled mode's overflow rows: 512 MB of keys
# elements per _block_entries pass: bounds the [blocks, block, G] temporaries
# to 100 MB of f32 each
ENTRY_CHUNK_ELEMS = 64 * 2048 * 190
PLAIN_RAY_CHUNK = 1 << 20
PLAIN_MT_ROWS = 65536

LAUNCHES = {"closest": 0, "occluded": 0}


class Prepared(NamedTuple):
    """Per-wave kernel inputs; rays padded to whole CTAs with direction 1.0
    and t_max 0 in the padding."""

    rays: torch.Tensor  # f32 [Np, 10] Plucker ray features
    t_max: torch.Tensor  # f32 [Np]
    origin: torch.Tensor  # f32 [Np, 3]
    inv_dir: torch.Tensor  # f32 [Np, 3]
    group_lo: torch.Tensor  # f32 [G, 3] boxes of gs consecutive leaves
    group_hi: torch.Tensor  # f32 [G, 3]
    leaf_count: torch.Tensor  # i32 [L] real triangles per leaf
    gs: int  # leaves per group
    n: int  # rays before padding


class Lists(NamedTuple):
    """Front-to-back candidate lists, one per block of rays."""

    cand: Optional[torch.Tensor]  # i32 [nb, G] group ids, front to back
    centry: Optional[torch.Tensor]  # f32 [nb, G] entry distances (3e38 past ncand)
    ncand: torch.Tensor  # i32 [nb] groups the block reaches


class Phases(NamedTuple):
    """Per-CTA statistics of a launch (``stats="phases"``)."""

    ncand: torch.Tensor  # i32 [n_cta] groups the CTA reaches
    overflow: torch.Tensor  # bool [n_cta] the CTA sorted its list in its scratch row
    list_cycles: torch.Tensor  # i64 [n_cta] clock64 cycles of its list phase (staging included)
    walk_cycles: torch.Tensor  # i64 [n_cta] and of its walk (both 0 without a live ray)


def _merge_boxes(lo, hi, size: int):
    """AABBs of runs of ``size`` consecutive boxes; the last run is padded
    with inverted boxes."""
    n = -(-lo.shape[0] // size)
    big = 3.0e37
    pad = n * size - lo.shape[0]
    lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=big)
    hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-big)
    return lo.reshape(n, size, 3).amin(dim=1), hi.reshape(n, size, 3).amax(dim=1)


def group_boxes(fat: FatBVH, gs: int = GS):
    """AABBs of the G = ceil(L / gs) groups of consecutive leaves; members
    past L are padded with inverted boxes. At gs = 1 these are the leaf
    boxes."""
    return _merge_boxes(fat.leaf_lo, fat.leaf_hi, gs)


def super_boxes(group_lo, group_hi, size: Optional[int] = None):
    """AABBs of the culled mode's super-groups: ceil(G / size) runs of
    ``size`` consecutive groups (``SUPER_SIZE`` by default), padded like
    :func:`group_boxes`."""
    return _merge_boxes(group_lo, group_hi, SUPER_SIZE if size is None else size)


def _pad_rays(origin, direction, t_max, multiple: int):
    """Rays padded to a multiple of ``multiple`` lanes: origin 0,
    direction 1.0, t_max 0 (dead lanes)."""
    pad = -origin.shape[0] % multiple
    return (torch.nn.functional.pad(origin, (0, 0, 0, pad)),
            torch.nn.functional.pad(direction, (0, 0, 0, pad), value=1.0),
            torch.nn.functional.pad(t_max, (0, pad)))


def _prepare(fat: FatBVH, origin, direction, t_max, gs: int = GS) -> Prepared:
    """What the kernel reads besides the scene: the rays padded to whole
    CTAs, their Plucker features and inverse directions, the group boxes
    and the leaves' real-triangle counts. The candidate lists are built
    inside the kernel."""
    o, d, tm = _pad_rays(origin, direction, t_max, CTA)
    glo, ghi = group_boxes(fat, gs)
    return Prepared(
        rays=smxu.ray_features(o, d).contiguous(),
        t_max=tm.contiguous(),
        origin=o.contiguous(),
        inv_dir=safe_inv(d).contiguous(),
        group_lo=glo.contiguous(),
        group_hi=ghi.contiguous(),
        leaf_count=leaf_counts(fat),
        gs=gs,
        n=origin.shape[0],
    )


def _blocks(origin, direction, t_max, block: int, live_only: bool):
    """The rays as [nb, block] blocks (padded to whole blocks, and the
    blocks to a multiple of 8, as the reference pads); with ``live_only``
    every lane with t_max <= 0 gets t_clip -inf, so it reaches nothing."""
    nb = -(-origin.shape[0] // block)
    nb = -(-nb // 8) * 8
    o, d, tm = _pad_rays(origin, direction, t_max, nb * block)
    if live_only:
        tm = torch.where(tm > 0, tm, float("-inf"))
    return o.view(nb, block, 3), d.view(nb, block, 3), tm.view(nb, block)


def _entries(lo, hi, ob, db, tb):
    """``_block_entries`` of every box for every block, in passes that bound
    the [blocks, block, boxes] temporaries -> [nb, boxes]."""
    nb, block = tb.shape
    step = max(1, ENTRY_CHUNK_ELEMS // (block * lo.shape[0]))
    return torch.cat([
        _block_entries(lo, hi, ob[s:s + step], db[s:s + step], T_MIN, tb[s:s + step])
        for s in range(0, nb, step)
    ])


def _sorted_lists(entries) -> Lists:
    sorted_entry, order = torch.sort(entries, dim=1, stable=True)
    finite = torch.isfinite(sorted_entry)
    return Lists(
        cand=order.to(torch.int32),
        centry=torch.where(finite, sorted_entry, 3.0e38),
        ncand=finite.sum(dim=1).to(torch.int32),
    )


def candidate_lists(fat: FatBVH, origin, direction, t_max, gs: int = GS,
                    block: int = BLOCK, live_only: bool = False) -> Lists:
    """Plain version of the kernel's list phase (pallas_trace.py:1685-1767):
    per block of ``block`` rays (their count padded to whole blocks, and
    the blocks to a multiple of 8, as the reference pads), the entry
    distance to every group of ``gs`` leaves (single leaves at gs = 1, as
    the reference's ``entry_group`` 1), sorted front to back (stable, like
    jnp.argsort), with the count of groups the block reaches.

    The reference's entry pass also counts a box that a dead lane (t_max 0)
    sits inside (its entry tn < 0 is below t_clip 0), though such a lane
    can never commit. ``live_only`` drops those: every lane with t_max <= 0
    reaches nothing, which is what the kernel's CTAs do."""
    ob, db, tb = _blocks(origin, direction, t_max, block, live_only)
    glo, ghi = group_boxes(fat, gs)
    return _sorted_lists(_entries(glo, ghi, ob, db, tb))


def culled_lists(fat: FatBVH, origin, direction, t_max, gs: int = GS,
                 block: int = CTA, live_only: bool = True,
                 super_size: Optional[int] = None, cap: Optional[int] = None):
    """Plain version of the culled list phase, the two levels apart: per
    block, the entry of every super-group of ``super_size`` groups
    (:func:`super_boxes`), then the entries of the members of the reached
    super-groups only (every other group's entry stays +inf), then a
    stable sort -> (``Lists`` equal to :func:`candidate_lists`' bit for
    bit, the culling being conservative; bool [nb] the blocks that reach
    more than ``cap`` groups (``CULL_LIST_KEYS`` by default) and so
    overflow to a scratch row in the kernel). ``super_size`` defaults to
    ``SUPER_SIZE``. Blocks are padded as :func:`candidate_lists` pads
    them."""
    cap = CULL_LIST_KEYS if cap is None else cap
    super_size = SUPER_SIZE if super_size is None else super_size
    ob, db, tb = _blocks(origin, direction, t_max, block, live_only)
    glo, ghi = group_boxes(fat, gs)
    slo, shi = super_boxes(glo, ghi, super_size)
    G = glo.shape[0]
    reached = torch.isfinite(_entries(slo, shi, ob, db, tb))  # [nb, S]
    member = reached.repeat_interleave(super_size, dim=1)[:, :G]
    entries = torch.full(member.shape, float("inf"), device=glo.device)
    for b in torch.nonzero(member.any(dim=1)).squeeze(1).tolist():
        idx = torch.nonzero(member[b]).squeeze(1)
        entries[b, idx] = _entries(glo[idx], ghi[idx], ob[b:b + 1], db[b:b + 1],
                                   tb[b:b + 1])[0]
    lists = _sorted_lists(entries)
    return lists, lists.ncand > cap


def list_keys(num_groups: int) -> int:
    """Keys of a CTA's list: G padded to a power of two."""
    return 1 << max(num_groups - 1, 0).bit_length()


def resolve_list_mode(num_groups: int, mode: str = "auto") -> str:
    """How the kernel builds a CTA's list: "shared" up to
    ``AUTO_SHARED_KEYS`` keys, else "culled"; ``mode`` "shared" (where the
    keys fit ``MAX_LIST_KEYS``) and "culled" force a mode, "global" the
    culled mode's overflow path for every CTA."""
    if mode not in ("auto", "shared", "culled", "global"):
        raise ValueError(
            f"list_mode must be 'auto', 'shared', 'culled' or 'global', not {mode!r}")
    if mode == "shared" and list_keys(num_groups) > MAX_LIST_KEYS:
        raise ValueError(f"{list_keys(num_groups)} list keys do not fit the shared mode's "
                         f"{MAX_LIST_KEYS}")
    if mode != "auto":
        return mode
    return "culled" if list_keys(num_groups) > AUTO_SHARED_KEYS else "shared"


def list_scratch_ctas(num_groups: int, n_cta: int) -> int:
    """CTAs per chunk of a culled-mode launch: as many overflow rows of
    ``list_keys(num_groups)`` keys as ``LIST_SCRATCH_BYTES`` holds, at most
    the wave's CTAs."""
    return max(1, min(n_cta, LIST_SCRATCH_BYTES // (8 * list_keys(num_groups))))


def _lib():
    from stratum_tpu_torch.utils import cuda_build

    lib = cuda_build.load("block_trace")
    if not getattr(lib, "_stratum_bound", False):
        ptrs = [ctypes.c_void_p] * 12
        ints = [ctypes.c_int] * 9
        stats = [ctypes.c_void_p] * 4
        scratch = [ctypes.c_void_p, ctypes.c_int]
        lib.block_trace_closest.argtypes = ptrs + ints + [ctypes.c_void_p] * 2 + stats + (
            scratch + [ctypes.c_void_p])
        lib.block_trace_occluded.argtypes = ptrs + ints + [ctypes.c_void_p] + stats + (
            scratch + [ctypes.c_void_p])
        lib.block_trace_info.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        for fn in (lib.block_trace_closest, lib.block_trace_occluded, lib.block_trace_info):
            fn.restype = ctypes.c_int
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


def launch(fat: FatBVH, prep: Prepared, occluded: bool, stats: Optional[str] = None,
           list_mode: str = "auto"):
    """The kernel over every CTA of a prepared wave -> (t, slot) or
    (blocked,): one launch in the shared list mode, one per chunk of
    :func:`list_scratch_ctas` CTAs in the culled mode (see
    :func:`resolve_list_mode` for ``list_mode``). ``stats="ncand"`` appends
    the per-CTA list lengths as ``Lists(None, None, ncand)``,
    ``stats="lists"`` each CTA's whole sorted list as well (``Lists`` at
    block 128: what ``candidate_lists(..., block=CTA, live_only=True)``
    gives for its blocks), ``stats="phases"`` a :class:`Phases`."""
    L, K = fat.leaf_tri.shape
    G = prep.group_lo.shape[0]
    if G != -(-L // prep.gs):
        raise ValueError(f"{G} candidate groups do not match {L} leaves in groups of {prep.gs}")
    mode = resolve_list_mode(G, list_mode)
    dev = prep.rays.device
    if dev.type != "cuda":
        raise ValueError("the block-trace kernel runs on CUDA tensors only")
    if stats not in (None, "ncand", "lists", "phases"):
        raise ValueError(f"stats must be None, 'ncand', 'lists' or 'phases', not {stats!r}")
    if CULL_LIST_KEYS < 1 or CULL_LIST_KEYS & (CULL_LIST_KEYS - 1):
        raise ValueError(f"CULL_LIST_KEYS must be a power of two, not {CULL_LIST_KEYS}")
    np_ = prep.rays.shape[0]
    if np_ % CTA:
        raise ValueError(f"{np_} rays are not whole CTAs of {CTA}")
    n_cta = np_ // CTA
    f32, i32 = torch.float32, torch.int32
    for x, name, dt, shape in (
        (prep.rays, "rays", f32, (np_, 10)),
        (prep.t_max, "t_max", f32, (np_,)),
        (prep.origin, "origin", f32, (np_, 3)),
        (prep.inv_dir, "inv_dir", f32, (np_, 3)),
        (prep.group_lo, "group_lo", f32, (G, 3)),
        (prep.group_hi, "group_hi", f32, (G, 3)),
        (fat.leaf_lo, "leaf_lo", f32, (L, 3)),
        (fat.leaf_hi, "leaf_hi", f32, (L, 3)),
        (prep.leaf_count, "leaf_count", i32, (L,)),
        (fat.leaf_feat, "leaf_feat", f32, (L, K, 10, 4)),
    ):
        _check(x, name, dt, shape, dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    slo = shi = scratch = None
    n_super, chunk = 0, 0
    if mode != "shared":
        slo, shi = (x.contiguous() for x in super_boxes(prep.group_lo, prep.group_hi,
                                                         SUPER_SIZE))
        n_super = slo.shape[0]
        chunk = list_scratch_ctas(G, n_cta)
        scratch = torch.empty(chunk * list_keys(G), dtype=torch.int64, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    args = [
        prep.rays.data_ptr(), prep.t_max.data_ptr(), prep.origin.data_ptr(),
        prep.inv_dir.data_ptr(), prep.group_lo.data_ptr(), prep.group_hi.data_ptr(),
        ptr(slo), ptr(shi), fat.leaf_lo.data_ptr(), fat.leaf_hi.data_ptr(),
        prep.leaf_count.data_ptr(), fat.leaf_feat.data_ptr(), n_cta, G, n_super,
        SUPER_SIZE, CULL_LIST_KEYS, int(mode == "global"), L, K, prep.gs,
    ]
    whole = stats == "lists"
    ncand = None if stats is None else torch.empty(n_cta, dtype=i32, device=dev)
    cand = torch.empty((n_cta, G), dtype=i32, device=dev) if whole else None
    centry = torch.empty((n_cta, G), dtype=f32, device=dev) if whole else None
    cta = torch.empty((n_cta, 3), dtype=torch.int64, device=dev) if stats == "phases" else None
    stat_ptrs = [ptr(ncand), ptr(centry), ptr(cand), ptr(cta)]
    scratch_args = (ptr(scratch), chunk)
    if occluded:
        blocked = torch.empty(np_, dtype=torch.uint8, device=dev)
        rc = lib.block_trace_occluded(*args, blocked.data_ptr(), *stat_ptrs, *scratch_args,
                                      stream)
        outs = (blocked,)
    else:
        t = torch.empty(np_, dtype=f32, device=dev)
        slot = torch.empty(np_, dtype=i32, device=dev)
        rc = lib.block_trace_closest(*args, t.data_ptr(), slot.data_ptr(), *stat_ptrs,
                                     *scratch_args, stream)
        outs = (t, slot)
    if rc != 0:
        raise RuntimeError(f"block_trace kernel launch failed: cudaError {rc}")
    LAUNCHES["occluded" if occluded else "closest"] += 1
    if stats is None:
        return outs
    if stats == "phases":
        return outs + (Phases(ncand, cta[:, 0] != 0, cta[:, 1], cta[:, 2]),)
    return outs + (Lists(cand=cand, centry=centry, ncand=ncand),)


def kernel_info(occluded: bool, num_groups: int, mode: str = "shared") -> dict:
    """The compiled kernel's registers per thread, static and dynamic
    shared memory (bytes), resident CTAs per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and local (spill)
    bytes per thread, at a list of ``num_groups`` groups, in the list mode
    ``mode`` ("shared", or "culled" and "global", one instantiation with
    ``CULL_LIST_KEYS`` keys in shared memory)."""
    out = (ctypes.c_int * 5)()
    rc = _lib().block_trace_info(int(occluded), int(mode != "shared"), num_groups,
                                 CULL_LIST_KEYS, out)
    if rc != 0:
        raise RuntimeError(f"block_trace_info failed: cudaError {rc}")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "ctas_per_sm",
                     "local_bytes"), out))


def pack_key(t, slot):
    """The kernel's commit key as int64: (t bits << 32) | slot. For t >= 0
    and slot >= 0 the keys order like (t, slot) lexicographically, so their
    minimum is the closest hit with the lower slot on equal t."""
    return (t.view(torch.int32).to(torch.int64) << 32) | slot.to(torch.int64)


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


def block_closest(fat: FatBVH, origin, direction, t_max=None, gs: int = GS,
                  list_mode: str = "auto") -> HitRecord:
    """Closest hit per ray as a slot-mode HitRecord. CUDA tensors run the
    kernel (K1, or K3 at gs = 1; ``list_mode`` as :func:`launch`); CPU
    tensors run :func:`block_closest_plain`, whose result does not depend
    on ``gs``."""
    t_max = _default_t_max(origin, t_max)
    if origin.device.type == "cpu":
        return block_closest_plain(fat, origin, direction, t_max)
    prep = _prepare(fat, origin, direction, t_max, gs)
    t, slot = launch(fat, prep, occluded=False, list_mode=list_mode)
    return _slot_record(t[:prep.n], slot[:prep.n])


def block_occluded(fat: FatBVH, origin, direction, t_max, gs: int = GS,
                   list_mode: str = "auto"):
    """Any-hit before t_max * (1 - 1e-3): bool [N]. CUDA tensors run
    the kernel (K2, or K3 at gs = 1; ``list_mode`` as :func:`launch`); CPU
    tensors run :func:`block_occluded_plain`."""
    if origin.device.type == "cpu":
        return block_occluded_plain(fat, origin, direction, t_max)
    prep = _prepare(fat, origin, direction, t_max * SHADOW_EPS, gs)
    (blocked,) = launch(fat, prep, occluded=True, list_mode=list_mode)
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


def leaf_rows(fat: FatBVH):
    """Leaf features as [L, 10, K * 4]: row f of leaf l holds feature f of
    (a, u_num, v_num, t_num) for every slot, so ``mt_quantities`` takes a
    leaf's block as one [10, K * 4] tensor."""
    L, K = fat.leaf_tri.shape
    return fat.leaf_feat.permute(0, 2, 1, 3).reshape(L, 10, K * 4)


def mt_quantities(rf, rows):
    """[m, 10] ray features against one leaf's [10, K * 4] rows -> [m, K, 4]
    (a, u_num, v_num, t_num): the ten products summed in feature order with
    separate multiplies and adds. Unlike a matmul, whose blocking on the CPU
    depends on the batch, a ray's result does not depend on the rays beside
    it, so every plain version built on this agrees bit for bit."""
    q = rf[:, 0, None] * rows[0]
    for f in range(1, 10):
        q += rf[:, f, None] * rows[f]
    return q.view(rf.shape[0], -1, 4)


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
    order, exact f32 MT over the leaf's real triangles (padded slots are
    never valid). Rays are walked in chunks of PLAIN_RAY_CHUNK and each
    leaf's wanting rays in MT passes of at most PLAIN_MT_ROWS rows, so a
    full 1080p wave fits beside the scene."""
    L, K = fat.leaf_tri.shape
    feat = leaf_rows(fat)
    counts = leaf_counts(fat).tolist()
    best = bound.clone()
    slot = torch.full(best.shape, -1, dtype=torch.int32, device=best.device)
    for s in range(0, origin.shape[0], PLAIN_RAY_CHUNK):
        o = origin[s:s + PLAIN_RAY_CHUNK]
        rf = smxu.ray_features(o, direction[s:s + PLAIN_RAY_CHUNK])
        inv_d = safe_inv(direction[s:s + PLAIN_RAY_CHUNK])
        b = best[s:s + PLAIN_RAY_CHUNK]
        sl = slot[s:s + PLAIN_RAY_CHUNK]
        for leaf in range(L):
            if counts[leaf] == 0:
                continue
            rows = feat[leaf, :, :counts[leaf] * 4]
            tn, tf = _leaf_slab(fat.leaf_lo[leaf], fat.leaf_hi[leaf], o, inv_d)
            want = torch.nonzero((tn <= tf) & (tn < b)).squeeze(1)
            for m in range(0, want.numel(), PLAIN_MT_ROWS):
                idx = want[m:m + PLAIN_MT_ROWS]
                abs_a, stn, valid = _classify(mt_quantities(rf[idx], rows))
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
