#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``stratum_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its results:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the CUDA kernels from ``stratum_tpu_torch/csrc`` (one nvcc per
   source, started together; sm_90a), with ptxas registers and spills;
3. kernel against plain version: each instantiation's registers and
   resident CTAs per SM; the block-trace kernel (K1 closest, K2 occluded)
   against its plain torch version on the full 132,778-triangle atrium, on
   65,536-ray batches (primary, cosine secondary, shadow rays toward
   presampled lights) and on the waves one 1920x1080 sample of the main
   path hands the wrappers (five closest waves of 2,073,600 lanes, the
   deferred shadow wave of 10,368,000 lanes), with both times (the kernel's
   launch includes its list phase: each CTA builds its own front-to-back
   list). The per-CTA list lengths the kernel reports (``stats``) are held
   bit for bit to ``candidate_lists(..., block=128, live_only=True)`` on
   closest wave 1 (with each CTA's sorted entries and groups) and on the
   deferred wave, and their mean is printed beside the reference's
   per-2048-block figure on every wave. Then K3 (the same kernel at group
   size 1) on closest wave 1 and the deferred wave, against the same plain
   results, timed beside K1/K2;
4. parity: the tiny atrium at 64x32, seeds 0-3, on the block kernel
   (``tracer="pallas"``), against the JAX reference's golden images
   (tests/golden/torch_atrium_tiny.npz);
5. main path: ``render_path_with_counts`` on the full atrium at 1920x1080
   with the bench configuration (Disney, 4 bounces, presample 4096,
   coherent tiles 16): 1 warm-up and 4 timed samples; the kernel launch
   counters are zeroed just before and read just after this phase;
6. the binned path: the same render with ``binned_secondary=8,
   binned_shadow=8``. The registers and resident CTAs of K5 and of the
   emission kernel; then one sample's binned waves (4 sorted closest waves,
   the deferred shadow wave) are replayed: first, on a slice of closest
   wave 1, the emission kernel against the plain emission at g 1, 32, 64
   and 128, both modes and pcap 3 and 32; then on every wave the emission
   kernel's count and slots against the plain (torch) emission's, bit for
   bit, both timed, beside the bytes and slab tests it needs; K5
   against its plain version on each wave's bins, and the binned results
   against the block kernel on every lane whose group dropped no pair; the
   drop counts, lanes past K5's pretest and triangle tests are printed.
   Then 1 warm-up and 4 timed samples with the counters zeroed around them;
7. other configurations: one sample with ``binned_bounces=1`` (image mean
   within phase 4's bound of phase 5's) and one with ``gs=1``, whose
   launches are K3's and whose image must equal phase 5's sample at the
   same seed bit for bit (K1 and K3 both compute exact f32 and keep the
   lower slot on equal t);
8. the microbenchmark tools (``stratum_tpu_torch/tools``, kernels T1-T4 in
   ``csrc/microbench.cu``): their four ``main`` entry points at the
   reference defaults and at k=256, with the T launch counters zeroed just
   before and read just after; then each T kernel against its plain
   version on two input sets, small integers (bit for bit: every product
   and sum is exact) and standard normal values (within each tool's stated
   bound), at the default shapes and at k=256, and the plain versions and
   (T3/T4) one ``torch.matmul`` of the same bf16 product timed per visit;
   last, a visit of 256 slots by 128 lanes per SM, at one CTA per SM and
   with the card full, both by T1 ``epi`` (tensor cores) and by K1 (its
   exact-f32 counterpart), and by K1 at 21 real slots per leaf (the
   atrium's entered leaves hold ~21 triangles; K1 visits only a leaf's
   real triangles);
9. past the shared-memory budgets: a synthetic atrium (``BIG_ATRIUM``,
   ~10,400 SAH leaves) whose gs=1 lists need 16,384 keys and whose emission
   boxes need more than 227 KB. On its camera wave and a shadow wave from
   its hits: K3 in the global list mode against the plain walk, its per-CTA
   lists bit for bit against ``candidate_lists(..., block=128,
   live_only=True)``, the tiled emission against ``_emit`` bit for bit,
   with times, scratch and shared bytes. Then on the full atrium's primary
   and shadow waves the forced global list mode (gs 4 and 1) and the forced
   tiled emission against the default modes, bit for bit, both timed;
10. the Cornell path: ``render_path_with_counts`` on the Cornell box at
   1920x1080 with bench.py's cornell_e2e configuration (Lambert, 4 bounces,
   presample 4096, ``tracer="auto"``), which must resolve to the dense
   tracer with a shadow wave per bounce (no deferred wave) and launch no
   kernel; its primary wave against ``intersect_brute_force`` (the same
   triangle on non-degenerate rays, t within 2^-12) and its product against
   float64 (TF32 off); 1 warm-up and 4 timed samples (ms/spp, Mrays/s,
   peak memory) and the device busy share of one profiled sample;
11. the reference's golden images (cornell_path, cornell_disney,
   spheres_disney) through ``render_path_progressive`` within twice the CPU
   tests' bounds; the white furnace (environment pixels exactly 0.5, the
   sphere within 4 % of 0.4); ``render_direct`` on the Cornell box at
   1080p with ``auto`` and ``brute``, finite and in agreement;
12. ``tests/test_torch_cuda.py`` in a subprocess (``--noconftest``): every
   test must pass, none skip.

Then one JSON line of per-kernel results, the nvidia-smi line, and the
result line ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result line. No phase catches its own failure.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda:0"
FRAME = (1920, 1080)
ATRIUM_TRIANGLES = 132778
N_CHECK = 65536  # rays per kernel-against-plain batch
BATCH_AGREE = 0.999  # share of rays whose kernel and plain results agree
# t tolerance where slots agree: T_REL relative, plus the f32 rounding bound
# of the two Plucker dot products (t_num, a) that kernel and plain version
# sum in another order, F32_DOT * (sum |t_num terms| + t * sum |a terms|) / |a|
# (2 sides x gamma_10). A short hit seen from a far origin cancels: on the
# main path's bounce waves that alone reaches ~3e-3 relative.
T_REL = 2.0 ** -12
F32_DOT = 20 * 2.0 ** -24
# parity bounds of tests/test_torch_slice.py, doubled here for GPU float
# order and FMA contraction (the test runs the CPU plain version)
PARITY_MEAN_REL = 2 * 0.02
PARITY_PIXEL_SHARE = 1.0 - 2 * 0.03
PARITY_RAYS_REL = 2 * 0.01
BENCH = dict(max_bounces=4, bsdf="disney", presample_lights=4096, coherent_tiles=16)
BINNED = dict(binned_secondary=8, binned_shadow=8)
# published peaks of one H100 SXM (NVIDIA data sheet): f32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
FLOP_PER_TEST = 80  # one ray-triangle test: 40 FMAs (a, u, v, t_num)
SLAB_RAYS = 16384  # rays per pass when counting needed triangle tests


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _timed(fn, reps: int = 1, warmup: bool = True):
    """(last result, mean ms) with CUDA events, after one warm-up call."""
    import torch

    out = fn() if warmup else None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def _bound(tests: int, nbytes: int):
    """(least ms, what bounds it): ``tests`` ray-triangle tests at the f32
    peak, or ``nbytes`` at the memory rate, whichever takes longer."""
    ops_ms = tests * FLOP_PER_TEST / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _needed_tri_tests(fat, o, d, bound, blocked=None):
    """Ray-triangle tests every front-to-back walk must make, whatever its
    schedule: for a closest hit, the triangles of every leaf whose slab the
    ray enters below ``bound`` (a leaf entered before the closest hit may
    hold a nearer one); for a ray known to be blocked (``blocked``), those
    of one such leaf, the smallest, since some entered leaf holds the
    blocker. The least work of a trace of this run's rays."""
    import torch
    from stratum_tpu_torch.ops import block_trace
    from stratum_tpu_torch.ops.packet import leaf_counts, safe_inv

    nv = leaf_counts(fat)
    lo, hi = fat.leaf_lo[None], fat.leaf_hi[None]
    total = 0
    for s in range(0, o.shape[0], SLAB_RAYS):
        sl = slice(s, s + SLAB_RAYS)
        tn, tf = block_trace._leaf_slab(lo, hi, o[sl, None], safe_inv(d[sl, None]))
        enter = (tn <= tf) & (tn < bound[sl, None])
        need = torch.where(enter, nv, 0).sum(dim=1)
        if blocked is not None:
            least = torch.where(enter, nv, nv.max()).amin(dim=1)
            need = torch.where(blocked[sl] & enter.any(dim=1), least, need)
        total += int(need.sum())
    return total


def _block_bytes(fat, prep, occluded: bool) -> int:
    """Bytes a block-trace launch must move: each input once (rays, t_max,
    origin, inverse direction, group and leaf boxes, leaf counts, and the
    features of the leaves' real triangles: the kernel builds its lists
    itself and never reads a padded slot), each output once."""
    L = fat.leaf_tri.shape[0]
    np_ = prep.rays.shape[0]
    ins = np_ * (10 + 1 + 3 + 3) * 4 + prep.group_lo.shape[0] * 24
    ins += L * (6 * 4 + 4) + int(prep.leaf_count.sum()) * 160
    return ins + np_ * (1 if occluded else 8)


def _check_lists(fat, o, d, bound, lists, gs):
    """The kernel's per-CTA lists (``launch(..., stats=...)``) against the
    plain list phase at block 128 over live rays, bit for bit: the counts,
    and where the kernel wrote them each CTA's sorted entries and groups.
    -> mean list length per CTA."""
    import torch
    from stratum_tpu_torch.ops import block_trace

    plain = block_trace.candidate_lists(fat, o, d, bound, gs, block_trace.CTA, live_only=True)
    n_cta = lists.ncand.numel()
    assert torch.equal(lists.ncand, plain.ncand[:n_cta]), int(
        (lists.ncand != plain.ncand[:n_cta]).sum())
    assert not bool(plain.ncand[n_cta:].any())
    if lists.centry is not None:
        assert torch.equal(lists.centry, plain.centry[:n_cta])
        assert torch.equal(lists.cand, plain.cand[:n_cta])
    return float(lists.ncand.float().mean())


def _compare_closest(fat, o, d, hk, hp, live=None):
    """Slot agreement of kernel vs plain over the live lanes (all when
    ``live`` is None); a differing slot at the same t (within T_REL) is a
    legitimate tie, not a disagreement. Where slots agree, the t error is
    held to the bound above (``t_err_ratio`` <= 1)."""
    import torch
    from stratum_tpu_torch.ops.mxu import ray_features

    if live is None:
        live = torch.ones_like(hk.slot, dtype=torch.bool)
    same = hk.slot == hp.slot
    both = (hk.slot >= 0) & (hp.slot >= 0)
    diff = torch.abs(hk.t - hp.t)
    rel = diff / torch.clamp(hp.t, min=1e-30)
    tie = both & ~same & (rel <= T_REL)
    ok = torch.nonzero(same & both).squeeze(1)
    ratio = 0.0
    if ok.numel():
        feat = fat.leaf_feat.view(-1, 10, 4)[hp.slot[ok].long()]
        terms = ray_features(o[ok], d[ok])[:, :, None] * feat  # [n, 10, (a, u, v, t)]
        mag = terms.abs().sum(dim=1)
        t = hp.t[ok]
        abs_a = terms[..., 0].sum(dim=1).abs()
        bound = T_REL * t + F32_DOT * (mag[:, 3] + t * mag[:, 0]) / abs_a
        ratio = float((diff[ok] / bound).max())
    n_live = int(live.sum())
    return dict(
        rays=int(hk.slot.numel()),
        live=n_live,
        slot_equal=float((same & live).sum()) / max(n_live, 1),
        agree=float(((same | tie) & live).sum()) / max(n_live, 1),
        t_rel_err=float(rel[ok].max()) if ok.numel() else 0.0,
        t_err_ratio=ratio,
        max_abs_err=float(diff[ok].max()) if ok.numel() else 0.0,
    )


def _check_closest(name, c, agree=BATCH_AGREE):
    print(f"    {name}: {c}")
    assert c["agree"] >= agree, (name, c)
    assert c["t_err_ratio"] <= 1.0, (name, c)


def _check_occluded(name, ok, op, live):
    """Agreement of kernel vs plain blocked flags over the live lanes (dead
    lanes, t_max = 0, are unblocked on both sides and counted in
    ``mismatch``)."""
    n_live = int(live.sum())
    mismatch = int((ok != op).sum())
    agree = float(((ok == op) & live).sum()) / max(n_live, 1)
    print(f"    {name}: rays {ok.numel()} live {n_live} blocked "
          f"{float(ok.float().mean()):.4f} agree {agree} mismatch {mismatch}")
    assert agree >= BATCH_AGREE, (name, agree)
    return dict(rays=int(ok.numel()), live=n_live, agree=agree, mismatch=mismatch)


def _words_record(words):
    """K5 words as a slot-mode record (slot -1 and t = inf on a miss)."""
    import torch
    from stratum_tpu_torch.ops import binned, block_trace

    t, slot = binned.unpack(words)
    hit = torch.isfinite(t)
    return block_trace._slot_record(t, torch.where(hit, slot, -1))


def _bounce_rays(scene, tile, lo, hi, o, d, h, rng):
    """Cosine-sampled bounce rays and shadow rays toward presampled lights
    (rows of ``tile``) from the block tracer's hits ``h`` of rays (o, d);
    misses become dead lanes -> ((o2, d2, t_max2), (o3, w3, t_max3))."""
    import numpy as np
    import torch
    from stratum_tpu_torch.core import math as smath
    from stratum_tpu_torch.ops import block_trace
    from stratum_tpu_torch.ops.intersect import T_MAX, ray_offset
    from stratum_tpu_torch.render import integrator
    from stratum_tpu_torch.render.shading import shading_point_from_row

    n, dev = o.shape[0], o.device
    hf = block_trace.finalize_hit(scene.slot_payload, o, d, h)
    sp = shading_point_from_row(hf.payload[:, :32], hf.tri, hf.bary, d)
    u = torch.from_numpy(rng.random((n, 2), dtype=np.float32)).to(dev)
    d2 = smath.to_world(smath.sample_cos_hemisphere(u[:, 0], u[:, 1]), sp.geom_normal)
    o2 = ray_offset(sp.position, sp.geom_normal)
    tm2 = torch.where(hf.hit, T_MAX, 0.0)
    idx = torch.from_numpy(rng.integers(0, tile.shape[0], n)).to(dev)
    ls = integrator.tile_row_sample(tile, idx)
    wi, dist, cos_l, _ = integrator.light_segment(ls, sp.position, o2, lo, hi)
    tm3 = torch.where(hf.hit & (cos_l > 0), dist, 0.0)
    return (o2, d2, tm2), (o2, wi, tm3)


def _zero_launches():
    from stratum_tpu_torch.ops import binned, block_trace

    for counts in (block_trace.LAUNCHES, binned.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _timed_samples(scene, view, cfg_run, label, scene_name, smi):
    """1 warm-up and 4 timed samples of ``render_path_with_counts`` with
    every launch counter zeroed just before and read just after ->
    (launches, last image, dict of ms/spp, Mrays/s, peak GiB, image mean)."""
    import torch
    from stratum_tpu_torch.ops import binned, block_trace
    from stratum_tpu_torch.render import integrator

    W, H = cfg_run.width, cfg_run.height
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    samples, times, total_rays = 5, [], 0
    for seed in range(samples):
        t0 = time.perf_counter()
        img, n = integrator.render_path_with_counts(scene, view, cfg_run, seed)
        n = int(n)  # synchronizes, like the reference bench's fetch
        torch.cuda.synchronize()
        if seed > 0:  # sample 0 is the warm-up
            times.append(time.perf_counter() - t0)
            total_rays += n
    launches = {f"block {k}": v for k, v in block_trace.LAUNCHES.items()}
    launches.update({f"binned {k}": v for k, v in binned.LAUNCHES.items()})
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    mean = float(img.mean())
    ms_spp = sum(times) / len(times) * 1e3
    mrays = total_rays / sum(times) / 1e6
    print(f"[{label}] {scene_name} {W}x{H} {cfg_run.max_bounces} bounces {cfg_run.bsdf} "
          f"({integrator.resolved_tracer(scene, cfg_run)}): "
          f"{ms_spp:.1f} ms/spp, {mrays:.3f} Mrays/s ({total_rays // len(times)} rays/spp), "
          f"launches/sample {{{', '.join(f'{k}: {v / samples}' for k, v in launches.items())}}}, "
          f"peak {peak_gib:.2f} GiB, image mean {mean:.6f} | {smi}", flush=True)
    assert bool(torch.isfinite(img).all()) and mean > 0
    assert total_rays // len(times) > W * H
    return launches, img, dict(ms_spp=ms_spp, mrays=mrays, peak_gib=peak_gib, mean=mean,
                               rays_per_sample=total_rays // len(times))


def _build():
    """Phase 2: every kernel source built by its own nvcc, all at once."""
    from stratum_tpu_torch.utils import cuda_build

    names = ("block_trace", "binned", "microbench")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(cuda_build.load, names))
    for name in names:
        ptxas = [ln.strip() for ln in cuda_build.BUILD_LOG.get(f"{name}.cu", "").splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[2 build] {name}.cu -> {cuda_build.library_path(name).name}; "
              f"ptxas: {' | '.join(ptxas)}", flush=True)
    print(f"[2 build] {len(names)} kernels in {time.perf_counter() - t0:.3f} s", flush=True)


EMIT_OPS = 27  # operations of one emission slab test (subtract, multiply, min, max, compare)


def _emission(fat, o, d, bound, g, pcap):
    """The emission kernel against the plain ``_emit`` on one wave, as
    ``bin_pairs`` pads it: count and slots bit for bit, both timed -> dict
    of both times, the largest |kernel - plain| over count and slots, the
    bound and the slab tests it counts."""
    import torch
    from stratum_tpu_torch.ops import binned, block_trace

    op, ip, tp = binned.pad_wave(o, d, bound, g)
    tmin = block_trace.T_MIN
    (ck, sk), ms = _timed(lambda: binned.emit_launch(fat, op, ip, tp, tmin, g, pcap, "ray"),
                          reps=3)
    (cp, sp), plain_ms = _timed(lambda: binned._emit(fat, op, ip, tp, tmin, g, pcap, "ray"),
                                warmup=False)
    err = max(int((ck - cp).abs().max()), int((sk - sp).abs().max()))
    rows = int(((ck != cp) | (sk != sp).any(dim=1)).sum())
    assert err == 0 and rows == 0, (err, rows)
    # the tests the kernel must make: each live ray against every 32-leaf
    # chunk box, and against every leaf of a chunk its own ray passes (a
    # ray that misses a chunk box misses its leaves), each ~EMIT_OPS
    # operations; all: each live ray against every leaf, with no chunk skip
    L = fat.num_leaves
    live = tp > 0
    clo, chi = block_trace.group_boxes(fat, 32)
    size = torch.bincount(torch.arange(L, device=op.device) // 32)
    need = 0
    for s in range(0, op.shape[0], 1 << 20):
        sl = slice(s, s + (1 << 20))
        keep = live[sl]
        hit = binned._slab_pass(clo, chi, op[sl][keep], ip[sl][keep], tp[sl][keep], tmin)
        need += int(keep.sum()) * clo.shape[0] + int((hit * size).sum())
    tests_all = int(live.sum()) * L
    # bytes: every ray's bound (a group with no live lane needs nothing
    # else), the origin and inverse direction of each live ray, the leaf
    # boxes, and count and slots written once
    nbytes = op.shape[0] * 4 + int(live.sum()) * 24 + L * 24 + ck.numel() * 4 + sk.numel() * 4
    ops_ms = need * EMIT_OPS / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    bound = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=float(err), rows_differ=rows,
                bound_ms=bound[0], bound_by=bound[1], nbytes=nbytes, tests=need,
                tests_all=tests_all, bound_all_ms=max(tests_all * EMIT_OPS / PEAK_F32_FLOPS * 1e3,
                                                      bytes_ms))


def _k5_work(fat, bins, info):
    """K5's work on one wave: the lanes of real pairs, the ones whose own ray
    passes the slab pretest of its bin's leaf, the triangle tests of each
    (a lane against its leaf's real triangles), the bytes the bin step
    needs, and the leaf stagings (a CTA's run of ``info["run_bins"]`` bins
    visits each of its leaves once per ``info["pass_lanes"]`` wanting lanes;
    ``info`` is ``binned.kernel_info("bin")``) beside the runs and bins ->
    dict."""
    import torch
    from stratum_tpu_torch.ops import binned, block_trace
    from stratum_tpu_torch.ops.packet import leaf_counts

    nv = leaf_counts(fat)
    run_bins, pass_lanes = info["run_bins"], info["pass_lanes"]
    ray, ok = binned.lane_rays(bins)
    leaf = bins.bin_leaf.repeat_interleave(binned.LANES)[ok].long()
    run = (torch.arange(ok.numel(), device=ok.device) // (run_bins * binned.LANES))[ok]
    ray = ray[ok].long()
    tn, tf = block_trace._leaf_slab(fat.leaf_lo[leaf], fat.leaf_hi[leaf], bins.origin[ray],
                                    bins.inv_dir[ray])
    want = (tn <= tf) & (tf >= bins.t_min) & (tn < bins.t_bound[ray])
    L = fat.num_leaves
    _, per_visit = torch.unique(run[want] * L + leaf[want], return_counts=True)
    # bytes, each input once: bin_leaf and pair_id; the origin, inverse
    # direction and bound of each ray in a real pair; the features of each
    # ray that passes a pretest; the box and count of each leaf the bins
    # hold; the real triangles' features of each leaf a lane passes; and
    # each ray's word
    nbins = bins.bin_leaf.numel()
    nbytes = (nbins * 4 + bins.pair_id.numel() * 4 + torch.unique(ray).numel() * 28
              + torch.unique(ray[want]).numel() * 40 + torch.unique(bins.bin_leaf).numel() * 28
              + int(nv[torch.unique(leaf[want])].sum()) * 160 + bins.n * 8)
    return dict(lanes=int(ok.sum()), lanes_want=int(want.sum()),
                tests_all=int(nv[leaf].sum()), tests=int(nv[leaf[want]].sum()), nbytes=nbytes,
                stagings=int(((per_visit + pass_lanes - 1) // pass_lanes).sum()),
                runs=-(-nbins // run_bins), bins=nbins)


def _binned_wave(fat, kind, o, d, t, stats, hb):
    """Phase 6 on one captured binned wave: the emission kernel against the
    plain ``_emit``, K5 against bin_min_plain on the wave's own bins, and the
    wrapper's result against the block kernel's (``hb``) on the lanes whose
    group dropped no pair."""
    import torch
    from stratum_tpu_torch.ops import binned, block_trace

    bound = t if kind == "closest" else t * block_trace.SHADOW_EPS
    bins = binned.bin_pairs(fat, o, d, bound)
    assert bins.stats == stats, (bins.stats, stats)
    em = _emission(fat, o, d, bound, bins.g, bins.pcap)
    words, ms = _timed(lambda: binned.launch(fat, bins, kind), reps=3)
    plain, plain_ms = _timed(lambda: binned.bin_min_plain(fat, bins), warmup=False)
    hk, hp = _words_record(words), _words_record(plain)
    c = _compare_closest(fat, o, d, hk, hp, (hk.slot >= 0) | (hp.slot >= 0))
    _check_closest(f"K5 {kind} vs plain", c)
    live = t > 0
    kept = live & ~bins.lost
    work = _k5_work(fat, bins, binned.kernel_info("bin"))
    bound_ms, bound_by = _bound(work["tests"], work["nbytes"])
    if kind == "closest":
        hn = binned.binned_closest(fat, o, d, t)
        cb = _compare_closest(fat, o, d, hn, hb, kept)
        _check_closest(f"binned {kind} vs block kernel, undropped lanes", cb, agree=1.0)
        vs_block = cb["agree"]
    else:
        # K2 tests stn < limit * |a|, K5 t = stn / |a| < limit: they may part
        # only where t rounds onto the limit
        blocked = hk.t < bound
        differ = (blocked != hb) & kept
        edge = differ & (torch.abs(hk.t - bound) <= T_REL * bound)
        vs_block = 1.0 - float(differ.sum()) / max(int(kept.sum()), 1)
        print(f"    binned occluded vs block kernel, undropped lanes: agree {vs_block} "
              f"(lanes that differ {int(differ.sum())}, on the limit {int(edge.sum())})")
        assert int((differ & ~edge).sum()) == 0
    share_lost = float((bins.lost & live).sum()) / max(int(live.sum()), 1)
    print(f"[6 binned waves] {kind} wave ({o.shape[0]} lanes, {int(live.sum())} live): "
          f"{bins.stats}, live lanes in groups that lost pairs {share_lost:.6f}; "
          f"emission kernel {em['ms']:.3f} ms (bound {em['bound_ms']:.3f} ms, {em['bound_by']}; "
          f"{em['tests']} slab tests, {em['tests_all']} without the chunk skip, bound "
          f"{em['bound_all_ms']:.3f} ms; {em['nbytes']} bytes), torch emission "
          f"{em['plain_ms']:.3f} ms, count and slots equal; K5 {ms:.3f} ms (bound "
          f"{bound_ms:.3f} ms, {bound_by}; {work['nbytes']} bytes; "
          f"{work['lanes']} lanes, {work['lanes_want']} past the pretest, {work['tests']} "
          f"tests, {work['tests_all']} for every lane; {work['stagings']} leaf stagings for "
          f"{work['runs']} runs of {work['bins']} bins), plain {plain_ms:.3f} ms", flush=True)
    return dict(c, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                lanes=work["lanes"], lanes_want=work["lanes_want"], tests=work["tests"],
                tests_all=work["tests_all"], stagings=work["stagings"], runs=work["runs"],
                stats=bins.stats, lost_share=share_lost, vs_block=vs_block, emit=em)


def _binned_sweep(fat, o, d, t, lanes: int = 1 << 17):
    """On the first ``lanes`` lanes of a closest wave, the emission kernel
    against ``_emit`` bit for bit in the modes ``RenderConfig.binned_em``
    selects, at group sizes of each of its code paths (one lane: g = 1; one
    warp: 32; across warps: 64, 128), pcap 3 and 32. The
    per-wave checks hold only the path's own g = 8, em = "ray"; the
    ``cuda``-marked test covers more but runs where JAX is installed ->
    (configurations, lanes)."""
    import torch
    from stratum_tpu_torch.ops import binned, block_trace

    o, d, t = o[:lanes], d[:lanes], t[:lanes]
    configs = 0
    for g in (1, 32, 64, 128):
        op, ip, tp = binned.pad_wave(o, d, t, g)
        for em in ("ray", "group"):
            for pcap in (3, 32):
                ck, sk = binned.emit_launch(fat, op, ip, tp, block_trace.T_MIN, g, pcap, em)
                cp, sp = binned._emit(fat, op, ip, tp, block_trace.T_MIN, g, pcap, em)
                assert torch.equal(ck, cp) and torch.equal(sk, sp), (g, em, pcap)
                configs += 1
    return configs, o.shape[0]


MB_ITERS = 8  # visits per kernel-against-plain comparison of T1-T3
# CTAs of a visit-per-SM timing: at most one per SM, and 20 per SM (the card
# full: more than can reside at once)
SM_CTAS = (("ms", 128), ("ms_full", 2640))
NONZERO = (-3.0, -2.0, -1.0, 1.0, 2.0, 3.0)


def _mb_check(name, kind, got, want, tol=None):
    """One T kernel-against-plain comparison: bit for bit on the integer
    set; on the normal set |got - want| <= tol on every output (equal
    values, inf included, differ by 0) -> (max |diff|, max |diff| / |want|,
    share of outputs that are equal)."""
    import torch

    if kind == "int":
        ok = torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert ok, (name, kind, int((got != want).sum()))
        return 0.0, 0.0, 1.0
    diff = torch.where(got == want, 0.0, (got.double() - want.double()).abs())
    bad = ~(diff <= tol)
    assert not bool(bad.any()), (name, kind, int(bad.sum()), float((diff / tol)[bad].max()))
    rel = diff / want.double().abs().clamp(min=1e-30)
    return float(diff.max()), float(rel.max()), float((diff == 0).float().mean())


def _per_sm(ms_visit: float, ctas: int) -> float:
    """ms of one visit on one SM from a grid's ms per visit of every CTA:
    the SMs share the CTAs out (132 SMs; below 132 CTAs each has one)."""
    return ms_visit * 132 / max(ctas, 132)


def _k1_visit(dev, leaves: int = 64, k: int = 256, real: int = 256):
    """K1's exact-f32 visit of one leaf of k slots, ``real`` of them holding
    triangles, by 128 lanes on one SM (at real = k the work a T1 visit at
    the same k does on tensor cores): K1 launches (group size 4) whose
    every ray enters every leaf (boxes around the origin; random-normal
    features, so some tests commit), over the CTA counts of SM_CTAS (128
    lanes each) -> ms per leaf visit and SM of each (each CTA's list phase
    included: 16 groups), beside the per-SM bound (80 flop a test at 1/132
    of the f32 peak; the leaves, 2.6 MB, stay in L2)."""
    import torch
    from stratum_tpu_torch.ops import block_trace
    from stratum_tpu_torch.ops.packet import FatBVH

    gen = torch.Generator(device="cpu").manual_seed(8)
    tri = torch.arange(leaves * k, dtype=torch.int32).view(leaves, k)
    filled = torch.arange(k) < real
    fat = FatBVH(
        leaf_lo=torch.full((leaves, 3), -1e3, device=dev),
        leaf_hi=torch.full((leaves, 3), 1e3, device=dev),
        leaf_feat=(torch.randn((leaves, k, 10, 4), generator=gen)
                   * filled[:, None, None]).to(dev),
        leaf_tri=torch.where(filled, tri, -1).to(dev))
    sm_ms = 128 * real * FLOP_PER_TEST / PEAK_F32_FLOPS * 132 * 1e3
    result = dict(bound_sm_ms=sm_ms, k=k, real=real, gs=block_trace.GS)
    for key, ctas in SM_CTAS:
        n = ctas * 128
        d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen), dim=1).to(dev)
        o = torch.zeros((n, 3), device=dev)
        prep = block_trace._prepare(fat, o, d, torch.full((n,), 3.0e38, device=dev))
        *_, lists = block_trace.launch(fat, prep, False, stats="ncand")
        assert bool((lists.ncand == leaves // block_trace.GS).all())
        _, ms = _timed(lambda: block_trace.launch(fat, prep, False), reps=5)
        result[key] = _per_sm(ms / leaves, ctas)
        print(f"[8 visit per SM] K1: {leaves} leaves of {k} slots ({real} real) per CTA, "
              f"{ctas} CTAs: {ms:.3f} ms, {result[key] * 1e3:.3f} us per leaf visit and SM "
              f"(bound {sm_ms * 1e3:.3f} us)", flush=True)
    return result


def _t1_visit(dev, k: int = 256, iters=(64, 256)):
    """T1 ``epi``'s visit of k rows by 128 lanes on one SM, timed as
    _k1_visit times K1: the commit-pipeline kernel over the CTA counts of
    SM_CTAS, each CTA with its own 128 lanes (the tool's uniform timing
    operands) and the same slab ring, marginal between two trip counts ->
    ms per visit and SM of each, beside the per-SM tensor-core bound."""
    import torch
    from stratum_tpu_torch import tools
    from stratum_tpu_torch.tools import perf_commit_pipeline as t1

    gen = torch.Generator(device="cpu").manual_seed(9)
    _, feat, word, _ = t1.operands("epi", k, 1, dev)
    sm_ms = 2 * 48 * 4 * k * t1.B / tools.PEAK_BF16_FLOPS * tools.SMS * 1e3
    result = dict(bound_sm_ms=sm_ms, k=k)
    for key, ctas in SM_CTAS:
        rays = (torch.rand((48, ctas * t1.B), generator=gen) * 0.5).to(dev, torch.bfloat16)
        ms = []
        for it in iters:
            n = torch.tensor([it], dtype=torch.int32, device=dev)
            ms.append(_timed(lambda: t1.run_inner(rays, feat, word, n, "epi", k, it), reps=3)[1])
        result[key] = _per_sm((ms[1] - ms[0]) / (iters[1] - iters[0]), ctas)
        print(f"[8 visit per SM] T1 epi: k={k}, {ctas} CTAs: {ms[1]:.3f} ms at {iters[1]} "
              f"visits, {result[key] * 1e3:.3f} us per visit and SM (bound "
              f"{sm_ms * 1e3:.3f} us)", flush=True)
    return result


def _microbench():
    """Phase 8: the tools' entry points (the slice's path), then T1-T4
    against their plain versions -> the kernels JSON entries."""
    import numpy as np
    import torch
    from stratum_tpu_torch import tools
    from stratum_tpu_torch.tools import bench_mxu_model as t4
    from stratum_tpu_torch.tools import perf_commit_pipeline as t1
    from stratum_tpu_torch.tools import perf_epilogue as t2
    from stratum_tpu_torch.tools import probe_mxu_loop as t3

    mods = {"T1": t1, "T2": t2, "T3": t3, "T4": t4}
    for m in mods.values():
        for key in m.LAUNCHES:
            m.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    runs = {}
    for name, mod, argv in (("T1", t1, []), ("T1 k=256", t1, ["--k=256"]),
                            ("T2", t2, []), ("T2 k=256", t2, ["--k=256"]),
                            ("T3", t3, []), ("T3 k=256", t3, ["--k=256"]), ("T4", t4, [])):
        print(f"[8 tools] {mod.__name__.rsplit('.', 1)[1]} {' '.join(argv)}", flush=True)
        runs[name] = mod.main(argv)
    launches = {name: sum(m.LAUNCHES.values()) for name, m in mods.items()}
    print(f"[8 tools] launches {launches} in {time.perf_counter() - t0:.1f} s", flush=True)
    assert all(v > 0 for v in launches.values()), launches

    dev = torch.device(DEVICE)
    bf16 = torch.bfloat16
    rng = np.random.default_rng(8)

    def vals(kind, shape, nonzero=False, scale=1.0):
        if kind == "int":
            x = rng.choice(NONZERO, shape) if nonzero else rng.integers(-3, 4, shape)
        else:
            x = rng.standard_normal(shape)
        return torch.from_numpy((x * scale).astype(np.float32)).to(dev)

    errs = {name: [0.0] for name in mods}
    rels = {name: [0.0] for name in mods}
    equal = {name: [1.0] for name in mods}

    def note(name, result):
        errs[name].append(result[0])
        rels[name].append(result[1])
        equal[name].append(result[2])

    word = torch.tensor([1, 0, 3, 1, 0, 1, 1, 2], dtype=torch.int32, device=dev)
    n = torch.tensor([MB_ITERS - 1], dtype=torch.int32, device=dev)
    for k in (1024, 256):
        for v in t1.VARIANTS:
            for kind in ("int", "normal"):
                scale = 2.0 ** 58 if v in ("bare", "classify") else 1.0
                rays = vals(kind, (48, t1.lanes_of(v)), scale=scale).to(bf16)
                feat = vals(kind, (t1.NL, 48, 4 * k), scale=scale).to(bf16)
                got = t1.run_inner(rays, feat, word, n, v, k, MB_ITERS)
                want = t1.run_inner_plain(rays, feat, word, n, v, k, MB_ITERS)
                if kind == "int":
                    note("T1", _mb_check(f"T1 {v} k={k}", kind, got, want))
                    continue
                # every lane's t within the bound, whether its slot is the
                # same or differs (a near-tie: the same t within the bound)
                tol = t1.tolerance(rays, feat, k, MB_ITERS, v, want)
                note("T1", _mb_check(f"T1 {v} k={k}", kind, got[0], want[0], tol))
        for v in ("epi", "epi_drain", "ring", "epi_w256"):  # 3 CTAs, each its own lanes
            rays = vals("int", (48, 3 * t1.lanes_of(v))).to(bf16)
            feat = vals("int", (t1.NL, 48, 4 * k)).to(bf16)
            note("T1", _mb_check(f"T1 {v} k={k} 3 CTAs", "int",
                                 t1.run_inner(rays, feat, word, n, v, k, MB_ITERS),
                                 t1.run_inner_plain(rays, feat, word, n, v, k, MB_ITERS)))
        for v in t2.VARIANTS:
            for kind in ("int", "normal"):
                kk = 512 if k == 1024 else k  # T2's default K is 512
                slab = vals(kind, (48, 4 * kk)).to(bf16)
                rays = vals(kind, (48, 256), nonzero=True).to(bf16)
                got = t2.run(slab, rays, v, kk, 256, MB_ITERS)
                want = t2.run_plain(slab, rays, v, kk, 256, MB_ITERS)
                note("T2", _mb_check(f"T2 {v} k={kk}", kind, got, want,
                                     t2.REL_TOL * want.abs()))
        for dep in (False, True):
            for kind in ("int", "normal"):
                rays = vals(kind, (48, t3.B), nonzero=True).to(bf16)
                feat = vals(kind, (t3.NL, 48, 4 * k)).to(bf16)
                got = t3.run(rays, feat, MB_ITERS, dep)
                want = t3.run_plain(rays, feat, MB_ITERS, dep)
                note("T3", _mb_check(f"T3 dep={dep} k={k}", kind, got, want,
                                     t3.tolerance(rays, feat, MB_ITERS)))
    for label, c, m, b, passes, reps in t4.CASES:
        for p in sorted({0, passes, 5}):
            for kind in ("int", "normal"):
                a = vals(kind, (c, m))
                bb = vals(kind, (c, b))
                bb = bb.abs() if kind == "int" else bb  # b >= 0: no b * fi + p cancels
                got = t4.run(a, bb, 4, p, reps)
                want = t4.run_plain(a, bb, 4, p, reps)
                note("T4", _mb_check(f"T4 {label} passes={p}", kind, got, want,
                                     t4.tolerance(a, bb, 4, p)))
    for name in mods:
        print(f"[8 kernel vs plain] {name}: {len(errs[name]) - 1} comparisons, integer sets "
              f"bit for bit, normal sets max |diff| {max(errs[name]):.3e} (relative "
              f"{max(rels[name]):.3e}), every output within its bound; least share of "
              f"equal outputs {min(equal[name]):.4f}", flush=True)

    # per-visit times (T4: per pass on the whole card) of the kernels, from
    # the tools' runs, beside the plain versions' and (T3/T4) one
    # torch.matmul of the same bf16 product, at the reference defaults and
    # (T1-T3) at k=256
    def bound(flops, nbytes):
        ops_ms = flops / tools.PEAK_BF16_FLOPS * 1e3
        bytes_ms = nbytes / tools.PEAK_BYTES_S * 1e3
        return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")

    def sm_bound(flops):
        """Least time of one visit on one SM: its flop at 1/132 of the
        tensor-core peak (the slabs come from L2, whose rate has no
        published figure, and are not counted)."""
        return flops / tools.PEAK_BF16_FLOPS * tools.SMS * 1e3

    def per_visit(fn, iters):
        return _timed(fn, warmup=False)[1] / iters

    def visit_times(name, k):
        """(ms, plain_ms, bound, per-SM bound, library_ms, extras) per visit."""
        if name == "T1":
            args = t1.operands("epi", k, MB_ITERS, dev)
            plain = per_visit(lambda: t1.run_inner_plain(*args, "epi", k, MB_ITERS), MB_ITERS)
            run = runs["T1" if k == 1024 else "T1 k=256"]
            flops = 2 * 48 * 4 * k * t1.B
            nbytes = (48 * t1.B * 2 + t1.NL * 48 * 4 * k * 2 + 2 * t1.B * 4) / 2048
            return (run["epi"]["ns_per_commit"] * 1e-6, plain, bound(flops, nbytes),
                    sm_bound(flops), None, {v: r["ns_per_commit"] for v, r in run.items()})
        if name == "T2":
            slab = vals("normal", (48, 4 * k)).to(bf16)
            rays = vals("normal", (48, 128)).to(bf16)
            plain = per_visit(lambda: t2.run_plain(slab, rays, "full", k, 128, MB_ITERS),
                              MB_ITERS)
            run = runs["T2" if k == 512 else "T2 k=256"]
            flops = 3 * 2 * 48 * 4 * k * 128  # the f32 product as three bf16 products
            nbytes = (48 * 4 * k * 2 + 48 * 128 * 2 + 128 * 4) / 64
            return (run["full"]["ns_per_exec"] * 1e-6, plain, bound(flops, nbytes),
                    sm_bound(flops), None, {v: r["ns_per_exec"] for v, r in run.items()})
        run = runs["T3" if k == 1024 else "T3 k=256"]
        lo, hi = t3.TRIPS[-2], t3.TRIPS[-1]
        rays = vals("normal", (48, t3.B)).to(bf16)
        feat = vals("normal", (t3.NL, 48, 4 * k)).to(bf16)
        plain = per_visit(lambda: t3.run_plain(rays, feat, MB_ITERS, False), MB_ITERS)
        lib = _timed(lambda: torch.matmul(feat[0].T, rays), reps=20)[1]
        flops = 2 * 48 * 4 * k * t3.B
        nbytes = (48 * t3.B * 2 + t3.NL * 48 * 4 * k * 2 + t3.B * 4) / hi
        return ((run[(0, hi)]["ms"] - run[(0, lo)]["ms"]) / (hi - lo), plain,
                bound(flops, nbytes), sm_bound(flops), lib,
                {"dep1_ms": (run[(1, hi)]["ms"] - run[(1, lo)]["ms"]) / (hi - lo),
                 "trips_ms": {f"dep={d} iters={i}": x["ms"] for (d, i), x in run.items()}})

    common = dict(route="cuda", source="stratum_tpu_torch/csrc/microbench.cu")
    entries = []
    for name, title, replaces, k_def, unit in (
            ("T1", "commit_pipeline, epi", "tools/perf_commit_pipeline.py:77", 1024,
             "per visit (one CTA), marginal between 512 and 2048 visits"),
            ("T2", "epilogue, full", "tools/perf_epilogue.py:106", 512,
             "per exec (one CTA of 128 lanes), 64 execs a call"),
            ("T3", "mxu_loop, dep=0", "tools/probe_mxu_loop.py:35", 1024,
             "per visit (one CTA), marginal between the last two trip counts")):
        ms, plain, (b_ms, b_by), b_sm, lib, extra = visit_times(name, k_def)
        ms2, plain2, (b2, _), b2_sm, lib2, extra2 = visit_times(name, 256)
        entries.append(dict(
            common, name=f"{title}, k={k_def} ({name})", replaces=replaces,
            launches=launches[name], max_abs_err=max(errs[name]),
            max_rel_err=max(rels[name]), equal_share=min(equal[name]), ms=ms, plain_ms=plain,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib, unit=unit,
            bound_sm_ms=b_sm, extra=extra, k256=dict(
                ms=ms2, plain_ms=plain2, bound_ms=b2, bound_sm_ms=b2_sm, library_ms=lib2,
                extra=extra2)))
    label, c, m, b, _, reps = t4.CASES[0]
    a = vals("normal", (c, m))
    bb = vals("normal", (c, b))
    p1 = per_visit(lambda: t4.run_plain(a, bb, 4, 1, reps), 4)
    p5 = per_visit(lambda: t4.run_plain(a, bb, 4, 5, reps), 4)
    a16, b16 = a.to(bf16), bb.to(bf16)
    lib = _timed(lambda: torch.matmul(a16.T, b16), reps=20)[1]
    b_ms, b_by = bound(2 * c * m * b, (c * m * 4 + c * b * 4 + m * b * 4) / (t4.ITERS * 5))
    entries.append(dict(
        common, name=f"mxu_model, {label} (T4)", replaces="tools/bench_mxu_model.py:35",
        launches=launches["T4"], max_abs_err=max(errs["T4"]), max_rel_err=max(rels["T4"]),
        equal_share=min(equal["T4"]), ms=runs["T4"][label]["ns_per_pass"] * 1e-6,
        plain_ms=(p5 - p1) / 4, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        unit="per pass, whole card (slope of passes 1 -> 5)",
        extra={lb: dict(ns_per_pass=r["ns_per_pass"], ctas=r["ctas"])
               for lb, r in runs["T4"].items()}))
    per_sm = entries[0]["visit_per_sm"] = dict(
        T1=_t1_visit(dev), K1=_k1_visit(dev), K1_real21=_k1_visit(dev, real=21))
    print("[8 visit per SM] T1 epi / K1 at k=256: " + ", ".join(
        f"{ctas} CTAs {per_sm['T1'][key] / per_sm['K1'][key]:.3f}" for key, ctas in SM_CTAS),
        flush=True)
    for e in entries:
        sm = f", per SM {e['bound_sm_ms'] * 1e6:.1f} ns" if "bound_sm_ms" in e else ""
        lib = "none" if e["library_ms"] is None else f"{e['library_ms'] * 1e6:.1f} ns"
        print(f"[8 timing] {e['name']}: {e['ms'] * 1e6:.1f} ns {e['unit']}; bound "
              f"{e['bound_ms'] * 1e6:.2f} ns ({e['bound_by']}){sm}; plain "
              f"{e['plain_ms'] * 1e6:.1f} ns; library {lib}", flush=True)
        if "k256" in e:
            x = e["k256"]
            print(f"[8 timing]   at k=256: {x['ms'] * 1e6:.1f} ns, per-SM bound "
                  f"{x['bound_sm_ms'] * 1e6:.1f} ns, plain {x['plain_ms'] * 1e6:.1f} ns",
                  flush=True)
    return entries

# ---- phases 9-12 -----------------------------------------------------------------

# a synthetic atrium past both shared-memory budgets: 1,836,000 triangles in
# ~10,400 SAH leaves (the atrium's ~176 triangles a leaf), so at gs = 1 a
# CTA's list needs 16,384 keys (> MAX_LIST_KEYS) and the emission's boxes at
# g = 8, pcap = 16 more than 227 KB
BIG_ATRIUM = dict(columns=6, stacks=88, slices=176)
BIG_LEAVES = (10000, 12000)  # the leaf count asked of it
BIG_FRAME = (512, 288)  # camera rays of the past-the-budget waves
CORNELL = dict(max_bounces=4, presample_lights=4096)  # bench.py's cornell_e2e cfg2
EDGE = 1e-4  # barycentric margin of a non-degenerate hit
F64_REL = 1e-5  # dense product against float64, relative to its magnitude (TF32: ~1e-3)
GOLDENS = {  # tests/update_goldens.py:41-52 (48x48, rr_depth=100)
    "cornell_path": ("cornell_box", {}, 16, dict(max_bounces=3)),
    "cornell_disney": ("cornell_box", {}, 16, dict(max_bounces=3, bsdf="disney")),
    "spheres_disney": ("material_spheres", dict(stacks=12, slices=24), 8,
                       dict(max_bounces=4, bsdf="disney")),
}
FURNACE_REL = 0.04  # sphere mean against albedo x radiance (tests/test_torch_dense_path.py)
DIRECT_MEAN_REL = 1e-3  # render_direct, auto (mxu) against brute
DIRECT_PIXEL_SHARE = 0.999
GPU_TESTS = 10  # tests in tests/test_torch_cuda.py


def _modes_equal(fat, o, d, bound, occluded, gs):
    """The forced global list mode against the default (shared) mode on one
    wave: outputs and per-CTA lists bit for bit, both timed -> dict."""
    import torch
    from stratum_tpu_torch.ops import block_trace

    prep = block_trace._prepare(fat, o, d, bound, gs)
    _, ms = _timed(lambda: block_trace.launch(fat, prep, occluded), reps=3)
    _, ms_g = _timed(lambda: block_trace.launch(fat, prep, occluded, list_mode="global"), reps=3)
    want = block_trace.launch(fat, prep, occluded, stats="lists")
    got = block_trace.launch(fat, prep, occluded, stats="lists", list_mode="global")
    for a, b in zip(got[:-1] + tuple(got[-1]), want[:-1] + tuple(want[-1])):
        assert torch.equal(a, b), (occluded, gs)
    G = prep.group_lo.shape[0]
    n_cta = prep.rays.shape[0] // block_trace.CTA
    return dict(gs=gs, ms_shared=ms, ms_global=ms_g, groups=G,
                shared_bytes=8 * block_trace.list_keys(G),
                scratch_bytes=8 * block_trace.list_keys(G)
                * block_trace.list_scratch_ctas(G, n_cta))


def _tiles_equal(fat, o, d, bound, g=8, pcap=16):
    """The forced tiled emission against the default on one wave, both
    emission modes, count and slots bit for bit, timed -> dict."""
    import torch
    from stratum_tpu_torch.ops import binned, block_trace

    op, ip, tp = binned.pad_wave(o, d, bound, g)
    out = {}
    for em in ("ray", "group"):
        (c0, s0), ms = _timed(lambda: binned.emit_launch(
            fat, op, ip, tp, block_trace.T_MIN, g, pcap, em), reps=3)
        (c1, s1), ms_t = _timed(lambda: binned.emit_launch(
            fat, op, ip, tp, block_trace.T_MIN, g, pcap, em, "tiled"), reps=3)
        assert torch.equal(c0, c1) and torch.equal(s0, s1), em
        out[em] = dict(ms=ms, ms_tiled=ms_t)
    L = fat.num_leaves
    tile = binned.emit_tile_leaves(L, g, pcap, "tiled")
    return dict(out, tile_leaves=tile, tiles=-(-L // tile),
                smem=binned.emit_smem(L, g, pcap), smem_tiled=binned.emit_smem(tile, g, pcap))


def _past_budgets(dev, atrium, atrium_waves, rng):
    """Phase 9: a synthetic atrium past both shared-memory budgets. On its
    camera wave and a shadow wave from its hits, at gs = 1: K3 against the
    plain walk, its per-CTA lists (global mode) bit for bit against
    ``candidate_lists(..., block=128, live_only=True)``, the emission kernel
    (tiled) against ``_emit`` bit for bit; then, on the full atrium, the
    forced global list mode and the forced tiled emission against the
    default modes, bit for bit -> dict of results."""
    import numpy as np
    import torch
    from stratum_tpu_torch.ops import binned, block_trace
    from stratum_tpu_torch.ops.intersect import T_MAX
    from stratum_tpu_torch.render import camera, integrator
    from stratum_tpu_torch.scene import builtin, flatten

    t0 = time.perf_counter()
    g = builtin.atrium(**BIG_ATRIUM)
    big, stats = flatten.flatten(g.root, device=dev)
    fat = big.fat_bvh
    L = fat.num_leaves
    keys, tile = block_trace.list_keys(L), binned.emit_tile_leaves(L, 8, 16)
    print(f"[9 past the budgets] atrium {BIG_ATRIUM}: {stats.num_triangles} triangles, "
          f"{L} leaves, built in {time.perf_counter() - t0:.2f} s; gs=1 lists of {keys} keys "
          f"({block_trace.resolve_list_mode(L)} mode; shared memory holds "
          f"{block_trace.MAX_LIST_KEYS}); emission boxes of all leaves "
          f"{binned.emit_smem(L, 8, 16)} B > {binned.EMIT_SMEM_BUDGET} B: tiles of {tile} "
          f"leaves ({binned.emit_smem(tile, 8, 16)} B)", flush=True)
    assert BIG_LEAVES[0] <= L <= BIG_LEAVES[1], L
    assert block_trace.resolve_list_mode(L) == "global" and tile < L
    for occluded in (False, True):
        print(f"[9 kernel] block_trace_kernel<{str(occluded).lower()}, global lists> at "
              f"gs=1 (G={L}): {block_trace.kernel_info(occluded, L, 'global')}", flush=True)
    print(f"[9 kernel] binned_emit_kernel (g=8, pcap=16) at {L} leaves: "
          f"{binned.kernel_info('emit', L)}", flush=True)
    W, H = BIG_FRAME
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, W, H, device=dev)
    px, py = camera.pixel_grid_tiled(W, H, *camera.tile_dims(W, H), dev)
    jitter = torch.from_numpy(rng.random((W * H, 2), dtype=np.float32)).to(dev)
    o, d = camera.generate_rays(view, px, py, jitter, W, H)
    o, tm = o.contiguous(), torch.full((W * H,), T_MAX, device=dev)
    lo, hi = big.geo.positions.amin(dim=0), big.geo.positions.amax(dim=0)
    cfg = integrator.RenderConfig(width=W, height=H, **BENCH)
    rows = integrator.light_tile_for(big, cfg, 0, lo, hi)
    res = {}
    hk = None
    for occluded in (False, True):
        if occluded:
            _, (o, d, tm) = _bounce_rays(big, rows, lo, hi, o, d, hk, rng)
        bound = tm * block_trace.SHADOW_EPS if occluded else tm
        kind = "occluded" if occluded else "closest"
        prep = block_trace._prepare(fat, o, d, bound, gs=1)
        _, ms = _timed(lambda: block_trace.launch(fat, prep, occluded), reps=3)
        *_, lists = block_trace.launch(fat, prep, occluded, stats="lists")
        per_cta = _check_lists(fat, o, d, bound, lists, 1)
        prep4 = block_trace._prepare(fat, o, d, bound)
        _, ms4 = _timed(lambda: block_trace.launch(fat, prep4, occluded), reps=3)
        if occluded:
            ok = block_trace.block_occluded(fat, o, d, tm, gs=1)
            op, plain_ms = _timed(lambda: block_trace.block_occluded_plain(fat, o, d, tm),
                                  warmup=False)
            agree = _check_occluded("K3 occluded (global lists) vs plain", ok, op, tm > 0)
        else:
            hk = block_trace.block_closest(fat, o, d, tm, gs=1)
            hp, plain_ms = _timed(lambda: block_trace.block_closest_plain(fat, o, d, tm),
                                  warmup=False)
            agree = _compare_closest(fat, o, d, hk, hp, tm > 0)
            _check_closest("K3 closest (global lists) vs plain", agree)
        em = _emission(fat, o, d, bound, 8, 16)
        G = prep.group_lo.shape[0]
        n_cta = prep.rays.shape[0] // block_trace.CTA
        scratch = 8 * keys * block_trace.list_scratch_ctas(G, n_cta)
        print(f"[9 past the budgets] {kind} wave ({o.shape[0]} lanes, {int((tm > 0).sum())} "
              f"live): K3 with global lists {ms:.3f} ms ({n_cta} CTAs, scratch {scratch} B, "
              f"lists equal to the plain list phase, {per_cta:.2f} groups per CTA), K1/K2 at "
              f"gs=4 with shared lists {ms4:.3f} ms ({8 * block_trace.list_keys(prep4.group_lo.shape[0])} "
              f"B of keys a CTA), plain {plain_ms:.3f} ms; tiled emission {em['ms']:.3f} ms "
              f"(bound {em['bound_ms']:.3f} ms, {em['bound_by']}), torch emission "
              f"{em['plain_ms']:.3f} ms, count and slots equal", flush=True)
        res[kind] = dict(agree, ms_global=ms, ms_gs4_shared=ms4, plain_ms=plain_ms,
                         ncand_cta=per_cta, scratch_bytes=scratch, ctas=n_cta,
                         emit=dict(ms=em["ms"], plain_ms=em["plain_ms"],
                                   bound_ms=em["bound_ms"], bound_by=em["bound_by"]))
    res.update(leaves=L, triangles=stats.num_triangles, list_keys=keys, emit_tile=tile,
               emit_smem_all=binned.emit_smem(L, 8, 16),
               emit_smem_tiled=binned.emit_smem(tile, 8, 16))
    del big, fat, prep, prep4, lists
    torch.cuda.empty_cache()

    # the full atrium: forced modes against the defaults
    fat = atrium.fat_bvh
    forced = {}
    for kind, (o, d, bound) in atrium_waves.items():
        occluded = kind == "occluded"
        forced[kind] = [_modes_equal(fat, o, d, bound, occluded, gs) for gs in (4, 1)]
        forced[kind + " emission"] = _tiles_equal(fat, o, d, bound)
        for m in forced[kind]:
            print(f"[9 forced modes] atrium {kind} wave ({o.shape[0]} lanes) gs={m['gs']}: "
                  f"shared lists {m['ms_shared']:.3f} ms ({m['shared_bytes']} B), forced "
                  f"global {m['ms_global']:.3f} ms (scratch {m['scratch_bytes']} B), results "
                  f"and lists equal", flush=True)
        e = forced[kind + " emission"]
        print(f"[9 forced modes] atrium {kind} wave emission (g=8, pcap=16): "
              + ", ".join(f"em={em} one tile {e[em]['ms']:.3f} ms, {e['tiles']} tiles of "
                          f"{e['tile_leaves']} {e[em]['ms_tiled']:.3f} ms" for em in ("ray", "group"))
              + f" ({e['smem']} / {e['smem_tiled']} B); count and slots equal", flush=True)
    res["atrium_forced"] = forced
    return res


def _dense_checks(scene, o, d, tm):
    """One primary wave of the Cornell path: the dense tracer against
    ``intersect_brute_force`` (the same tri on non-degenerate rays, t within
    T_REL) and its product against a float64 product -> dict."""
    import torch
    from stratum_tpu_torch.ops import intersect, mxu

    hm = mxu.intersect_mxu(o, d, scene.tri_features, t_max=tm)
    hb = intersect.intersect_brute_force(o, d, scene.geo.positions, scene.geo.indices, t_max=tm)
    w = 1.0 - hb.bary.sum(dim=1)
    clean = (hb.tri >= 0) & (hb.bary.amin(dim=1) > EDGE) & (w > EDGE)
    rel = (hm.t - hb.t).abs() / hb.t.clamp(min=1e-30)
    # a tie: two (coplanar) triangles at the same t, either may win
    tie = (hm.tri != hb.tri) & (hm.tri >= 0) & (hb.tri >= 0) & (rel <= T_REL)
    agree = float(((hm.tri == hb.tri) | tie).float().mean())
    assert agree >= BATCH_AGREE, agree
    assert not bool((clean & (hm.tri != hb.tri) & ~tie).any())
    assert int((clean & tie).sum()) <= 0.005 * int(clean.sum())
    t_rel = float(rel[clean].max())
    assert t_rel <= T_REL, t_rel
    n = min(o.shape[0], mxu.RAY_CHUNK)
    rays = mxu.ray_features(o[:n], d[:n])
    feat = scene.tri_features
    c = feat.shape[0]
    q = torch.stack(mxu._chunk_quants(rays, feat), dim=-1)  # a, u, v, t (u, v, t divided)
    f64 = (rays.double() @ feat.double().permute(1, 0, 2).reshape(10, c * 4)).view(n, c, 4)
    mag = (rays.double().abs() @ feat.double().abs().permute(1, 0, 2).reshape(10, c * 4))
    a_ratio = float(((q[..., 0].double() - f64[..., 0]).abs()
                     / (F64_REL * mag.view(n, c, 4)[..., 0]).clamp(min=1e-30)).max())
    assert a_ratio <= 1.0, a_ratio
    return dict(rays=o.shape[0], clean=int(clean.sum()), ties=int(tie.sum()), agree=agree,
                tri_equal_clean=float((hm.tri == hb.tri)[clean].float().mean()),
                t_rel_err=t_rel, f64_err_ratio=a_ratio)


def _cornell(dev, smi):
    """Phase 10: the Cornell path at full width, ``render_path_with_counts``
    at 1920x1080 with bench.py's cornell_e2e configuration -> dict."""
    import torch
    from stratum_tpu_torch import profile_sample
    from stratum_tpu_torch.render import camera, integrator
    from stratum_tpu_torch.scene import builtin, flatten

    g = builtin.cornell_box()
    scene, stats = flatten.flatten(g.root, device=dev)
    W, H = FRAME
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, W, H, device=dev)
    cfg = integrator.RenderConfig(width=W, height=H, **CORNELL)
    tracer = integrator.resolved_tracer(scene, cfg)
    assert tracer == "mxu", tracer
    waves = {}
    integrator.render_path_with_counts(scene, view, cfg, 0, capture=waves)
    # every bounce traces its own shadow wave: no deferred wave on a dense tracer
    assert [w[0].shape[0] for w in waves["closest"]] == [W * H] * (cfg.max_bounces + 1)
    assert [w[0].shape[0] for w in waves["occluded"]] == [W * H] * (cfg.max_bounces + 1)
    checks = _dense_checks(scene, *waves["closest"][0])
    print(f"[10 cornell] {stats.num_triangles} triangles ({scene.geo.num_triangles} padded): "
          f"tracer {tracer}, {len(waves['closest'])} closest and {len(waves['occluded'])} "
          f"per-bounce shadow waves of {W * H} lanes; primary wave vs intersect_brute_force: "
          f"{checks}", flush=True)
    del waves
    launches, img, line = _timed_samples(scene, view, cfg, "10 cornell path", "cornell", smi)
    assert not any(launches.values()), launches  # the dense path launches no kernel
    busy, ops = profile_sample.device_profile(scene, view, cfg, 1)
    line.update(checks=checks, tracer=tracer, device_busy_ms=busy,
                busy_share=None if busy is None else busy / line["ms_spp"],
                top_ops_ms=ops[:4])
    share = ("not measured: the profiler recorded no device events" if busy is None
             else f"{busy:.3f} ms of a {line['ms_spp']:.1f} ms sample, "
                  f"{100 * busy / line['ms_spp']:.1f} %")
    print(f"[10 cornell] device busy {share}; top ops "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ops[:4]), flush=True)
    return scene, view, line


def _parity(img, ref):
    """(mean relative difference, share of pixels within 1e-3) of an image
    against a reference, asserted within the doubled CPU-test bounds."""
    import numpy as np

    mean_rel = abs(img.mean() - ref.mean()) / ref.mean()
    pix = float(np.all(np.abs(img - ref) <= 1e-3 * (1 + np.abs(ref)), axis=-1).mean())
    assert np.isfinite(img).all() and mean_rel <= PARITY_MEAN_REL and pix >= PARITY_PIXEL_SHARE
    return float(mean_rel), pix


def _goldens(dev, cornell_scene, cornell_view):
    """Phase 11: the reference's golden images through
    ``render_path_progressive``, the white furnace, and ``render_direct``
    on the Cornell box at 1080p with ``auto`` and ``brute`` -> dict."""
    import numpy as np
    import torch
    from stratum_tpu_torch.render import camera, integrator
    from stratum_tpu_torch.scene import builtin, flatten

    out = {}
    for name, (scene_fn, kw, spp, cfg_kw) in GOLDENS.items():
        g = getattr(builtin, scene_fn)(**kw)
        scene, _ = flatten.flatten(g.root, device=dev)
        node, cam = flatten.find_camera(g.root)
        view = camera.make_view(node.to_world(), cam.fovy, 48, 48, device=dev)
        cfg = integrator.RenderConfig(width=48, height=48, rr_depth=100, **cfg_kw)
        img = integrator.render_path_progressive(scene, view, cfg, spp).cpu().numpy()
        ref = np.load(ROOT / "tests" / "golden" / f"{name}.npy")
        mean_rel, pix = _parity(img, ref)
        out[name] = dict(mean=float(img.mean()), ref_mean=float(ref.mean()), mean_rel=mean_rel,
                         pixels=pix)
        print(f"[11 goldens] {name} ({integrator.resolved_tracer(scene, cfg)}, {spp} spp): "
              f"mean {img.mean():.6f} vs {ref.mean():.6f} (rel {mean_rel:.2e}), pixels "
              f"agreeing {pix:.4f}", flush=True)
    g = builtin.furnace()
    scene, _ = flatten.flatten(g.root, device=dev)
    node, cam = flatten.find_camera(g.root)
    n = 128
    view = camera.make_view(node.to_world(), cam.fovy, n, n, device=dev)
    img = integrator.render_path_progressive(
        scene, view, integrator.RenderConfig(width=n, height=n, max_bounces=4), 16).cpu().numpy()
    px, py = np.meshgrid(np.arange(n) + 0.5, np.arange(n) + 0.5)
    tan = np.hypot(px - n / 2, py - n / 2) / (n / 2) * np.tan(np.radians(22.5))
    env, sphere = tan > 0.3, tan < 0.2  # the sphere subtends tan(asin(1 / 4)) = 0.258
    sphere_mean = float(img[sphere].mean())
    print(f"[11 furnace] {n}x{n}, 16 spp: environment pixels all 0.5: "
          f"{bool(np.all(img[env] == np.float32(0.5)))}; sphere mean {sphere_mean:.6f} "
          f"(albedo x radiance 0.4, bound {FURNACE_REL:.0%})", flush=True)
    assert np.all(img[env] == np.float32(0.5))
    assert abs(sphere_mean - 0.4) <= FURNACE_REL * 0.4
    out["furnace"] = dict(sphere_mean=sphere_mean, env_exact=True)
    W, H = FRAME
    imgs = {}
    for tracer in ("auto", "brute"):
        cfg = integrator.RenderConfig(width=W, height=H, tracer=tracer)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs[tracer] = integrator.render_direct(cornell_scene, cornell_view, cfg, 0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        assert bool(torch.isfinite(imgs[tracer]).all())
        out[f"direct_{tracer}_ms"] = ms
    a, b = imgs["auto"].cpu().numpy(), imgs["brute"].cpu().numpy()
    mean_rel = abs(a.mean() - b.mean()) / b.mean()
    pix = float(np.all(np.abs(a - b) <= 1e-3 * (1 + np.abs(b)), axis=-1).mean())
    print(f"[11 direct] cornell {W}x{H} render_direct: auto (mxu) {out['direct_auto_ms']:.1f} ms, "
          f"brute {out['direct_brute_ms']:.1f} ms; means {a.mean():.6f} / {b.mean():.6f} "
          f"(rel {mean_rel:.2e}), pixels agreeing {pix:.6f}", flush=True)
    assert mean_rel <= DIRECT_MEAN_REL and pix >= DIRECT_PIXEL_SHARE
    out["direct"] = dict(mean_rel=float(mean_rel), pixels=pix)
    return out


def _gpu_tests():
    """Phase 12: tests/test_torch_cuda.py in a subprocess (no conftest: the
    card has no JAX); every test must pass, none skip."""
    import re

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
         "tests/test_torch_cuda.py", "-m", "cuda", "-q"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
    )
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    print(f"[12 gpu tests] rc {proc.returncode}: {last} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    counts = {k: int(v) for v, k in re.findall(r"(\d+) (passed|failed|skipped|errors?)", last)}
    assert proc.returncode == 0 and counts == {"passed": GPU_TESTS}, (counts, proc.stdout[-3000:])
    return counts


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from stratum_tpu_torch.ops import binned, block_trace
    from stratum_tpu_torch.ops.intersect import T_MAX
    from stratum_tpu_torch.render import camera, integrator
    from stratum_tpu_torch.scene import builtin, flatten

    dev = torch.device(DEVICE)
    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {smi} | {kind} x{torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- 2: build ---------------------------------------------------------
    _build()

    # ---- scene --------------------------------------------------------------
    t0 = time.perf_counter()
    g = builtin.atrium()
    scene, stats = flatten.flatten(g.root, device=dev)
    fat = scene.fat_bvh
    L, K = fat.leaf_tri.shape
    print(f"[scene] atrium {stats.num_triangles} triangles, {L} leaves of {K}, "
          f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    assert stats.num_triangles == ATRIUM_TRIANGLES, stats

    # ---- 3: kernel against plain version ----------------------------------
    W, H = FRAME
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, W, H, device=dev)
    rng = np.random.default_rng(0)
    px, py = camera.pixel_grid_tiled(W, H, *camera.tile_dims(W, H), dev)
    jitter = torch.from_numpy(rng.random((W * H, 2), dtype=np.float32)).to(dev)
    o_full, d_full = camera.generate_rays(view, px, py, jitter, W, H)
    o_full = o_full.contiguous()
    cfg = integrator.RenderConfig(width=W, height=H, **BENCH)
    lo, hi = scene.geo.positions.amin(dim=0), scene.geo.positions.amax(dim=0)
    tile = integrator.light_tile_for(scene, cfg, 0, lo, hi)

    sel = torch.from_numpy(np.sort(rng.choice(W * H, N_CHECK, replace=False))).to(dev)
    o1, d1 = o_full[sel], d_full[sel]
    hk1 = block_trace.block_closest(fat, o1, d1)
    hp1 = block_trace.block_closest_plain(fat, o1, d1)
    (o2, d2, tm2), (o3, w3, tm3) = _bounce_rays(scene, tile, lo, hi, o1, d1, hk1, rng)
    hk2 = block_trace.block_closest(fat, o2, d2, tm2)
    hp2 = block_trace.block_closest_plain(fat, o2, d2, tm2)
    ok3 = block_trace.block_occluded(fat, o3, w3, tm3)
    op3 = block_trace.block_occluded_plain(fat, o3, w3, tm3)
    print(f"[3 kernel vs plain] {N_CHECK}-ray batches on the full atrium", flush=True)
    c1 = _compare_closest(fat, o1, d1, hk1, hp1)
    _check_closest("closest primary", c1)
    c2 = _compare_closest(fat, o2, d2, hk2, hp2, tm2 > 0)
    _check_closest("closest secondary", c2)
    _check_occluded("occluded shadow", ok3, op3, tm3 > 0)
    assert block_trace.LAUNCHES["closest"] >= 2 and block_trace.LAUNCHES["occluded"] >= 1

    # the main path's own waves: one sample's five closest waves (the
    # unsorted primary peel, then four sorted bounces with dead lanes) and
    # its one deferred shadow wave of 5 x W x H lanes, as the wrappers get them
    waves = {}
    integrator.render_path_with_counts(scene, view, cfg, 0, capture=waves)

    def list_lengths(o, d, bound, prep, occluded, check=None):
        """Mean list length per CTA the kernel reports (held to the plain
        list phase when ``check`` names the stats to compare), beside the
        reference's mean per 2048-ray block."""
        *_, lists = block_trace.launch(fat, prep, occluded, stats=check or "ncand")
        per_cta = (_check_lists(fat, o, d, bound, lists, prep.gs) if check
                   else float(lists.ncand.float().mean()))
        old = block_trace.candidate_lists(fat, o, d, bound, prep.gs)
        return per_cta, float(old.ncand.float().mean())

    for occl in (False, True):
        for gs_ in (block_trace.GS, 1):
            info = block_trace.kernel_info(occl, -(-L // gs_))
            print(f"[3 kernel] block_trace_kernel<{str(occl).lower()}> at gs={gs_} "
                  f"(G={-(-L // gs_)}): {info}", flush=True)
    closest_waves = []
    for i, (o, d, tm) in enumerate(waves["closest"]):
        prep = block_trace._prepare(fat, o, d, tm)
        _, ms = _timed(lambda: block_trace.launch(fat, prep, False), reps=3)
        hk, wrap_ms = _timed(lambda: block_trace.block_closest(fat, o, d, tm))
        hp, plain_ms = _timed(
            lambda: block_trace.block_closest_plain(fat, o, d, tm), warmup=False)
        c = _compare_closest(fat, o, d, hk, hp, tm > 0)
        tests = _needed_tri_tests(fat, o, d, torch.where(hk.slot >= 0, hk.t, tm))
        bound_ms, bound_by = _bound(tests, _block_bytes(fat, prep, False))
        per_cta, per_block = list_lengths(o, d, tm, prep, False, "lists" if i == 1 else None)
        print(f"[3 main-path waves] closest wave {i} ({c['rays']} lanes, {c['live']} live): "
              f"kernel {ms:.3f} ms (bound {bound_ms:.3f} ms, {bound_by}; {tests} tests), "
              f"wrapper (prep + kernel) {wrap_ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"candidate groups per CTA {per_cta:.2f} (per 2048-ray block {per_block:.2f})"
              + ("; per-CTA counts, entries and groups equal to the plain list phase"
                 if i == 1 else ""), flush=True)
        _check_closest(f"closest wave {i}", c)
        closest_waves.append(dict(c, ms=ms, wrapper_ms=wrap_ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by, tests=tests,
                                  ncand_cta=per_cta, ncand_block=per_block))
        if i == 1:  # the heaviest sorted bounce: kept for K3
            wave1 = (o, d, tm, hp)
        del prep, hk, hp
    ((o, w, t),) = waves["occluded"]
    limit = t * block_trace.SHADOW_EPS
    prep = block_trace._prepare(fat, o, w, limit)
    _, ms_o = _timed(lambda: block_trace.launch(fat, prep, True), reps=3)
    ok, wrap_ms_o = _timed(lambda: block_trace.block_occluded(fat, o, w, t))
    op, plain_ms_o = _timed(
        lambda: block_trace.block_occluded_plain(fat, o, w, t), warmup=False)
    tests_o = _needed_tri_tests(fat, o, w, limit, blocked=ok)
    bound_o = _bound(tests_o, _block_bytes(fat, prep, True))
    per_cta_o, per_block_o = list_lengths(o, w, limit, prep, True, "ncand")
    print(f"[3 main-path waves] deferred shadow wave ({t.numel()} lanes, "
          f"{int((t > 0).sum())} live): kernel {ms_o:.3f} ms (bound {bound_o[0]:.3f} ms, "
          f"{bound_o[1]}; {tests_o} tests), wrapper (prep + kernel) "
          f"{wrap_ms_o:.3f} ms, plain {plain_ms_o:.3f} ms, candidate groups per CTA "
          f"{per_cta_o:.2f} (per 2048-ray block {per_block_o:.2f}); per-CTA counts equal "
          f"to the plain list phase", flush=True)
    occ = _check_occluded("occluded deferred wave", ok, op, t > 0)
    del prep, ok

    # K3: the same kernel over single-leaf candidate lists (gs = 1)
    o1w, d1w, tm1w, hp1w = wave1
    prep = block_trace._prepare(fat, o1w, d1w, tm1w, gs=1)
    _, ms_k3 = _timed(lambda: block_trace.launch(fat, prep, False), reps=3)
    hk3 = block_trace.block_closest(fat, o1w, d1w, tm1w, gs=1)
    k3c = _compare_closest(fat, o1w, d1w, hk3, hp1w, tm1w > 0)
    bound_k3 = _bound(closest_waves[1]["tests"], _block_bytes(fat, prep, False))
    per_cta, per_block = list_lengths(o1w, d1w, tm1w, prep, False)
    print(f"[3 K3] closest wave 1 at gs=1: kernel {ms_k3:.3f} ms vs gs=4 "
          f"{closest_waves[1]['ms']:.3f} ms, candidates per CTA {per_cta:.2f} "
          f"(per 2048-ray block {per_block:.2f})", flush=True)
    _check_closest("K3 closest wave 1", k3c)
    prep = block_trace._prepare(fat, o, w, limit, gs=1)
    _, ms_k3o = _timed(lambda: block_trace.launch(fat, prep, True), reps=3)
    ok3 = block_trace.block_occluded(fat, o, w, t, gs=1)
    per_cta, per_block = list_lengths(o, w, limit, prep, True)
    print(f"[3 K3] deferred shadow wave at gs=1: kernel {ms_k3o:.3f} ms vs gs=4 "
          f"{ms_o:.3f} ms, candidates per CTA {per_cta:.2f} (per 2048-ray block "
          f"{per_block:.2f})", flush=True)
    k3o = _check_occluded("K3 occluded deferred wave", ok3, op, t > 0)
    bound_k3o = _bound(tests_o, _block_bytes(fat, prep, True))
    del waves, wave1, prep, ok3, op, o, w, t, limit, hp1w
    torch.cuda.empty_cache()

    # ---- 4: parity with the JAX reference's golden images -----------------
    gold = np.load(ROOT / "tests" / "golden" / "torch_atrium_tiny.npz")
    tw, th = 64, 32
    tiny, _ = flatten.flatten(builtin.atrium(columns=1, stacks=6, slices=12).root, device=dev)
    view_t = camera.make_view(gold["camera_to_world"], float(gold["fovy"]), tw, th, device=dev)
    # the golden is the reference's packet-tracer render: the port's block
    # kernel keeps its structure (auto would pick the dense tracer here)
    cfg_t = integrator.RenderConfig(width=tw, height=th, tracer="pallas", **BENCH)
    for i, seed in enumerate(gold["seeds"]):
        img, n = integrator.render_path_with_counts(tiny, view_t, cfg_t, int(seed))
        img = img.cpu().numpy()
        ref = gold["images"][i]
        mean_rel = abs(img.mean() - ref.mean()) / ref.mean()
        pix = float(np.all(np.abs(img - ref) <= 1e-3 * (1 + np.abs(ref)), axis=-1).mean())
        rays_rel = abs(int(n) - int(gold["n_rays"][i])) / int(gold["n_rays"][i])
        print(f"[4 parity] seed {int(seed)}: mean {img.mean():.6f} vs {ref.mean():.6f} "
              f"(rel {mean_rel:.2e}), pixels agreeing {pix:.4f}, "
              f"n_rays {int(n)} vs {int(gold['n_rays'][i])}", flush=True)
        assert mean_rel <= PARITY_MEAN_REL and pix >= PARITY_PIXEL_SHARE
        assert rays_rel <= PARITY_RAYS_REL

    # ---- 5: main path -------------------------------------------------------
    launches, img5, main5 = _timed_samples(scene, view, cfg, "5 main path", "atrium", smi)
    assert launches == {"block closest": 25, "block occluded": 5, "binned emit": 0,
                        "binned closest": 0, "binned occluded": 0}, launches

    # ---- 6: the binned path -------------------------------------------------
    for name, info in (("binned_min_kernel (K5)", binned.kernel_info("bin")),
                       ("binned_emit_kernel (g=8, pcap=16)", binned.kernel_info("emit", L))):
        print(f"[6 kernel] {name}: {info}", flush=True)
    cfg6 = integrator.RenderConfig(width=W, height=H, **BENCH, **BINNED)
    waves = {}
    integrator.render_path_with_counts(scene, view, cfg6, 0, capture=waves)
    assert len(waves["closest"]) == 1 and "occluded" not in waves
    assert [x[0].shape[0] for x in waves["binned_closest"]] == [W * H] * 4
    ((o, w, t, st_o),) = waves["binned_occluded"]
    assert t.shape[0] == 5 * W * H
    configs, sweep_lanes = _binned_sweep(fat, *waves["binned_closest"][0][:3])
    print(f"[6 sweep] emission kernel equal to _emit bit for bit in {configs} configurations "
          f"(g 1/32/64/128, em ray/group, pcap 3/32) on {sweep_lanes} lanes of closest wave 1",
          flush=True)
    k5 = []
    for o_, d_, tm_, st in waves["binned_closest"]:
        hb = block_trace.block_closest(fat, o_, d_, tm_)
        k5.append(_binned_wave(fat, "closest", o_, d_, tm_, st, hb))
        del hb
    hb = block_trace.block_occluded(fat, o, w, t)
    k5o = _binned_wave(fat, "occluded", o, w, t, st_o, hb)
    del waves, hb, o, w, t
    torch.cuda.empty_cache()
    launches6, img6, main6 = _timed_samples(scene, view, cfg6, "6 binned path", "atrium", smi)
    assert launches6 == {"block closest": 5, "block occluded": 0, "binned emit": 25,
                         "binned closest": 20, "binned occluded": 5}, launches6
    print(f"[6 binned path] {main6['ms_spp']:.1f} ms/spp vs {main5['ms_spp']:.1f} (phase 5); "
          f"image mean {main6['mean']:.6f} vs {main5['mean']:.6f} "
          f"(rel {abs(main6['mean'] - main5['mean']) / main5['mean']:.2e})", flush=True)

    # ---- 7: other configurations -------------------------------------------
    seed = 4  # phase 5's last sample
    for label, extra in (("binned_bounces=1", dict(binned_bounces=1)), ("gs=1", dict(gs=1))):
        _zero_launches()
        img, _ = integrator.render_path_with_counts(
            scene, view, integrator.RenderConfig(width=W, height=H, **BENCH, **extra), seed)
        mean = float(img.mean())
        rel = abs(mean - main5["mean"]) / main5["mean"]
        same = bool(torch.equal(img, img5))
        print(f"[7 {label}] image mean {mean:.6f} vs {main5['mean']:.6f} (rel {rel:.2e}), "
              f"equal to phase 5's sample {seed} bit for bit: {same}; "
              f"launches {dict(block_trace.LAUNCHES)} / binned {dict(binned.LAUNCHES)}",
              flush=True)
        assert bool(torch.isfinite(img).all()) and rel <= PARITY_MEAN_REL
        if label == "gs=1":
            k3_launches = dict(block_trace.LAUNCHES)
            assert k3_launches == {"closest": 5, "occluded": 1}, k3_launches
            assert same

    # ---- 8: the microbenchmark tools (T1-T4) ---------------------------------
    t_kernels = _microbench()

    # ---- 9: past the shared-memory budgets -----------------------------------
    torch.cuda.empty_cache()
    ha = block_trace.block_closest(fat, o_full, d_full)
    _, (o3a, w3a, tm3a) = _bounce_rays(scene, tile, lo, hi, o_full, d_full, ha, rng)
    atrium_waves = {"closest": (o_full, d_full, torch.full_like(tm3a, T_MAX)),
                    "occluded": (o3a, w3a, tm3a * block_trace.SHADOW_EPS)}
    past = _past_budgets(dev, scene, atrium_waves, rng)
    del ha, atrium_waves, o3a, w3a, tm3a
    torch.cuda.empty_cache()

    # ---- 10-12: the Cornell path, goldens and furnace, the GPU tests ---------
    cornell_scene, cornell_view, cornell = _cornell(dev, smi)
    gold = _goldens(dev, cornell_scene, cornell_view)
    gpu = _gpu_tests()

    # ms / plain_ms / wrapper_ms of K1 are means per closest wave over the
    # main path's five waves; K2's are the deferred shadow wave's. K3's are
    # closest wave 1's and the deferred wave's at gs=1, its launches those of
    # the gs=1 sample (phase 7). K5's are means over the binned path's four
    # closest waves and its deferred wave, its launches those of phase 6's
    # timed run; the emission kernel's are means over all five binned waves.
    # A flag output's max_abs_err is max |kernel - plain| over its 0/1
    # flags; the emission's over its counts and slot rows. bound_ms: see _bound and _needed_tri_tests, _k5_work for K5 and
    # _emission for the emission kernel.
    def avg(rows, key):
        return sum(r[key] for r in rows) / len(rows)

    emits = [c["emit"] for c in k5 + [k5o]]

    common = dict(route="cuda", library_ms=None)
    bt = dict(common, source="stratum_tpu_torch/csrc/block_trace.cu")
    kernels = [
        dict(bt, name="block_trace closest (K1)",
             replaces="stratum_tpu/ops/pallas_trace.py:1242",
             launches=launches["block closest"],
             max_abs_err=max(c["max_abs_err"] for c in closest_waves),
             ms=avg(closest_waves, "ms"), plain_ms=avg(closest_waves, "plain_ms"),
             bound_ms=avg(closest_waves, "bound_ms"), bound_by=closest_waves[1]["bound_by"],
             wrapper_ms=avg(closest_waves, "wrapper_ms"),
             agree=min(c["agree"] for c in closest_waves),
             wave_ms=[c["ms"] for c in closest_waves],
             wave_bound_ms=[c["bound_ms"] for c in closest_waves],
             wave_plain_ms=[c["plain_ms"] for c in closest_waves],
             wave_ncand_cta=[c["ncand_cta"] for c in closest_waves],
             wave_ncand_block=[c["ncand_block"] for c in closest_waves],
             tri_tests=[c["tests"] for c in closest_waves],
             rays=[c["rays"] for c in closest_waves],
             live=[c["live"] for c in closest_waves],
             forced_global_lists=past["atrium_forced"]["closest"]),
        dict(bt, name="block_trace occluded (K2)",
             replaces="stratum_tpu/ops/pallas_trace.py:1242",
             launches=launches["block occluded"], max_abs_err=float(occ["mismatch"] > 0),
             ms=ms_o, plain_ms=plain_ms_o, bound_ms=bound_o[0], bound_by=bound_o[1],
             wrapper_ms=wrap_ms_o, agree=occ["agree"], mismatch=occ["mismatch"],
             ncand_cta=per_cta_o, ncand_block=per_block_o, tri_tests=tests_o, rays=occ["rays"],
             live=occ["live"], forced_global_lists=past["atrium_forced"]["occluded"]),
        dict(bt, name="block_trace closest at gs=1 (K3)",
             replaces="stratum_tpu/ops/pallas_trace.py:532",
             launches=k3_launches["closest"], max_abs_err=k3c["max_abs_err"],
             ms=ms_k3, plain_ms=closest_waves[1]["plain_ms"], bound_ms=bound_k3[0],
             bound_by=bound_k3[1], gs4_ms=closest_waves[1]["ms"], agree=k3c["agree"],
             past_budget={k: v for k, v in past["closest"].items() if k != "emit"}),
        dict(bt, name="block_trace occluded at gs=1 (K3)",
             replaces="stratum_tpu/ops/pallas_trace.py:958",
             launches=k3_launches["occluded"], max_abs_err=float(k3o["mismatch"] > 0),
             ms=ms_k3o, plain_ms=plain_ms_o, bound_ms=bound_k3o[0], bound_by=bound_k3o[1],
             gs4_ms=ms_o, agree=k3o["agree"], mismatch=k3o["mismatch"],
             past_budget={k: v for k, v in past["occluded"].items() if k != "emit"}),
        dict(common, name="binned closest (K5)", source="stratum_tpu_torch/csrc/binned.cu",
             replaces="stratum_tpu/ops/binned.py:68",
             launches=launches6["binned closest"],
             max_abs_err=max(c["max_abs_err"] for c in k5),
             ms=avg(k5, "ms"), plain_ms=avg(k5, "plain_ms"), bound_ms=avg(k5, "bound_ms"),
             bound_by=k5[0]["bound_by"], agree=min(c["agree"] for c in k5),
             agree_block_undropped=min(c["vs_block"] for c in k5),
             wave_ms=[c["ms"] for c in k5], wave_bound_ms=[c["bound_ms"] for c in k5],
             wave_plain_ms=[c["plain_ms"] for c in k5], lanes=[c["lanes"] for c in k5],
             lanes_want=[c["lanes_want"] for c in k5], tri_tests=[c["tests"] for c in k5],
             tri_tests_all=[c["tests_all"] for c in k5],
             leaf_stagings=[c["stagings"] for c in k5], runs=[c["runs"] for c in k5],
             stats=[c["stats"] for c in k5], lost_share=[c["lost_share"] for c in k5]),
        dict(common, name="binned occluded (K5)", source="stratum_tpu_torch/csrc/binned.cu",
             replaces="stratum_tpu/ops/binned.py:68",
             launches=launches6["binned occluded"], max_abs_err=k5o["max_abs_err"],
             ms=k5o["ms"], plain_ms=k5o["plain_ms"], bound_ms=k5o["bound_ms"],
             bound_by=k5o["bound_by"], agree=k5o["agree"],
             agree_block_undropped=k5o["vs_block"], lanes=k5o["lanes"],
             lanes_want=k5o["lanes_want"], tri_tests=k5o["tests"],
             tri_tests_all=k5o["tests_all"], leaf_stagings=k5o["stagings"], runs=k5o["runs"],
             stats=k5o["stats"], lost_share=k5o["lost_share"]),
        dict(common, name="binned emission", source="stratum_tpu_torch/csrc/binned.cu",
             replaces="stratum_tpu/ops/binned.py:146-275",
             pallas=False, note="the reference's jnp emission (emit_slice), not a Pallas kernel",
             launches=launches6["binned emit"],
             max_abs_err=max(e["max_abs_err"] for e in emits),
             slot_rows_differ=sum(e["rows_differ"] for e in emits),
             ms=avg(emits, "ms"), plain_ms=avg(emits, "plain_ms"),
             bound_ms=avg(emits, "bound_ms"), bound_by=emits[0]["bound_by"],
             wave_ms=[e["ms"] for e in emits], wave_plain_ms=[e["plain_ms"] for e in emits],
             wave_bound_ms=[e["bound_ms"] for e in emits],
             wave_bound_all_ms=[e["bound_all_ms"] for e in emits],
             slab_tests=[e["tests"] for e in emits],
             slab_tests_all=[e["tests_all"] for e in emits],
             past_budget=dict(leaves=past["leaves"], tile_leaves=past["emit_tile"],
                              smem_all=past["emit_smem_all"], smem_tiled=past["emit_smem_tiled"],
                              closest=past["closest"]["emit"],
                              occluded=past["occluded"]["emit"]),
             forced_tiles={k: past["atrium_forced"][k + " emission"]
                           for k in ("closest", "occluded")}),
    ] + t_kernels
    print(json.dumps({"kernels": kernels,
                      "paths": {"main": main5, "binned": main6, "cornell": cornell},
                      "past_budgets": {k: past[k] for k in ("leaves", "triangles", "list_keys",
                                                           "emit_tile")},
                      "goldens": gold, "gpu_tests": gpu}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
