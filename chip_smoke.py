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
   list). On every wave each CTA's list (count, sorted entries and groups)
   the kernel reports (``stats="lists"``) is held bit for bit to
   ``candidate_lists(..., block=128, live_only=True)``, its mean is printed
   beside the reference's per-2048-block figure, and ``stats="phases"``
   gives the list phase and the walk apart (each CTA's clock64 cycles; the
   wave's time shared out by their sums) and the overflowing CTAs (none:
   the atrium's lists fit the shared mode). Then K3 (the same kernel at
   group size 1) on closest wave 1 and the deferred wave, against the same
   plain results, timed beside K1/K2, lists and split as above;
4. parity: the tiny atrium at 64x32, seeds 0-3, on the block kernel
   (``tracer="pallas"``), against the JAX reference's golden images
   (tests/golden/torch_atrium_tiny.npz);
5. main path: ``render_path_with_counts`` on the full atrium at 1920x1080
   with the bench configuration (Disney, 4 bounces, presample 4096,
   coherent tiles 16): 1 warm-up and 4 timed samples; the kernel launch
   counters are zeroed just before and read just after this phase (the
   Disney kernels' 10 and ``finalize_hit``'s 5 a sample among them);
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
   lower slot on equal t); each sample's kernel count (every chunk of the
   culled mode one) equal to the ``block_trace_kernel`` launches a
   ``torch.profiler`` trace of it records;
8. the microbenchmark tools (``stratum_tpu_torch/tools``, kernels T1-T4 in
   ``csrc/microbench.cu``): their four ``main`` entry points at the
   reference defaults and at k=256, with the T launch counters zeroed just
   before and read just after; then each T kernel against its plain
   version on two input sets, small integers (bit for bit: every product
   and sum is exact) and standard normal values (within each tool's stated
   bound; T2's lanes past 2^-12 of their value are shown beside the
   float64 run's winner, whose sums must cancel), T1-T3 at k from 8 to
   1,024, T4 in all eleven cases at passes 0, the case's own and 5, and
   the plain versions and (T3/T4) one ``torch.matmul`` of the same bf16
   product timed per visit (T4: per pass, every case), the call both
   captured in a CUDA graph (the device's time) and issued back to back.
   The per-SM bound is the larger of the tensor cores' time and the CUDA
   cores' (``tools.visit_bound_sm``): T1-T3 their epilogue's instructions
   per test by pipe (``tools.sass_visit_ops``), T4 the staging and issue
   instructions of a pass (``tools.sass_pass_ops``) of the CTAs the busiest
   SM runs, counted from the SASS of the library this run built, at the
   card's maximum SM clock; both halves and every pipe's time are printed,
   and each T kernel's registers, spills, shared memory, resident CTAs and
   output tile, and ptxas's wgmma remarks (a remark that serialises a
   wgmma, or a spill, fails the phase). Last, a visit of 256 slots by
   128 lanes per SM, at one CTA per SM and with the card full, both by T1
   ``epi`` (tensor cores) and by K1 (its exact-f32 counterpart), and by K1
   at 21 real slots per leaf (the atrium's entered leaves hold ~21
   triangles; K1 visits only a leaf's real triangles);
9. past the shared-memory budgets: a synthetic atrium (``BIG_ATRIUM``,
   ~10,400 SAH leaves) whose gs=1 lists need 16,384 keys and whose emission
   boxes need more than 227 KB. On its camera wave and a shadow wave from
   its hits: K3 in the culled list mode against the plain walk, its per-CTA
   lists bit for bit against ``candidate_lists(..., block=128,
   live_only=True)``, its list / walk split and overflowing CTAs (held to
   the plain lists' prediction) beside the forced overflow path's (every
   CTA: the design before the culling), the tiled emission against
   ``_emit`` bit for bit, with times, scratch and shared bytes. Then on the
   full atrium's primary and shadow waves the forced culled mode and its
   forced overflow path (gs 4 and 1) and the forced tiled emission against
   the default modes, bit for bit, each timed;
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
   test must pass, none skip (50: the kernels against their plain versions,
   three equalities of the wavefront entry points, BDPT and light tracing
   on K1/K2 against the brute-force tracer, same-seed BDPT renders and the
   splat bit-equal, the G-buffer on K1 against brute force and the card's
   denoiser against the CPU port);
13. the textured colonnade, bench.py's config 4: ``write_colonnade`` at its
   defaults (110,408 triangles, three 256-texel PNG textures, a 256-wide HDR
   sky) into ``build/colonnade``, loaded through the OBJ + MTL loader and
   flattened, each step timed, with the texture stack and environment
   tables' sizes; at 1920x1080 with the bench configuration ``auto``
   resolves to the block kernel, and one sample's K1/K2 waves (five closest
   waves, the deferred shadow wave) are timed whole against their bounds and
   held to the plain versions on slices of N_CHECK live lanes; then 1
   warm-up and 4 timed samples with the counters zeroed around them (25 K1 and 5 K2
   launches), the device busy share of one profiled sample with its top
   ops, and a layer split with the texture terms and the environment timed
   apart; the ``colonnade_textured`` golden on the card within twice the
   CPU bounds; ``packet`` and ``bvh`` on the Cornell box and the golden's
   small colonnade at 128x128 against the brute-force tracers (the same
   triangle on non-degenerate hits, occlusion flags), timed, and one path
   sample through each;
14. the rest of the path integrator at 1920x1080: on the full atrium with
   the bench configuration, ``render_path_batched`` at 4 spp (equal to
   ``render_path_progressive`` at seeds 0-3 within rtol 1e-5 / atol 1e-7,
   its ray count their sum), ``render_path_lanes`` at 2 and 4 spp (image
   mean within the parity bound of the same seeds' sequential mean; without
   the light tile equal to the sequential samples), K1 and K2 timed whole against
   their bounds on the lanes = 4 sample's closest wave 1 (8,294,400 lanes)
   and deferred wave (41,472,000) and held to plain on slices of N_CHECK
   live lanes;
   ``wave_caps=(1, 1, 0.6, 0.082, 0.031)`` (the alive share per bounce of
   phase 5's sample against each cap, 1 warm-up and 4 timed samples, the
   device busy share, K1 on a compacted wave whole and on its live lanes,
   caps of 1.0 equal to phase 5's sample), RIS with 4 candidates (1 + 2
   samples), NEE off and MIS off (one sample each); the alpha test on the
   reference's masked quad (``pallas`` and ``auto``: the cut-out half sees
   the emitter, the opaque half does not); ``smoky_cornell()`` with the
   Cornell path's configuration (the dense tracer; 1 + 2 samples) and the
   ``cornell_smoke`` golden; the analytic furnace, the sphere-light box,
   analytic against tessellated at 256x256, and the atrium with one
   analytic sphere (whose merged hits resolve without the fused payload).
   A layer split (a synchronise around each tracer layer) of a plain
   sample, a capped one and lane-batched ones gives their glue per sample
   in one call. Each timed line gives ms/spp, Mrays/s and peak memory
   beside the card's name and power limit;
15. the integrators above the path tracer at 1920x1080 on the full atrium:
   BDPT at bench.py's configuration (3 bounces, Disney, sorted waves,
   ``lvc_connections=4``) through ``render_bdpt_chunked(..., chunks=16)``:
   one chunk's waves captured (camera and light walk waves 0 and 1 on K1,
   the s = 1, light-cache and t = 1 splat occlusion batches on K2), each
   timed whole against its bound and held to plain on N_CHECK lanes, with
   the per-CTA list mean of the camera and light (from the emitters) first
   waves; 1 warm-up and 2 timed samples with the launch counters zeroed
   around them (128 K1 and 48 K2 launches a sample), peak memory, a
   same-seed render bit-equal, the device busy share of one profiled
   sample; at 480x270, paired BDPT in 16 chunks against 1 (rtol 1e-4,
   atol 1e-6), BDPT's mean against the path tracer's (5 %, 4 spp each) and
   two frames of ``render_bdpt_reuse`` against two without reuse (6 %).
   Then ``render_lt`` (1 + 2 samples, 5 K1 and 4 K2 launches a sample),
   ``restir_di`` (4 candidates, 2 spatial taps, three frames with the state
   fed back), ``render_adaptive`` (a 4 spp budget, pilot 2, frac 0.25), one
   sample under ``QMC = "kron"`` (mean within phase 4's parity bound of
   phase 5's, ``QMC`` restored) and one ``indirect_only`` sample;
16. the frame pipeline at 1920x1080 on the full atrium with the bench
   configuration: ``render_gbuffer`` (3 timed calls of one K1 launch each;
   its wave timed whole against its bound and held to plain on N_CHECK
   lanes, the G-buffer's instances and depths equal to the plain hits'
   where the slots agree); ``RenderSession(denoise=True)``: a warm-up frame
   and 4 timed frames with a ``set_view`` to a moved camera before the
   third, each split (a synchronise around each part) into the sample, the
   G-buffer, ``temporal_accumulate``, ``atrous_filter``, the tonemap and
   the rest, with 5 K1 + 1 K2 launches a frame (+1 K1 after the move),
   peak memory and the device busy share of one profiled frame; the card's
   denoiser against the CPU port on the same inputs (the temporal colour,
   history and the a-trous filter on identical inputs on every pixel within
   twice test_torch_denoise.py's bound, the whole pass on >= 99 % of the
   pixels: the variance's cancellation); the a-trous kernel on those inputs
   (``csrc/atrous.cu``, one launch an iteration): each launch's device time
   from a ``torch.profiler`` trace beside its bytes bound, its launches
   counted and traced, a call timed back to back, registers and spills,
   and the plain torch loop on the card (its time, and both held to the
   CPU port's plain loop); the session's batched step(4)
   against sequential, ``spp_lanes=4``, a ReSTIR step, ``step_adaptive``
   after a pilot, each timed, and a checkpoint round trip bit for bit;
   every debug view finite and the ``path_length_1..6`` images summing to
   the full sample; an animated pillar (``flatten(time=, prev_time=)``)
   whose pixels alone move in ``prev_uv``; and the CLI in a subprocess
   writing a denoised, ACES-tonemapped 1920x1080 PNG;
17. loaded scenes and the mesh, at 1920x1080: a fractal height field of
   4,193,408 triangles (SCAN_GRID^2 vertices from SCAN_SEED) written as a
   binary PLY beside a serialized box and a Mitsuba XML (SCAN_XML), loaded
   through ``cli.build_scene`` and flattened (each timed), more than 16,384
   SAH leaves, so K1/K2 take the culled list mode at gs=4: its five
   closest waves and its deferred wave timed whole against their bounds
   and held to plain on slices of N_CHECK live lanes, each wave's lists
   bit for bit against the plain list phase, its list / walk split and
   overflowing CTAs (printed, and held to the plain lists' prediction)
   beside the forced overflow path's (every CTA: the design before the
   culling, timed), 1 + 4 timed
   samples (5 times the kernels of one more sample, counted and equal to
   its trace's: K1 a multiple of its 5 waves, K2 one or more chunks of
   its deferred wave), the busy share of a profiled sample; the CLI in
   a subprocess on the XML and ``tools.compare`` of its PNG against the
   same render in this process, ``tools.inspect --flatten``; phase 13's
   colonnade written as one GLB with its PNGs embedded (``_write_glb``)
   and loaded with PIL blocked: material fields, flattened arrays, texture
   stack and one sample equal to the OBJ route's; ``smoky_cornell()``'s
   grid written as .vol and .nvdb, each loaded into the box by
   ``load_volume``, each sample equal to ``smoky_cornell()``'s bit for bit;
   ``make_mesh()`` (1 device), the Cornell path sharded 1 and 5 ways
   against ``render_path`` (tests/test_parallel.py's bounds), the atrium in
   5 shards against phase 5's sample (shards of whole 2,048-lane granules:
   the image and the rays equal bit for bit) and a denoised
   ``RenderSession`` frame on the mesh;
18. the Disney BSDF kernels (``csrc/disney.cu``): one 1920x1080 sample of
   each benchmark configuration in DISNEY_CONFIGS (``portbench/configs/``,
   the scene built as ``portbench.harness`` builds it) with the inputs of
   its 10 Disney calls kept (an eval for NEE and a sample a bounce, 10
   launches); each call run by the kernel and by the plain torch body on
   the card: the differing lanes of every output (0: bit for bit) and
   differing words, each launch's device time beside its bytes bound, the
   plain body's time, and both kernels' registers and spills (no spill);
19. ``finalize_hit`` (``csrc/finalize.cu``): one 1920x1080 sample of each
   configuration in DISNEY_CONFIGS under a ``torch.profiler`` trace with
   the inputs of its five closest waves kept; the launches the registry
   counts against the ``finalize_hit_kernel`` launches traced (5 and 5);
   each wave run by the kernel and by the plain torch body on the card:
   the differing words of tri, bary and payload (0: bit for bit), each
   launch's device time beside its bytes bound (744 B a lane) and beside
   the bound that reads each distinct row once, the plain body's time, and
   the kernel's registers and spills (no spill).

Then one JSON line of per-kernel results, the nvidia-smi line, and the
result line ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result line. No phase catches its own failure.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from stratum_tpu_torch.utils import cuda_build

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
# the launch registry's keys (cuda_build.launches) under the labels the
# phases report: K1 / K2 by mode, and every kernel of a path sample
BLOCK_KEYS = {"closest": "block_trace_closest", "occluded": "block_trace_occluded"}
SAMPLE_KEYS = {"block closest": "block_trace_closest", "block occluded": "block_trace_occluded",
               "binned emit": "binned_emit", "binned closest": "binned_min/closest",
               "binned occluded": "binned_min/occluded", "disney eval": "disney_eval",
               "disney sample": "disney_sample", "finalize": "finalize_hit"}
# the Disney launches over _timed_samples' 5 samples of a BENCH path: a
# 4-bounce sample launches an eval (NEE) and a sample a bounce, 10 in all
DISNEY_5 = {"disney eval": 25, "disney sample": 25}
# and the finalize_hit launches: one a closest wave, block or binned, 5 a
# sample
FINALIZE_5 = {"finalize": 25}
BINNED = dict(binned_secondary=8, binned_shadow=8)
# published peaks of one H100 SXM (NVIDIA data sheet): f32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# special-function ops (MUFU: ex2, lg2, rcp, rsq): 16 a clock an SM against
# the 256 f32 flops of its 128 lanes (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0)
PEAK_SFU_S = PEAK_F32_FLOPS / 16
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


def _check_lists(fat, o, d, bound, lists, gs, plain=None):
    """The kernel's per-CTA lists (``launch(..., stats=...)``) against the
    plain list phase at block 128 over live rays (``plain``, computed here
    when None), bit for bit: the counts, and where the kernel wrote them
    each CTA's sorted entries and groups. -> mean list length per CTA."""
    import torch
    from stratum_tpu_torch.ops import block_trace

    if plain is None:
        plain = block_trace.candidate_lists(fat, o, d, bound, gs, block_trace.CTA,
                                            live_only=True)
    n_cta = lists.ncand.numel()
    assert torch.equal(lists.ncand, plain.ncand[:n_cta]), int(
        (lists.ncand != plain.ncand[:n_cta]).sum())
    assert not bool(plain.ncand[n_cta:].any())
    if lists.centry is not None:
        assert torch.equal(lists.centry, plain.centry[:n_cta])
        assert torch.equal(lists.cand, plain.cand[:n_cta])
    return float(lists.ncand.float().mean())


def _list_split(fat, o, d, bound, prep, occluded, ms):
    """One wave's list phase and walk apart, in its default list mode and,
    where that is the culled one, with every CTA forced down the overflow
    path (``list_mode="global"``: the design before the culling, timed
    here): ``launch(..., stats="phases")`` gives each CTA's clock64 cycles
    of both, and the wave's time (``ms``, the default mode's) is shared out
    by their sums over the CTAs with a live ray (CTAs run side by side, so
    this is a share of the work, not of the wall time: a sparse wave's time
    is its slowest CTA's). In each mode each CTA's whole list is held bit for bit
    to the plain list phase, and the CTAs that overflow to those the plain
    lists predict (more than CULL_LIST_KEYS groups; every CTA with a live
    ray when forced; none in the shared mode); the two modes' results are
    equal bit for bit -> dict."""
    import torch
    from stratum_tpu_torch.ops import block_trace

    mode = block_trace.resolve_list_mode(prep.group_lo.shape[0])
    n_cta = prep.rays.shape[0] // block_trace.CTA
    plain = block_trace.candidate_lists(fat, o, d, bound, prep.gs, block_trace.CTA,
                                        live_only=True)
    live = (prep.t_max.view(n_cta, block_trace.CTA) > 0).any(dim=1)
    out, results = dict(mode=mode, ctas=n_cta, ctas_live=int(live.sum())), {}
    for m in (mode, "global") if mode == "culled" else (mode,):
        forced = "auto" if m == mode else m
        ms_m = ms if m == mode else _timed(
            lambda: block_trace.launch(fat, prep, occluded, list_mode=forced), reps=3)[1]
        *res, lists = block_trace.launch(fat, prep, occluded, stats="lists", list_mode=forced)
        out["ncand_cta"] = _check_lists(fat, o, d, bound, lists, prep.gs, plain)
        del lists
        *_, ph = block_trace.launch(fat, prep, occluded, stats="phases", list_mode=forced)
        want = {"shared": torch.zeros_like(live), "global": live,
                "culled": plain.ncand[:n_cta] > block_trace.CULL_LIST_KEYS}[m]
        assert torch.equal(ph.ncand, plain.ncand[:n_cta]) and torch.equal(ph.overflow, want), m
        lc, wc = float(ph.list_cycles.sum()), float(ph.walk_cycles.sum())
        out[m] = dict(ms=ms_m, list_ms=ms_m * lc / (lc + wc), walk_ms=ms_m * wc / (lc + wc),
                      list_share=lc / (lc + wc), overflow=int(ph.overflow.sum()),
                      list_cycles=lc, walk_cycles=wc)
        results[m] = res
    if "global" in results:
        for a, b in zip(results[mode], results["global"]):
            assert torch.equal(a, b)
    out["ncand_max"] = int(plain.ncand.max())
    return out


def _split_text(split) -> str:
    """A line's account of ``_list_split``."""
    m = split["mode"]
    x = split[m]
    text = (f"{m} lists: list phase {x['list_ms']:.3f} ms + walk {x['walk_ms']:.3f} ms "
            f"({100 * x['list_share']:.1f} % of the cycles), {x['overflow']} of "
            f"{split['ctas_live']} live CTAs overflow (longest list {split['ncand_max']}); "
            f"lists equal to the plain list phase")
    if "global" in split:
        g = split["global"]
        text += (f"; forced overflow path (every CTA, the design before the culling) "
                 f"{g['ms']:.3f} ms = list phase {g['list_ms']:.3f} + walk {g['walk_ms']:.3f} "
                 f"({100 * g['list_share']:.1f} %), {g['overflow']} CTAs overflow, results "
                 f"and lists equal")
    return text


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
    assert c["live"] > 0, (name, c)
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
    assert n_live > 0 and agree >= BATCH_AGREE, (name, n_live, agree)
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


_KERNEL_NAME = re.compile(r"block_trace_kernel(?:<\s*(true|false)\b|ILb([01])E)")


def _launches(keys=BLOCK_KEYS) -> dict:
    """The launch registry's counts under ``keys``' labels."""
    counts = cuda_build.launches()
    return {label: counts[key] for label, key in keys.items()}


def _traced_launches(fn) -> tuple:
    """The registry's K1 / K2 launches over one call of ``fn`` (reset
    before it) beside the ``block_trace_kernel`` launches a
    ``torch.profiler`` trace of that call records, each as {"closest": n,
    "occluded": n}: the program's count against the device's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    cuda_build.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    traced = {"closest": 0, "occluded": 0}
    for e in prof.events():
        m = _KERNEL_NAME.search(e.name) if e.device_type == DeviceType.CUDA else None
        if m:
            traced["occluded" if m.group(1) == "true" or m.group(2) == "1" else "closest"] += 1
    return _launches(), traced


def _timed_samples(scene, view, cfg_run, label, scene_name, smi, samples: int = 5):
    """1 warm-up and ``samples`` - 1 timed samples of
    ``render_path_with_counts`` with the launch registry reset just before
    and read just after -> (launches, last image, dict of ms/spp, Mrays/s,
    peak GiB, image mean)."""
    import torch
    from stratum_tpu_torch.render import integrator

    W, H = cfg_run.width, cfg_run.height
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    times, total_rays = [], 0
    for seed in range(samples):
        t0 = time.perf_counter()
        img, n = integrator.render_path_with_counts(scene, view, cfg_run, seed)
        n = int(n)  # synchronizes, like the reference bench's fetch
        torch.cuda.synchronize()
        if seed > 0:  # sample 0 is the warm-up
            times.append(time.perf_counter() - t0)
            total_rays += n
    launches = _launches(SAMPLE_KEYS)
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
    names = ("block_trace", "binned", "microbench", "atrous", "disney", "finalize")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(cuda_build.load, names))
    for name in names:
        print(f"[2 build] {name}.cu -> {cuda_build.library_path(name).name}; "
              f"ptxas: {cuda_build.ptxas_report(f'{name}.cu')}", flush=True)
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
T4_VARIANTS = 27  # T4's kernels: 0-8 k16 steps (0: the control) x three n-tiles
# rows of T1's and T2's comparisons: below, at and past one 32-row tile, not
# a whole number of tiles (72), and up to the packed argmin's 1,024 rows
MB_KS = (8, 16, 72, 256, 512, 1024)
T3_KS = (8, 16, 72, 256, 1024)  # T3's comparisons: the same, but for 512
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


def _t1_visit(dev, clock: float, ops: dict, k: int = 256, iters=(64, 256)):
    """T1 ``epi``'s visit of k rows by 128 lanes on one SM, timed as
    _k1_visit times K1: the commit-pipeline kernel over the CTA counts of
    SM_CTAS, each CTA with its own 128 lanes (the tool's uniform timing
    operands) and the same slab ring, marginal between two trip counts ->
    ms per visit and SM of each, beside the per-SM bound: the larger of the
    tensor cores' time and the epilogue's (128 k tests of ``ops``, the
    instructions per test by pipe counted from the kernel's SASS, at the SM
    clock ``clock``)."""
    import torch
    from stratum_tpu_torch import tools
    from stratum_tpu_torch.tools import perf_commit_pipeline as t1

    gen = torch.Generator(device="cpu").manual_seed(9)
    _, feat, word, _ = t1.operands("epi", k, 1, dev)
    b = tools.visit_bound_sm(2 * 48 * 4 * k * t1.B, t1.B * k, ops, clock)
    sm_ms = b["bound_s"] * 1e3
    result = dict(bound_sm_ms=sm_ms, tensor_sm_ms=b["tensor_s"] * 1e3,
                  epilogue_sm_ms=b["epilogue_s"] * 1e3, k=k)
    for key, ctas in SM_CTAS:
        rays = (torch.rand((48, ctas * t1.B), generator=gen) * 0.5).to(dev, torch.bfloat16)
        ms = []
        for it in iters:
            n = torch.tensor([it], dtype=torch.int32, device=dev)
            ms.append(_timed(lambda: t1.run_inner(rays, feat, word, n, "epi", k, it), reps=3)[1])
        result[key] = _per_sm((ms[1] - ms[0]) / (iters[1] - iters[0]), ctas)
        print(f"[8 visit per SM] T1 epi: k={k}, {ctas} CTAs: {ms[1]:.3f} ms at {iters[1]} "
              f"visits, {result[key] * 1e3:.3f} us per visit and SM (bound {sm_ms * 1e3:.3f} "
              f"us: tensor cores {b['tensor_s'] * 1e6:.3f} us, epilogue "
              f"{b['epilogue_s'] * 1e6:.3f} us, {b['epilogue_pipe']}, {t1.B * k} tests at "
              f"{clock / 1e6:.0f} MHz; {result[key] / sm_ms:.2f}x)", flush=True)
    return result


def _resources():
    """Phase 8's record of the T kernels as compiled: registers per thread
    (T1-T3: the kernel's; their consumer warpgroups raise theirs to 232 with
    setmaxnreg), spill bytes, shared memory (T4's at 5 passes or the most
    that fit), resident CTAs per SM and the output tile of a CTA, of each
    variant (T4: each k-step count, 0 the control, and n-tile), and ptxas's
    wgmma remarks. A remark that serialises a wgmma, or a spill, fails the
    phase."""
    from stratum_tpu_torch import tools
    from stratum_tpu_torch.tools import perf_commit_pipeline as t1
    from stratum_tpu_torch.tools import perf_epilogue as t2

    out = {}
    for i, v in enumerate(t1.VARIANTS):
        out[f"T1 {v}"] = tools.kernel_info(1, i)
    for i, v in enumerate(t2.VARIANTS):
        out[f"T2 {v}"] = tools.kernel_info(2, i)
    out["T3"] = tools.kernel_info(3, 0)
    for v in range(T4_VARIANTS):
        r = tools.kernel_info(4, v)
        out[f"T4 ks={v % 9} n={r['tile'][1]}"] = r
    for name, r in out.items():
        print(f"[8 resources] {name}: {r['registers']} registers, {r['local_bytes']} spill "
              f"bytes, {r['static_smem']} + {r['dynamic_smem']} B shared, {r['threads']} "
              f"threads, {r['ctas_per_sm']} CTA(s) per SM, output tile {r['tile']}", flush=True)
    spills = [name for name, r in out.items() if r["local_bytes"]]
    # ptxas's remarks on the wgmma pipelines (C7510-C7520): "serialized"
    # (the async overlap lost), or a fence / wait it injected
    remarks, serialised = {}, 0
    for ln in cuda_build.BUILD_LOG.get("microbench.cu", "").splitlines():
        code = re.search(r"\((C75\d\d)\)", ln)
        kernel = re.search(r"(commit_pipeline_kernel|epilogue_kernel|mxu_loop_kernel|"
                           r"mxu_model_kernel)(?:ILi(\d+)E(?:Li(\d+)E)?(?:Li(\d+)E)?)?", ln)
        if code and kernel:
            key = f"{code.group(1)} {kernel.group(1)}<{','.join(filter(None, kernel.groups()[1:]))}>"
            remarks[key] = remarks.get(key, 0) + 1
            serialised += "serialized" in ln
    print("[8 resources] ptxas wgmma remarks on T1-T4: " + (", ".join(
        f"{key} x{n}" for key, n in sorted(remarks.items())) or "none")
        + f"; wgmmas serialised in {serialised}; spills in {spills or 'none'}", flush=True)
    assert serialised == 0 and not spills, (remarks, spills)
    out["ptxas_wgmma_remarks"] = remarks
    return out


def _graph_ms(fn, calls: int = 48, replays: int = 10) -> float:
    """ms of one call of ``fn`` on the device: ``calls`` calls captured in a
    CUDA graph, whose replays are timed with CUDA events (no host issue
    between the calls)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _timed(graph.replay, reps=replays)[1] / calls


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
    entries = {"T1": "mb_commit_pipeline", "T2": "mb_epilogue", "T3": "mb_mxu_loop",
               "T4": "mb_mxu_model"}
    clock = tools.max_sm_clock_hz()
    # instructions per test by pipe of each T1 / T2 kernel's tile loop, from
    # the SASS of the library this run built
    sass = tools.library_sass()
    ops = {}
    for tool, variants, parts in ((1, t1.VARIANTS, 1), (2, t2.VARIANTS, 3), (3, ["loop"], 1)):
        for i, v in enumerate(variants):
            ops[f"T{tool}", v] = o = tools.sass_visit_ops(
                sass, tools.kernel_info(tool, i)["symbol"], parts)
            print(f"[8 sass] T{tool} {v}: per test fp32 {o['fp32']:.3f}, alu {o['alu']:.3f}, "
                  f"mufu {o['mufu']:.3f}, other {o['other']:.3f} (issue "
                  f"{o['fp32'] + o['alu'] + o['mufu'] + o['other']:.3f}) over {o['tests']:g} "
                  f"tests a thread on the loop's path", flush=True)
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    runs = {}
    for name, mod, argv in (("T1", t1, []), ("T1 k=256", t1, ["--k=256"]),
                            ("T2", t2, []), ("T2 k=256", t2, ["--k=256"]),
                            ("T3", t3, []), ("T3 k=256", t3, ["--k=256"]), ("T4", t4, [])):
        print(f"[8 tools] {mod.__name__.rsplit('.', 1)[1]} {' '.join(argv)}", flush=True)
        runs[name] = mod.main(argv)
    launches = _launches(entries)
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
    for k in MB_KS:
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
                slab = vals(kind, (48, 4 * k)).to(bf16)
                rays = vals(kind, (48, 256), nonzero=True).to(bf16)
                want = t2.run_plain(slab, rays, v, k, 256, MB_ITERS)
                got = t2.run(slab, rays, v, k, 256, MB_ITERS)
                tol = None if kind == "int" else t2.tolerance(slab, rays, v, k, MB_ITERS, want)
                note("T2", _mb_check(f"T2 {v} k={k}", kind, got, want, tol))
                for lane in t2.past_band(slab, rays, v, k, MB_ITERS, got, want):
                    print(f"[8 T2 past 2^-12] {lane['line']}", flush=True)
                    assert lane["cancel"] >= t2.CANCELLING, lane
    for k in T3_KS:
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
    # torch.matmul of the same bf16 product (in a CUDA graph, and as 20 calls
    # issued back to back), at the reference defaults and (T1-T3) at k=256
    def bound(flops, nbytes):
        ops_ms = flops / tools.PEAK_BF16_FLOPS * 1e3
        bytes_ms = nbytes / tools.PEAK_BYTES_S * 1e3
        return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")

    def sm_bound(flops, tests=0, ops=None):
        """Least time of one visit (T4: one pass) on one SM: the larger of
        its flop at 1/132 of the tensor-core peak and its CUDA-core work,
        tests x ``ops`` (instructions per test by pipe) at the card's
        maximum SM clock (T3: its bare epilogue, the carry's few
        instructions a visit not counted; the slabs come from L2, whose
        rate has no published figure, and are not counted) -> dict of ms."""
        b = tools.visit_bound_sm(flops, tests, ops or {}, clock)
        return dict(ms=b["bound_s"] * 1e3, tensor_ms=b["tensor_s"] * 1e3,
                    epilogue_ms=b["epilogue_s"] * 1e3, by=b["bound_by"], tests=tests,
                    pipes_ms={p: x * 1e3 for p, x in b["pipes_s"].items()})

    def halves(b, cuda="epilogue", unit="tests"):
        if b["tests"] == 0:
            return f"per-SM bound {b['ms'] * 1e6:.1f} ns (tensor cores)"
        pipes = ", ".join(f"{p} {x * 1e6:.1f}" for p, x in b["pipes_ms"].items())
        return (f"per-SM bound {b['ms'] * 1e6:.1f} ns ({b['by']}: tensor cores "
                f"{b['tensor_ms'] * 1e6:.1f} ns, {cuda} {b['epilogue_ms'] * 1e6:.1f} ns; "
                f"{b['tests']} {unit} at {clock / 1e6:.0f} MHz, by pipe: {pipes} ns)")

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
                    sm_bound(flops, t1.B * k, ops["T1", "epi"]), None,
                    {v: dict(ns=r["ns_per_commit"],
                             bound_sm=sm_bound(flops, t1.B * k, ops["T1", v]))
                     for v, r in run.items()})
        if name == "T2":
            slab = vals("normal", (48, 4 * k)).to(bf16)
            rays = vals("normal", (48, 128)).to(bf16)
            plain = per_visit(lambda: t2.run_plain(slab, rays, "full", k, 128, MB_ITERS),
                              MB_ITERS)
            run = runs["T2" if k == 512 else "T2 k=256"]
            flops = 3 * 2 * 48 * 4 * k * 128  # the f32 product as three bf16 products
            nbytes = (48 * 4 * k * 2 + 48 * 128 * 2 + 128 * 4) / 64
            return (run["full"]["ns_per_exec"] * 1e-6, plain, bound(flops, nbytes),
                    sm_bound(flops, 128 * k, ops["T2", "full"]), None,
                    {v: dict(ns=r["ns_per_exec"],
                             bound_sm=sm_bound(flops, 128 * k, ops["T2", v]))
                     for v, r in run.items()})
        run = runs["T3" if k == 1024 else "T3 k=256"]
        lo, hi = t3.TRIPS[-2], t3.TRIPS[-1]
        rays = vals("normal", (48, t3.B)).to(bf16)
        feat = vals("normal", (t3.NL, 48, 4 * k)).to(bf16)
        plain = per_visit(lambda: t3.run_plain(rays, feat, MB_ITERS, False), MB_ITERS)
        f0 = feat[0].T
        lib = _graph_ms(lambda: torch.matmul(f0, rays))
        flops = 2 * 48 * 4 * k * t3.B
        nbytes = (48 * t3.B * 2 + t3.NL * 48 * 4 * k * 2 + t3.B * 4) / hi
        return ((run[(0, hi)]["ms"] - run[(0, lo)]["ms"]) / (hi - lo), plain,
                bound(flops, nbytes), sm_bound(flops, t3.B * k, ops["T3", "loop"]), lib,
                {"dep1_ms": (run[(1, hi)]["ms"] - run[(1, lo)]["ms"]) / (hi - lo),
                 "library_events_ms": _timed(lambda: torch.matmul(f0, rays), reps=20)[1],
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
            bound_ms=b_ms, bound_by=b_by, library_ms=lib,
            library_events_ms=extra.pop("library_events_ms", None), unit=unit,
            bound_sm_ms=b_sm["ms"], bound_sm=b_sm, extra=extra, k256=dict(
                ms=ms2, plain_ms=plain2, bound_ms=b2, bound_sm_ms=b2_sm["ms"], bound_sm=b2_sm,
                library_ms=lib2, library_events_ms=extra2.pop("library_events_ms", None),
                extra=extra2)))
    # T4 in each case: per pass on the whole card (the tool's slope), the
    # whole-card bound, and the per-SM bound of its own grid: the CTAs the
    # busiest SM runs, their flop (at the kernel's padded depth) against
    # their staging and issue instructions a pass, counted from the SASS
    cases = {}
    for label, c, m, b, _, reps in t4.CASES:
        (tm, tn), v = t4.geometry(c, m, b, 5)
        assert t4.geometry(c, m, b, 1)[0] == (tm, tn), label
        ks, ctas = v % 9, m // tm * (b // tn)
        busiest = -(-ctas // 132)  # CTAs of the SM that runs the most
        pass_ops = tools.sass_pass_ops(sass, tools.kernel_info(4, v)["symbol"],
                                       min(2 * ks * tn, 128))
        a16 = vals("normal", (c, m)).to(bf16).T
        b16 = vals("normal", (c, b)).to(bf16)
        cases[label] = dict(
            ns_per_pass=runs["T4"][label]["ns_per_pass"], ctas=ctas, tile=(tm, tn), ks=ks,
            bound=bound(2 * c * m * b, (c * m * 4 + c * b * 4 + m * b * 4) / (t4.ITERS * 5)),
            bound_sm=sm_bound(busiest * 2 * 16 * ks * tm * tn, busiest, pass_ops),
            pass_ops=pass_ops, library_ms=_graph_ms(lambda: torch.matmul(a16, b16)),
            library_events_ms=_timed(lambda: torch.matmul(a16, b16), reps=20)[1])
        x = cases[label]
        print(f"[8 timing] T4 {label}: {x['ns_per_pass']:.1f} ns per pass, {ctas} CTAs of "
              f"{tm} x {tn}; bound {x['bound'][0] * 1e6:.2f} ns ({x['bound'][1]}), "
              f"{x['ns_per_pass'] * 1e-6 / x['bound'][0]:.2f}x; "
              f"{halves(x['bound_sm'], 'staging and issue', 'CTA passes')}, "
              f"{x['ns_per_pass'] * 1e-6 / x['bound_sm']['ms']:.2f}x; "
              f"library {x['library_ms'] * 1e6:.1f} ns in a graph, "
              f"{x['library_events_ms'] * 1e6:.1f} ns issued back to back", flush=True)
    label, c, m, b, _, reps = t4.CASES[0]
    a = vals("normal", (c, m))
    bb = vals("normal", (c, b))
    p1 = per_visit(lambda: t4.run_plain(a, bb, 4, 1, reps), 4)
    p5 = per_visit(lambda: t4.run_plain(a, bb, 4, 5, reps), 4)
    head = cases[label]
    entries.append(dict(
        common, name=f"mxu_model, {label} (T4)", replaces="tools/bench_mxu_model.py:35",
        launches=launches["T4"], max_abs_err=max(errs["T4"]), max_rel_err=max(rels["T4"]),
        equal_share=min(equal["T4"]), ms=head["ns_per_pass"] * 1e-6,
        plain_ms=(p5 - p1) / 4, bound_ms=head["bound"][0], bound_by=head["bound"][1],
        library_ms=head["library_ms"], library_events_ms=head["library_events_ms"],
        unit="per pass, whole card (slope of passes 1 -> 5)",
        bound_sm_ms=head["bound_sm"]["ms"], bound_sm=head["bound_sm"], extra=cases))
    per_sm = entries[0]["visit_per_sm"] = dict(
        T1=_t1_visit(dev, clock, ops["T1", "epi"]), K1=_k1_visit(dev),
        K1_real21=_k1_visit(dev, real=21))
    print("[8 visit per SM] T1 epi / K1 at k=256: " + ", ".join(
        f"{ctas} CTAs {per_sm['T1'][key] / per_sm['K1'][key]:.3f}" for key, ctas in SM_CTAS),
        flush=True)

    for e in entries:
        labels = ("staging and issue", "CTA passes") if e["name"].endswith("(T4)") else ()
        sm = f", {halves(e['bound_sm'], *labels)}, {e['ms'] / e['bound_sm_ms']:.2f}x" \
            if "bound_sm" in e else ""
        lib = "none" if e["library_ms"] is None else f"{e['library_ms'] * 1e6:.1f} ns"
        if e.get("library_events_ms") is not None:
            lib += f" in a graph, {e['library_events_ms'] * 1e6:.1f} ns issued back to back"
        print(f"[8 timing] {e['name']}: {e['ms'] * 1e6:.1f} ns {e['unit']}; bound "
              f"{e['bound_ms'] * 1e6:.2f} ns ({e['bound_by']}){sm}; plain "
              f"{e['plain_ms'] * 1e6:.1f} ns; library {lib}", flush=True)
        if "k256" in e:
            x = e["k256"]
            lib = "" if x["library_ms"] is None else (
                f"; library {x['library_ms'] * 1e6:.1f} ns in a graph, "
                f"{x['library_events_ms'] * 1e6:.1f} ns issued back to back")
            print(f"[8 timing]   at k=256: {x['ms'] * 1e6:.1f} ns, {halves(x['bound_sm'])}, "
                  f"{x['ms'] / x['bound_sm_ms']:.2f}x; plain {x['plain_ms'] * 1e6:.1f} ns{lib}",
                  flush=True)
        for kk, ex in ((None, e.get("extra", {})), (256, e.get("k256", {}).get("extra", {}))):
            for v, r in ex.items():
                if isinstance(r, dict) and "ns" in r:
                    print(f"[8 timing]   {v}{'' if kk is None else f' at k={kk}'}: "
                          f"{r['ns']:.1f} ns, {halves(r['bound_sm'])}, "
                          f"{r['ns'] * 1e-6 / r['bound_sm']['ms']:.2f}x", flush=True)
    entries[0]["resources"] = _resources()
    return entries

# ---- phases 9-12 -----------------------------------------------------------------

# a synthetic atrium past both shared-memory budgets: 1,836,000 triangles in
# ~10,400 SAH leaves (the atrium's ~176 triangles a leaf), so at gs = 1 a
# CTA's list needs 16,384 keys (> MAX_LIST_KEYS: no shared mode) and the emission's boxes at
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
GPU_TESTS = 91  # tests in tests/test_torch_cuda.py


def _modes_equal(fat, o, d, bound, occluded, gs):
    """The three list modes forced on one wave (``list_mode="shared"``,
    ``"culled"`` and its overflow path ``"global"``): outputs and per-CTA
    lists bit for bit, each timed, and which one ``auto`` takes -> dict."""
    import torch
    from stratum_tpu_torch.ops import block_trace

    prep = block_trace._prepare(fat, o, d, bound, gs)
    want = block_trace.launch(fat, prep, occluded, stats="lists", list_mode="shared")
    ms = {}
    for mode in ("shared", "culled", "global"):
        _, ms[mode] = _timed(lambda: block_trace.launch(fat, prep, occluded, list_mode=mode),
                             reps=3)
        got = block_trace.launch(fat, prep, occluded, stats="lists", list_mode=mode)
        for a, b in zip(got[:-1] + tuple(got[-1]), want[:-1] + tuple(want[-1])):
            assert torch.equal(a, b), (occluded, gs, mode)
    G = prep.group_lo.shape[0]
    n_cta = prep.rays.shape[0] // block_trace.CTA
    return dict(gs=gs, auto=block_trace.resolve_list_mode(G), ms_shared=ms["shared"],
                ms_culled=ms["culled"], ms_global=ms["global"], groups=G,
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
          f"({block_trace.resolve_list_mode(L)} mode: super-groups of "
          f"{block_trace.SUPER_SIZE}, up to {block_trace.CULL_LIST_KEYS} reached keys in shared "
          f"memory; the shared mode holds at most {block_trace.MAX_LIST_KEYS}); emission boxes of all leaves "
          f"{binned.emit_smem(L, 8, 16)} B > {binned.EMIT_SMEM_BUDGET} B: tiles of {tile} "
          f"leaves ({binned.emit_smem(tile, 8, 16)} B)", flush=True)
    assert BIG_LEAVES[0] <= L <= BIG_LEAVES[1], L
    assert block_trace.resolve_list_mode(L) == "culled" and tile < L
    for occluded in (False, True):
        print(f"[9 kernel] block_trace_kernel<{str(occluded).lower()}, culled lists> at "
              f"gs=1 (G={L}): {block_trace.kernel_info(occluded, L, 'culled')}", flush=True)
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
        split = _list_split(fat, o, d, bound, prep, occluded, ms)
        per_cta = split["ncand_cta"]
        prep4 = block_trace._prepare(fat, o, d, bound)
        G4 = prep4.group_lo.shape[0]
        _, ms4 = _timed(lambda: block_trace.launch(fat, prep4, occluded), reps=3)
        _, ms4s = _timed(lambda: block_trace.launch(fat, prep4, occluded, list_mode="shared"),
                         reps=3)
        if occluded:
            ok = block_trace.block_occluded(fat, o, d, tm, gs=1)
            op, plain_ms = _timed(lambda: block_trace.block_occluded_plain(fat, o, d, tm),
                                  warmup=False)
            agree = _check_occluded("K3 occluded (culled lists) vs plain", ok, op, tm > 0)
        else:
            hk = block_trace.block_closest(fat, o, d, tm, gs=1)
            hp, plain_ms = _timed(lambda: block_trace.block_closest_plain(fat, o, d, tm),
                                  warmup=False)
            agree = _compare_closest(fat, o, d, hk, hp, tm > 0)
            _check_closest("K3 closest (culled lists) vs plain", agree)
        em = _emission(fat, o, d, bound, 8, 16)
        G = prep.group_lo.shape[0]
        n_cta = prep.rays.shape[0] // block_trace.CTA
        scratch = 8 * keys * block_trace.list_scratch_ctas(G, n_cta)
        print(f"[9 past the budgets] {kind} wave ({o.shape[0]} lanes, {int((tm > 0).sum())} "
              f"live): K3 with culled lists {ms:.3f} ms ({n_cta} CTAs, scratch {scratch} B, "
              f"{per_cta:.2f} groups per CTA; {_split_text(split)}), K1/K2 at "
              f"gs=4 ({G4} groups) with {block_trace.resolve_list_mode(G4)} lists {ms4:.3f} ms, "
              f"forced shared lists {ms4s:.3f} ms ({8 * block_trace.list_keys(G4)} B of keys a "
              f"CTA), plain {plain_ms:.3f} ms; tiled emission {em['ms']:.3f} ms "
              f"(bound {em['bound_ms']:.3f} ms, {em['bound_by']}), torch emission "
              f"{em['plain_ms']:.3f} ms, count and slots equal", flush=True)
        res[kind] = dict(agree, ms_culled=ms, ms_global=split["global"]["ms"], split=split,
                         ms_gs4=ms4, ms_gs4_shared=ms4s, plain_ms=plain_ms,
                         ncand_cta=per_cta, scratch_bytes=scratch, ctas=n_cta,
                         emit=dict(ms=em["ms"], plain_ms=em["plain_ms"],
                                   bound_ms=em["bound_ms"], bound_by=em["bound_by"]))
    res.update(leaves=L, triangles=stats.num_triangles, list_keys=keys, emit_tile=tile,
               emit_smem_all=binned.emit_smem(L, 8, 16),
               emit_smem_tiled=binned.emit_smem(tile, 8, 16))
    del big, fat, prep, prep4
    torch.cuda.empty_cache()

    # the full atrium: forced modes against the defaults
    fat = atrium.fat_bvh
    forced = {}
    for kind, (o, d, bound) in atrium_waves.items():
        occluded = kind == "occluded"
        forced[kind] = [_modes_equal(fat, o, d, bound, occluded, gs) for gs in (4, 1)]
        forced[kind + " emission"] = _tiles_equal(fat, o, d, bound)
        for m in forced[kind]:
            print(f"[9 forced modes] atrium {kind} wave ({o.shape[0]} lanes) gs={m['gs']} "
                  f"({m['groups']} groups, auto takes {m['auto']}): shared lists "
                  f"{m['ms_shared']:.3f} ms ({m['shared_bytes']} B), culled {m['ms_culled']:.3f} "
                  f"ms, overflow path {m['ms_global']:.3f} ms (scratch {m['scratch_bytes']} B), "
                  f"results and lists equal", flush=True)
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


COLONNADE_TRIANGLES = 110408  # sample_assets.write_colonnade at its defaults
COLONNADE_STACK = (3, 256, 1)  # its textures: count, resolution, slot mask (base color)
# the colonnade_textured golden's asset and configuration (tests/update_goldens.py:57-64)
COLONNADE_GOLDEN = dict(columns=3, seg=12, rings=6, tex_res=64, env_res=64)
COLONNADE_GOLDEN_CFG = dict(max_bounces=2, bsdf="disney", presample_lights=256)
TRACER_FRAME = 128  # packet and LBVH checks: camera rays of a 128x128 frame


def _wave_slice(o, d, tm, rng):
    """N_CHECK of a wave's live lanes (t_max > 0; all of them where it has
    fewer), in their order (the tracer's blocks keep the wave's
    coherence)."""
    import numpy as np
    import torch

    live = torch.nonzero(tm > 0).squeeze(1)
    n = live.numel()
    if n > N_CHECK:
        live = live[torch.from_numpy(np.sort(rng.choice(n, N_CHECK, replace=False))).to(o.device)]
    return o[live], d[live], tm[live]


def _colonnade_waves(scene, view, cfg, rng, label="13 colonnade", split=False):
    """One 1920x1080 sample's K1/K2 waves on the colonnade (phase 17: the
    scene ``label`` names): each full wave's
    kernel time (the launch, list phase included) against its bound, its
    mean list length per CTA, and the kernel against its plain version on
    N_CHECK lanes of it; with ``split``, each wave's lists held to the plain
    list phase and its list / walk split in both modes (``_list_split``)
    -> (closest wave dicts, deferred wave dict)."""
    import torch
    from stratum_tpu_torch.ops import block_trace
    from stratum_tpu_torch.render import integrator

    fat = scene.fat_bvh
    waves = {}
    integrator.render_path_with_counts(scene, view, cfg, 0, capture=waves)
    assert len(waves["closest"]) == cfg.max_bounces + 1 and len(waves["occluded"]) == 1
    closest = []
    for i, (o, d, tm) in enumerate(waves["closest"]):
        prep = block_trace._prepare(fat, o, d, tm)
        _, ms = _timed(lambda: block_trace.launch(fat, prep, False), reps=3)
        *_, lists = block_trace.launch(fat, prep, False, stats="ncand")
        per_cta = float(lists.ncand.float().mean())
        hk = block_trace.block_closest(fat, o, d, tm)
        tests = _needed_tri_tests(fat, o, d, torch.where(hk.slot >= 0, hk.t, tm))
        bound_ms, bound_by = _bound(tests, _block_bytes(fat, prep, False))
        sp = _list_split(fat, o, d, tm, prep, False, ms) if split else None
        del prep, hk, lists
        os_, ds_, ts_ = _wave_slice(o, d, tm, rng)
        hk, _ = _timed(lambda: block_trace.block_closest(fat, os_, ds_, ts_), warmup=False)
        hp, plain_ms = _timed(lambda: block_trace.block_closest_plain(fat, os_, ds_, ts_),
                              warmup=False)
        c = _compare_closest(fat, os_, ds_, hk, hp, ts_ > 0)
        print(f"[{label} waves] closest wave {i} ({o.shape[0]} lanes, "
              f"{int((tm > 0).sum())} live): kernel {ms:.3f} ms (bound {bound_ms:.3f} ms, "
              f"{bound_by}; {tests} tests), candidate groups per CTA {per_cta:.2f}; "
              f"{c['rays']}-lane slice: plain {plain_ms:.3f} ms, {c}"
              + (f"; {_split_text(sp)}" if split else ""), flush=True)
        _check_closest(f"{label} closest wave {i}", c)
        closest.append(dict(c, ms=ms, plain_slice_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, tests=tests, lanes=o.shape[0],
                            ncand_cta=per_cta, split=sp))
    ((o, w, t),) = waves["occluded"]
    del waves
    limit = t * block_trace.SHADOW_EPS
    prep = block_trace._prepare(fat, o, w, limit)
    _, ms_o = _timed(lambda: block_trace.launch(fat, prep, True), reps=3)
    *_, lists = block_trace.launch(fat, prep, True, stats="ncand")
    per_cta_o = float(lists.ncand.float().mean())
    ok_full = block_trace.block_occluded(fat, o, w, t)
    tests_o = _needed_tri_tests(fat, o, w, limit, blocked=ok_full)
    bound_o = _bound(tests_o, _block_bytes(fat, prep, True))
    sp = _list_split(fat, o, w, limit, prep, True, ms_o) if split else None
    del prep, ok_full, lists
    os_, ws_, ts_ = _wave_slice(o, w, t, rng)
    ok = block_trace.block_occluded(fat, os_, ws_, ts_)
    op, plain_ms_o = _timed(lambda: block_trace.block_occluded_plain(fat, os_, ws_, ts_),
                            warmup=False)
    print(f"[{label} waves] deferred shadow wave ({t.numel()} lanes, {int((t > 0).sum())} "
          f"live): kernel {ms_o:.3f} ms (bound {bound_o[0]:.3f} ms, {bound_o[1]}; {tests_o} "
          f"tests), candidate groups per CTA {per_cta_o:.2f}; {os_.shape[0]}-lane slice: "
          f"plain {plain_ms_o:.3f} ms" + (f"; {_split_text(sp)}" if split else ""), flush=True)
    occ = _check_occluded(f"{label} occluded deferred wave slice", ok, op, ts_ > 0)
    occluded = dict(occ, ms=ms_o, plain_slice_ms=plain_ms_o, bound_ms=bound_o[0],
                    bound_by=bound_o[1], tests=tests_o, lanes=t.numel(), ncand_cta=per_cta_o,
                    split=sp)
    torch.cuda.empty_cache()
    return closest, occluded


def _texture_layers(scene, view, cfg, seed):
    """profile_sample's layer split of one sample, with the texture terms
    (ray-cone LOD, apply_textures, apply_normal_map), the escape path's
    environment lookup and the presampled light tile timed apart from the
    glue (a device synchronise around each call) -> dict of ms."""
    import torch
    from stratum_tpu_torch import profile_sample
    from stratum_tpu_torch.render import integrator
    from stratum_tpu_torch.render import lights as slights

    acc = {}
    patched = ((integrator, "apply_textures", "textures"),
               (integrator, "apply_normal_map", "textures"),
               (integrator.stex, "ray_cone_lod", "textures"),
               (slights, "env_eval_and_pdf_w_mis", "env_escape"),
               (integrator, "light_tile_for", "light_tile"))
    saved = []
    for mod, name, layer in patched:
        real = getattr(mod, name)
        acc.setdefault(layer, 0.0)

        def timed(*a, _real=real, _layer=layer, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _real(*a, **k)
            torch.cuda.synchronize()
            acc[_layer] += (time.perf_counter() - t0) * 1e3
            return out

        saved.append((mod, name, real))
        setattr(mod, name, timed)
    try:
        split = profile_sample.layer_split(scene, view, cfg, seed)
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)
    split.update(acc)
    split["glue_rest"] = split["glue"] - sum(acc.values())
    return split


def _tracer_checks(g, name, dev, rng):
    """Phase 13's packet and LBVH checks on one small scene: camera rays of
    a TRACER_FRAME-square frame and shadow segments from their hits (brute
    force's) to random points of the scene box; closest hits against
    ``intersect_brute_force`` (the same triangle on non-degenerate hits, t
    within T_REL), occlusion against ``occluded_brute_force``; each
    tracer's time; then one path sample per tracer at that size."""
    import numpy as np
    import torch
    from stratum_tpu_torch.ops import bvh, intersect, packet
    from stratum_tpu_torch.render import camera, integrator
    from stratum_tpu_torch.scene import flatten

    sc, _ = flatten.flatten(g.root, device=dev)
    n = TRACER_FRAME
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, n, n, device=dev)
    px, py = camera.pixel_grid(n, n, dev)
    jitter = torch.from_numpy(rng.random((n * n, 2), dtype=np.float32)).to(dev)
    o, d = camera.generate_rays(view, px, py, jitter, n, n)
    geo = sc.geo
    hb, brute_ms = _timed(lambda: intersect.intersect_brute_force(o, d, geo.positions,
                                                                   geo.indices))
    w = 1.0 - hb.bary.sum(dim=1)
    clean = (hb.tri >= 0) & (hb.bary.amin(dim=1) > EDGE) & (w > EDGE)
    lo, hi = geo.positions.amin(dim=0), geo.positions.amax(dim=0)
    target = lo + (hi - lo) * torch.from_numpy(rng.random((n * n, 3), dtype=np.float32)).to(dev)
    hit_p = o + d * torch.where(hb.tri >= 0, hb.t, 0.0)[:, None]
    seg = target - hit_p
    dist = torch.linalg.norm(seg, dim=1)
    so, sw = hit_p - d * 1e-3, seg / dist.clamp(min=1e-20)[:, None]
    st = torch.where(hb.tri >= 0, dist, 0.0)
    ob, _ = _timed(lambda: intersect.occluded_brute_force(so, sw, st, geo.positions, geo.indices))
    blk = 2048
    out = dict(rays=n * n, clean=int(clean.sum()), brute_ms=brute_ms)
    tracers = {
        "packet": (lambda: packet.packet_closest(sc.fat_bvh, o, d, block=blk),
                   lambda: packet.packet_occluded(sc.fat_bvh, so, sw, st, block=blk)),
        "bvh": (lambda: bvh.traverse_closest(sc.bvh, o, d),
                lambda: bvh.traverse_occluded(sc.bvh, so, sw, st)),
    }
    for tracer, (closest_fn, occluded_fn) in tracers.items():
        h, ms = _timed(closest_fn)
        oc, ms_o = _timed(occluded_fn)
        rel = (h.t - hb.t).abs() / hb.t.clamp(min=1e-30)
        same = int(((h.tri == hb.tri) & clean).sum())
        t_rel = float(rel[clean].max()) if bool(clean.any()) else 0.0
        agree_o = float((oc == ob).float().mean())
        cfg = integrator.RenderConfig(width=n, height=n, tracer=tracer, **BENCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, rays = integrator.render_path_with_counts(sc, view, cfg, 0)
        rays = int(rays)
        torch.cuda.synchronize()
        sample_ms = (time.perf_counter() - t0) * 1e3
        assert bool(torch.isfinite(img).all())
        out[tracer] = dict(closest_ms=ms, occluded_ms=ms_o, same_tri_clean=same,
                           t_rel_err=t_rel, occluded_agree=agree_o,
                           sample_ms=sample_ms, sample_rays=rays,
                           image_mean=float(img.mean()))
        print(f"[13 tracers] {name} {n}x{n}: {tracer} closest {ms:.3f} ms (brute "
              f"{brute_ms:.3f} ms), same triangle on {same} of {out['clean']} clean hits, "
              f"t within {t_rel:.2e}; occluded {ms_o:.3f} ms, flags agree {agree_o:.6f}; "
              f"one {n}x{n} sample ({cfg.max_bounces} bounces) {sample_ms:.1f} ms, "
              f"{rays} rays, mean {float(img.mean()):.6f}", flush=True)
        assert same == out["clean"] and t_rel <= T_REL, (tracer, name, out[tracer])
        assert agree_o >= BATCH_AGREE, (tracer, name, agree_o)
    return out


def _colonnade(dev, smi):
    """Phase 13: bench.py's config 4, the textured colonnade -> dict."""
    import numpy as np
    import torch
    from stratum_tpu_torch import profile_sample
    from stratum_tpu_torch.render import camera, integrator
    from stratum_tpu_torch.scene import builtin, flatten, sample_assets

    out_dir = ROOT / "build" / "colonnade"
    t0 = time.perf_counter()
    info = sample_assets.write_colonnade(out_dir)
    t1 = time.perf_counter()
    g = sample_assets.colonnade_graph(info)
    t2 = time.perf_counter()
    scene, stats = flatten.flatten(g.root, device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    tex, fat = scene.textures, scene.fat_bvh
    tex_bytes = tex.flat.numel() * 2 + tex.quad.numel() * 2
    env = scene.env
    env_bytes = sum(x.numel() * 4 for x in (env.emission, env.dist.marginal.pdf,
                                            env.dist.marginal.cdf, env.dist.cond_pdf,
                                            env.dist.cond_cdf, env.lum_mips, env.emission_pdf))
    L, K = fat.leaf_tri.shape
    line = dict(triangles=stats.num_triangles, leaves=L, leaf_size=K,
                write_s=t1 - t0, load_s=t2 - t1, flatten_s=t3 - t2,
                obj_bytes=Path(info["obj"]).stat().st_size,
                textures=dict(count=tex.num_tex, resolution=tex.base_res, levels=tex.num_levels,
                              slot_mask=tex.slot_mask, bytes=tex_bytes),
                env=dict(shape=list(env.emission.shape), bytes=env_bytes))
    print(f"[13 colonnade] {stats.num_triangles} triangles ({Path(info['obj']).stat().st_size} "
          f"B of OBJ), {L} leaves of {K}; write {t1 - t0:.2f} s, load (OBJ, MTL, PNG, HDR) "
          f"{t2 - t1:.2f} s, flatten {t3 - t2:.2f} s; texture stack {tex.num_tex} x "
          f"{tex.base_res}^2, {tex.num_levels} levels, slot mask {tex.slot_mask}, "
          f"{tex_bytes} B; environment {tuple(env.emission.shape)}, tables {env_bytes} B",
          flush=True)
    assert stats.num_triangles == COLONNADE_TRIANGLES, stats
    assert (tex.num_tex, tex.base_res, tex.slot_mask) == COLONNADE_STACK
    W, H = FRAME
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, W, H, device=dev)
    cfg = integrator.RenderConfig(width=W, height=H, **BENCH)
    tracer = integrator.resolved_tracer(scene, cfg)
    assert tracer == "pallas", tracer
    rng = np.random.default_rng(13)
    closest, occluded = _colonnade_waves(scene, view, cfg, rng)
    launches, img, main = _timed_samples(scene, view, cfg, "13 colonnade", "colonnade", smi)
    assert launches == {"block closest": 25, "block occluded": 5, "binned emit": 0,
                        "binned closest": 0, "binned occluded": 0, **DISNEY_5,
                        **FINALIZE_5}, launches
    busy, ops = profile_sample.device_profile(scene, view, cfg, 1)
    split = _texture_layers(scene, view, cfg, 2)
    share = ("not measured: the profiler recorded no device events" if busy is None
             else f"{busy:.3f} ms of a {main['ms_spp']:.1f} ms sample, "
                  f"{100 * busy / main['ms_spp']:.1f} %")
    print(f"[13 colonnade] device busy {share}; top ops "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ops[:6]), flush=True)
    print("[13 colonnade] layer split (ms, a synchronise around each call): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items() if k != "calls"), flush=True)
    main.update(launches=launches, tracer=tracer, device_busy_ms=busy,
                busy_share=None if busy is None else busy / main["ms_spp"], top_ops_ms=ops[:6],
                split_ms={k: v for k, v in split.items() if k != "calls"}, scene=line)
    del scene, img
    torch.cuda.empty_cache()

    # the reference's colonnade_textured golden, rendered on the card
    gg, _ = sample_assets.load_colonnade(ROOT / "build" / "colonnade_golden", **COLONNADE_GOLDEN)
    gs, _ = flatten.flatten(gg.root, device=dev)
    node, cam = flatten.find_camera(gg.root)
    gview = camera.make_view(node.to_world(), cam.fovy, 48, 48, device=dev)
    gcfg = integrator.RenderConfig(width=48, height=48, rr_depth=100, **COLONNADE_GOLDEN_CFG)
    gimg = integrator.render_path_progressive(gs, gview, gcfg, 8).cpu().numpy()
    ref = np.load(ROOT / "tests" / "golden" / "colonnade_textured.npy")
    mean_rel, pix = _parity(gimg, ref)
    print(f"[13 golden] colonnade_textured ({integrator.resolved_tracer(gs, gcfg)}, 8 spp): mean "
          f"{gimg.mean():.6f} vs {ref.mean():.6f} (rel {mean_rel:.2e}), pixels agreeing "
          f"{pix:.4f}", flush=True)
    golden = dict(mean=float(gimg.mean()), ref_mean=float(ref.mean()), mean_rel=mean_rel,
                  pixels=pix)
    tracers = {
        "cornell": _tracer_checks(builtin.cornell_box(), "cornell", dev, rng),
        "colonnade_small": _tracer_checks(gg, "small colonnade", dev, rng),
    }
    return dict(path=main, waves=dict(closest=closest, occluded=occluded), golden=golden,
                tracers=tracers)


CAPS = (1, 1, 0.6, 0.082, 0.031)  # wave_caps the reference measured on its TPU
EQ_RTOL, EQ_ATOL = 1e-5, 1e-7  # the reference's equalities (tests/test_render.py:356-371)
SMOKE_GOLDEN = dict(sigma=0.05)  # tests/update_goldens.py:67-68 (48x48, 8 spp, 3 bounces)
SPHERE_BOX = 256  # sphere-light box frame, analytic against tessellated
SPHERE_BOX_REL = 0.05  # tests/test_spheres.py:101-120


def _whole_wave(fat, occluded, o, d, t, rng, label, phase="14", smi=""):
    """One wave of K1 (closest) or K2 (occluded) timed whole against its
    bound, and held to its plain version on a slice of N_CHECK live lanes
    -> dict."""
    import torch
    from stratum_tpu_torch.ops import block_trace

    limit = t * block_trace.SHADOW_EPS if occluded else t
    prep = block_trace._prepare(fat, o, d, limit)
    _, ms = _timed(lambda: block_trace.launch(fat, prep, occluded), reps=3)
    if occluded:
        blocked = block_trace.block_occluded(fat, o, d, t)
        tests = _needed_tri_tests(fat, o, d, limit, blocked=blocked)
    else:
        hk = block_trace.block_closest(fat, o, d, t)
        tests = _needed_tri_tests(fat, o, d, torch.where(hk.slot >= 0, hk.t, t))
    bound_ms, bound_by = _bound(tests, _block_bytes(fat, prep, occluded))
    del prep
    os_, ds_, ts_ = _wave_slice(o, d, t, rng)
    if occluded:
        ok = block_trace.block_occluded(fat, os_, ds_, ts_)
        op, plain_ms = _timed(lambda: block_trace.block_occluded_plain(fat, os_, ds_, ts_),
                              warmup=False)
        c = _check_occluded(f"{label} slice", ok, op, ts_ > 0)
    else:
        hk = block_trace.block_closest(fat, os_, ds_, ts_)
        hp, plain_ms = _timed(lambda: block_trace.block_closest_plain(fat, os_, ds_, ts_),
                              warmup=False)
        c = _compare_closest(fat, os_, ds_, hk, hp, ts_ > 0)
        _check_closest(f"{label} slice", c)
    print(f"[{phase} waves] {label} ({o.shape[0]} lanes, {int((t > 0).sum())} live): kernel "
          f"{ms:.3f} ms (bound {bound_ms:.3f} ms, {bound_by}; {tests} tests); "
          f"{os_.shape[0]}-lane slice: plain {plain_ms:.3f} ms | {smi}", flush=True)
    return dict(c, ms=ms, plain_slice_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                tests=tests, lanes=o.shape[0], wave_live=int((t > 0).sum()))


def _sync_ms(fn):
    """(result, host ms) of ``fn`` ending in a device synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _glue_split(dev, fn, spp: int):
    """``fn`` (a render of ``spp`` samples) with a synchronise around every
    tracer layer (``profile_sample.timed_layers``) -> ms per sample of the
    whole, the kernels, the rest of the tracer wrappers with the prep,
    ``finalize_hit`` and the glue (everything else)."""
    import torch
    from stratum_tpu_torch import profile_sample

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile_sample.timed_layers(torch.device(dev)) as acc:
        fn()
        torch.cuda.synchronize()
    total = (time.perf_counter() - t0) * 1e3
    ms = {layer: v[0] / spp for layer, v in acc.items()}
    return dict(sample=total / spp, kernel=ms["kernel"], tracer_rest=ms["trace"] - ms["kernel"],
                finalize_hit=ms["finalize_hit"],
                glue=(total / spp) - ms["trace"] - ms["binned"] - ms["finalize_hit"])


def _lanes_run(scene, view, cfg, spp, smi, capture=None):
    """One ``render_path_lanes`` call -> (image, dict of ms/spp, Mrays/s,
    peak GiB, launches)."""
    import torch
    from stratum_tpu_torch.render import integrator

    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    (img, rays), ms = _sync_ms(
        lambda: integrator.render_path_lanes(scene, view, cfg, spp, 0, capture=capture))
    rays = int(rays)
    line = dict(spp=spp, ms_spp=ms / spp, mrays=rays / ms / 1e3, rays=rays,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, mean=float(img.mean()),
                launches=_launches())
    print(f"[14 lanes] spp={spp} ({spp * cfg.width * cfg.height} lanes a wave): "
          f"{line['ms_spp']:.1f} ms/spp, {line['mrays']:.3f} Mrays/s, peak "
          f"{line['peak_gib']:.2f} GiB, launches {line['launches']}, image mean "
          f"{line['mean']:.6f} | {smi}", flush=True)
    assert bool(torch.isfinite(img).all())
    return img, line


def _masked_quad():
    """The reference's alpha-test scene (tests/test_texture.py:143-205): a
    quad whose left half is cut out, in front of a larger emitter facing
    the camera."""
    import numpy as np
    from stratum_tpu_torch.scene.graph import MeshPrimitive, NodeGraph
    from stratum_tpu_torch.scene.material import Material

    mask = np.ones((8, 8, 4), np.float32)
    mask[:, :4, 3] = 0.0
    quad = np.asarray([[-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32)
    uvq = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    g = NodeGraph()
    g.root.add_child("masked").make_component(MeshPrimitive(
        positions=quad, indices=idx, uvs=uvq, material=Material(alpha_image=mask)))
    g.root.add_child("emitter").make_component(MeshPrimitive(
        positions=quad * np.asarray([3, 3, 1], np.float32) + np.asarray([0, 0, 2], np.float32),
        indices=idx[:, ::-1].copy(),
        material=Material(base_color=np.zeros(3, np.float32),
                          emission=np.full(3, 5.0, np.float32))))
    return g


def _sphere_light_box(analytic):
    """The reference's floor lit by one emissive sphere
    (tests/test_spheres.py:60-98), analytic or tessellated 48 x 96."""
    import numpy as np
    from stratum_tpu_torch.core.transform import look_at
    from stratum_tpu_torch.scene.graph import (CameraComponent, MeshPrimitive, NodeGraph,
                                               SpherePrimitive, TransformComponent)
    from stratum_tpu_torch.scene.material import Material

    g = NodeGraph()
    s = 10.0
    g.root.add_child("floor").make_component(MeshPrimitive(
        positions=np.asarray([[-s, 0, -s], [-s, 0, s], [s, 0, s], [s, 0, -s]], np.float32),
        indices=np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
        material=Material(base_color=np.full(3, 0.6, np.float32))))
    lamp = g.root.add_child("lamp")
    t = np.eye(3, 4, dtype=np.float32)
    t[:, 3] = (0.0, 4.0, 0.0)
    lamp.make_component(TransformComponent(matrix=t))
    lamp.make_component(SpherePrimitive(
        radius=0.5, material=Material(base_color=np.zeros(3, np.float32),
                                      emission=np.full(3, 40.0, np.float32)),
        analytic=analytic, stacks=48, slices=96))
    cam = g.root.add_child("camera")
    cam.make_component(TransformComponent(matrix=look_at((0.0, 3.0, -8.0), (0.0, 1.0, 0.0))))
    cam.make_component(CameraComponent(fovy=np.radians(45.0)))
    return g


def _wavefront(dev, smi, scene, view, main5, img5):
    """Phase 14: the rest of the path integrator on the full atrium at
    1920x1080 (batched and lane-batched samples, wave_caps, RIS, NEE and
    MIS off), the alpha test, the smoky Cornell box and analytic spheres
    -> dict for the JSON line's ``paths``."""
    import dataclasses

    import numpy as np
    import torch
    from stratum_tpu_torch import profile_sample
    from stratum_tpu_torch.ops import block_trace
    from stratum_tpu_torch.render import camera, integrator
    from stratum_tpu_torch.scene import builtin, flatten

    W, H = FRAME
    n = W * H
    fat = scene.fat_bvh
    rng = np.random.default_rng(14)
    cfg = integrator.RenderConfig(width=W, height=H, **BENCH)
    out = {}

    def rel(a, b):
        return abs(a - b) / b

    # -- render_path_batched against render_path_progressive, seeds 0-3 ----
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    (img_b, rays_b), ms_b = _sync_ms(lambda: integrator.render_path_batched(scene, view, cfg, 4, 0))
    launches_b = _launches()
    img_p = integrator.render_path_progressive(scene, view, cfg, 4, 0)
    singles = [integrator.render_path_with_counts(scene, view, cfg, s) for s in range(4)]
    counts = [int(c) for _, c in singles]
    seq_mean = {2: float((singles[0][0] + singles[1][0]).mean()) / 2, 4: float(img_p.mean())}
    del singles
    diff = float((img_b - img_p).abs().max())
    out["batched"] = dict(ms_spp=ms_b / 4, mrays=int(rays_b) / ms_b / 1e3, rays=int(rays_b),
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                          max_abs_diff_progressive=diff, launches=launches_b,
                          mean=float(img_b.mean()))
    print(f"[14 batched] spp=4: {ms_b / 4:.1f} ms/spp, {out['batched']['mrays']:.3f} Mrays/s, "
          f"peak {out['batched']['peak_gib']:.2f} GiB, launches {launches_b}; vs "
          f"render_path_progressive max |diff| {diff:.3e}; n_rays {int(rays_b)} = sum of "
          f"{counts} ({sum(counts)}) | {smi}", flush=True)
    torch.testing.assert_close(img_b, img_p, rtol=EQ_RTOL, atol=EQ_ATOL)
    assert int(rays_b) == sum(counts)
    assert launches_b == {"closest": 20, "occluded": 4}, launches_b
    del img_b, img_p

    # -- render_path_lanes ------------------------------------------------------
    out["lanes"] = {}
    for spp in (2, 4):
        waves = {} if spp == 4 else None
        img_l, line = _lanes_run(scene, view, cfg, spp, smi, capture=waves)
        line["mean_rel_sequential"] = rel(line["mean"], seq_mean[spp])
        print(f"[14 lanes] spp={spp}: image mean {line['mean']:.6f} vs the mean of the "
              f"sequential samples at seeds 0-{spp - 1} {seq_mean[spp]:.6f} "
              f"(rel {line['mean_rel_sequential']:.2e})", flush=True)
        assert line["mean_rel_sequential"] <= PARITY_MEAN_REL
        assert line["launches"] == {"closest": 5, "occluded": 1}, line["launches"]
        out["lanes"][f"spp{spp}"] = line
        del img_l
    # the lanes = 4 waves: 5 closest waves of 4 x W x H lanes, the deferred
    # wave of 5 x 4 x W x H
    assert [w[0].shape[0] for w in waves["closest"]] == [4 * n] * 5
    ((o, w, t),) = waves["occluded"]
    assert t.shape[0] == 20 * n
    out["lanes"]["closest_wave1"] = _whole_wave(fat, False, *waves["closest"][1], rng,
                                                "lanes=4 closest wave 1", smi=smi)
    del waves
    out["lanes"]["deferred"] = _whole_wave(fat, True, o, w, t, rng, "lanes=4 deferred wave",
                                           smi=smi)
    del o, w, t
    torch.cuda.empty_cache()
    nopre = dataclasses.replace(cfg, presample_lights=0, coherent_tiles=0)
    img_l, _ = integrator.render_path_lanes(scene, view, nopre, 2, 0)
    img_s = integrator.render_path_progressive(scene, view, nopre, 2, 0)
    diff = float((img_l - img_s).abs().max())
    print(f"[14 lanes] presample_lights=0, spp=2: lanes vs sequential max |diff| {diff:.3e}",
          flush=True)
    torch.testing.assert_close(img_l, img_s, rtol=EQ_RTOL, atol=EQ_ATOL)
    out["lanes"]["nopresample_max_abs_diff"] = diff
    del img_l, img_s

    # -- wave_caps ------------------------------------------------------------
    caps_cfg = dataclasses.replace(cfg, wave_caps=CAPS)
    waves = {}
    integrator.render_path_with_counts(scene, view, cfg, 0, capture=waves)
    alive = [int((tm > 0).sum()) for _, _, tm in waves["closest"]]
    budgets = [integrator._budget(caps_cfg, b, n) for b in range(cfg.max_bounces + 1)]
    binds = [a > bgt for a, bgt in zip(alive, budgets)]
    print("[14 wave_caps] phase 5's sample (seed 0): alive share per bounce "
          + ", ".join(f"{b}: {a / n:.4f} (cap {bgt / n:.4f}, {'binds' if bd else 'free'})"
                      for b, (a, bgt, bd) in enumerate(zip(alive, budgets, binds))), flush=True)
    del waves
    launches_c, img_c, line = _timed_samples(scene, view, caps_cfg, "14 wave_caps", "atrium",
                                             smi)
    busy, ops = profile_sample.device_profile(scene, view, caps_cfg, 1)
    line.update(launches=launches_c, alive_share=[a / n for a in alive],
                budgets=budgets, binds=binds, device_busy_ms=busy,
                busy_share=None if busy is None else busy / line["ms_spp"], top_ops_ms=ops[:4],
                mean_rel_phase5=rel(line["mean"], main5["mean"]))
    share = ("not measured: the profiler recorded no device events" if busy is None
             else f"{busy:.3f} ms of a {line['ms_spp']:.1f} ms sample, "
                  f"{100 * busy / line['ms_spp']:.1f} %")
    print(f"[14 wave_caps] {line['ms_spp']:.1f} ms/spp vs {main5['ms_spp']:.1f} (phase 5); "
          f"device busy {share}; image mean {line['mean']:.6f} vs {main5['mean']:.6f} "
          f"(rel {line['mean_rel_phase5']:.2e})", flush=True)
    assert line["mean_rel_phase5"] <= PARITY_MEAN_REL
    waves = {}
    integrator.render_path_with_counts(scene, view, caps_cfg, 1, capture=waves)
    lanes_c = [wv[0].shape[0] for wv in waves["closest"]]
    print(f"[14 wave_caps] closest wave lanes {lanes_c}, deferred wave "
          f"{waves['occluded'][0][0].shape[0]} lanes", flush=True)
    assert lanes_c == budgets, lanes_c
    o, d, tm = waves["closest"][3]
    del waves
    line["compacted_wave3"] = _whole_wave(fat, False, o, d, tm, rng, "wave_caps closest wave 3",
                                          smi=smi)
    live = tm > 0  # its live lanes alone: a count that is not whole CTAs
    o_l, d_l, t_l = o[live], d[live], tm[live]
    hk = block_trace.block_closest(fat, o_l, d_l, t_l)
    hp = block_trace.block_closest_plain(fat, o_l, d_l, t_l)
    c = _compare_closest(fat, o_l, d_l, hk, hp)
    print(f"[14 waves] wave_caps closest wave 3, live lanes only ({o_l.shape[0]} lanes, "
          f"{o_l.shape[0] % block_trace.CTA} past the last whole CTA): {c}", flush=True)
    _check_closest("wave_caps closest wave 3 live lanes", c)
    line["compacted_wave3_live"] = c
    del o, d, tm, o_l, d_l, t_l, hk, hp
    seed5 = 4  # phase 5's last sample
    img_free, _ = integrator.render_path_with_counts(
        scene, view, dataclasses.replace(cfg, wave_caps=(1.0,)), seed5)
    diff = float((img_free - img5).abs().max())
    print(f"[14 wave_caps] caps (1.0,) vs phase 5's sample {seed5}: max |diff| {diff:.3e}",
          flush=True)
    torch.testing.assert_close(img_free, img5, rtol=EQ_RTOL, atol=EQ_ATOL)
    line["nonbinding_max_abs_diff"] = diff
    out["wave_caps"] = line
    del img_c, img_free
    torch.cuda.empty_cache()

    # -- the glue with and without compaction or lane batching, one call -----
    splits = {}
    for label, fn, spp in (
        ("plain", lambda: integrator.render_path_with_counts(scene, view, cfg, 1), 1),
        ("wave_caps", lambda: integrator.render_path_with_counts(scene, view, caps_cfg, 1), 1),
        ("lanes2", lambda: integrator.render_path_lanes(scene, view, cfg, 2, 0), 2),
        ("lanes4", lambda: integrator.render_path_lanes(scene, view, cfg, 4, 0), 4),
    ):
        splits[label] = _glue_split(dev, fn, spp)
        print(f"[14 split] {label}: per sample {splits[label]['sample']:.1f} ms = kernels "
              f"{splits[label]['kernel']:.1f} + prep and wrappers "
              f"{splits[label]['tracer_rest']:.1f} + finalize_hit "
              f"{splits[label]['finalize_hit']:.1f} + glue {splits[label]['glue']:.1f} ms "
              f"(a synchronise around each tracer layer)", flush=True)
    busy, ops = profile_sample.device_profile(scene, view, cfg, 1)
    splits["plain"].update(device_busy_ms=busy)
    print(f"[14 split] plain sample device busy "
          + ("not measured" if busy is None else f"{busy:.3f} ms"), flush=True)
    out["glue_split"] = splits

    # -- RIS, NEE off, MIS off ------------------------------------------------
    _, _, line = _timed_samples(scene, view, dataclasses.replace(cfg, ris_candidates=4),
                                "14 ris", "atrium", smi, samples=3)
    line["mean_rel_phase5"] = rel(line["mean"], main5["mean"])
    print(f"[14 ris] ris_candidates=4: image mean {line['mean']:.6f} vs {main5['mean']:.6f} "
          f"(phase 5; rel {line['mean_rel_phase5']:.2e})", flush=True)
    assert line["mean_rel_phase5"] <= PARITY_MEAN_REL
    out["ris"] = line
    for name, kw in (("nee_off", dict(use_nee=False)), ("mis_off", dict(use_mis=False))):
        (img, rays), ms = _sync_ms(lambda: integrator.render_path_with_counts(
            scene, view, dataclasses.replace(cfg, **kw), 1))
        out[name] = dict(ms=ms, rays=int(rays), mean=float(img.mean()))
        print(f"[14 {name}] {kw}: one sample {ms:.1f} ms, {int(rays)} rays, image mean "
              f"{out[name]['mean']:.6f} (phase 5 {main5['mean']:.6f})", flush=True)
        assert bool(torch.isfinite(img).all()) and out[name]["mean"] > 0
    del img

    # -- the alpha test -------------------------------------------------------
    from stratum_tpu_torch.core.transform import look_at

    quad, _ = flatten.flatten(_masked_quad().root, device=dev)
    qview = camera.make_view(look_at((0, 0, -2), (0, 0, 1)), np.radians(40), W, H, device=dev)
    # the quad spans 24-76 % of the width (16:9, vertical fov 40 degrees, 3 away)
    left = np.s_[int(0.15 * H):int(0.85 * H), int(0.28 * W):int(0.46 * W)]
    right = np.s_[int(0.15 * H):int(0.85 * H), int(0.54 * W):int(0.72 * W)]
    out["alpha"] = {}
    for tracer in ("pallas", "auto"):
        res = {}
        for at in (True, False):
            acfg = integrator.RenderConfig(width=W, height=H, max_bounces=1, alpha_test=at,
                                           tracer=tracer)
            cuda_build.reset_launches()
            img, ms = _sync_ms(lambda: integrator.render_path(quad, qview, acfg, 0))
            img = img.cpu().numpy()
            res[at] = dict(ms=ms, left_mean=float(img[left].mean()),
                           right_max=float(img[right].max()), launches=_launches())
        print(f"[14 alpha] {tracer} ({integrator.resolved_tracer(quad, acfg)}) {W}x{H}: "
              f"alpha_test on: cut-out half mean {res[True]['left_mean']:.4f}, opaque half "
              f"max {res[True]['right_max']:.4f}, {res[True]['ms']:.1f} ms, launches "
              f"{res[True]['launches']}; off: cut-out half mean {res[False]['left_mean']:.4f}",
              flush=True)
        assert res[True]["left_mean"] >= 4.0 and res[True]["right_max"] < 4.0
        assert res[False]["left_mean"] < 4.0
        if tracer == "pallas":  # each bounce re-traces 3 times past cut-out texels
            assert res[True]["launches"]["closest"] == 2 * 4, res[True]["launches"]
        out["alpha"][tracer] = res
    del quad

    # -- participating media --------------------------------------------------
    g = builtin.smoky_cornell()
    smoke, _ = flatten.flatten(g.root, device=dev)
    node, cam = flatten.find_camera(g.root)
    sview = camera.make_view(node.to_world(), cam.fovy, W, H, device=dev)
    scfg = integrator.RenderConfig(width=W, height=H, **CORNELL)
    assert integrator.resolved_tracer(smoke, scfg) == "mxu"
    _, _, line = _timed_samples(smoke, sview, scfg, "14 smoke", "smoky_cornell", smi,
                                samples=3)
    out["smoke"] = line
    del smoke
    g = builtin.smoky_cornell(**SMOKE_GOLDEN)
    smoke, _ = flatten.flatten(g.root, device=dev)
    gview = camera.make_view(node.to_world(), cam.fovy, 48, 48, device=dev)
    img = integrator.render_path_progressive(
        smoke, gview, integrator.RenderConfig(width=48, height=48, rr_depth=100, max_bounces=3),
        8).cpu().numpy()
    ref = np.load(ROOT / "tests" / "golden" / "cornell_smoke.npy")
    mean_rel, pix = _parity(img, ref)
    out["smoke"]["golden"] = dict(mean=float(img.mean()), ref_mean=float(ref.mean()),
                                  mean_rel=mean_rel, pixels=pix)
    print(f"[14 smoke] cornell_smoke golden (48x48, 8 spp): mean {img.mean():.6f} vs "
          f"{ref.mean():.6f} (rel {mean_rel:.2e}), pixels agreeing {pix:.4f}", flush=True)
    del smoke

    # -- analytic spheres -----------------------------------------------------
    from stratum_tpu_torch.scene.graph import SpherePrimitive, TransformComponent

    g = builtin.furnace()
    for _, prim in g.root.find_in_descendants(SpherePrimitive):
        prim.analytic = True
    furn, _ = flatten.flatten(g.root, device=dev)
    node, cam = flatten.find_camera(g.root)
    fn = 128
    img = integrator.render_path_progressive(
        furn, camera.make_view(node.to_world(), cam.fovy, fn, fn, device=dev),
        integrator.RenderConfig(width=fn, height=fn, max_bounces=4), 16).cpu().numpy()
    px, py = np.meshgrid(np.arange(fn) + 0.5, np.arange(fn) + 0.5)
    tan = np.hypot(px - fn / 2, py - fn / 2) / (fn / 2) * np.tan(np.radians(22.5))
    sphere_mean = float(img[tan < 0.2].mean())
    env_exact = bool(np.all(img[tan > 0.3] == np.float32(0.5)))
    print(f"[14 spheres] analytic furnace {fn}x{fn}, 16 spp: environment pixels all 0.5: "
          f"{env_exact}; sphere mean {sphere_mean:.6f} (0.4, bound {FURNACE_REL:.0%})",
          flush=True)
    assert env_exact and abs(sphere_mean - 0.4) <= FURNACE_REL * 0.4
    out["spheres"] = dict(furnace_sphere_mean=sphere_mean, furnace_env_exact=env_exact)
    imgs = {}
    for analytic in (True, False):
        g = _sphere_light_box(analytic)
        box, _ = flatten.flatten(g.root, device=dev)
        node, cam = flatten.find_camera(g.root)
        bcfg = integrator.RenderConfig(width=SPHERE_BOX, height=SPHERE_BOX, max_bounces=2)
        imgs[analytic], ms = _sync_ms(lambda: integrator.render_path_progressive(
            box, camera.make_view(node.to_world(), cam.fovy, SPHERE_BOX, SPHERE_BOX,
                                  device=dev), bcfg, 16))
        imgs[analytic] = imgs[analytic].cpu().numpy()
        out["spheres"][f"box_{'analytic' if analytic else 'tessellated'}_ms"] = ms
    # the block tracer with spheres: the merged hits drop the fused payload
    # and resolve by one tri_payload gather (reference :418-431)
    g = builtin.atrium()
    ball = g.root.add_child("ball")
    t = np.eye(3, 4, dtype=np.float32)
    t[:, 3] = (0.0, 1.5, 0.0)
    ball.make_component(TransformComponent(matrix=t))
    ball.make_component(SpherePrimitive(radius=1.5, analytic=True))
    ball_scene, _ = flatten.flatten(g.root, device=dev)
    _, _, line = _timed_samples(ball_scene, view, cfg, "14 spheres", "atrium + 1 analytic sphere",
                                smi, samples=3)
    out["spheres"]["atrium_ball"] = line
    print(f"[14 spheres] atrium + 1 analytic sphere: {line['ms_spp']:.1f} ms/spp vs "
          f"{main5['ms_spp']:.1f} (phase 5)", flush=True)
    del ball_scene
    a, t_ = imgs[True], imgs[False]
    mask = t_.max(axis=-1) < 5.0  # off the emitter's disc
    box_rel = rel(float(a[mask].mean()), float(t_[mask].mean()))
    print(f"[14 spheres] sphere-light box {SPHERE_BOX}x{SPHERE_BOX}, 16 spp: analytic mean "
          f"{a[mask].mean():.6f} vs tessellated {t_[mask].mean():.6f} (rel {box_rel:.2e}, "
          f"bound {SPHERE_BOX_REL:.0%})", flush=True)
    assert np.isfinite(a).all() and box_rel <= SPHERE_BOX_REL
    out["spheres"]["box_mean_rel"] = box_rel
    return out


BDPT = dict(max_bounces=3, bsdf="disney", sort_rays=True, lvc_connections=4,
            presample_lights=4096)  # bench.py:176-179
BDPT_CHUNKS = 16  # bench.py:181: 129,600 lanes a chunk at 1080p
# per sample: 4 camera and 4 light closest waves a chunk; the s = 1, LVC and
# t = 1 occlusion batches a chunk
BDPT_LAUNCHES = {"closest": 8 * BDPT_CHUNKS, "occluded": 3 * BDPT_CHUNKS}
SMALL = (480, 270)  # the chunk and estimator checks (one 1080p chunk's pixels)
CHUNK_RTOL, CHUNK_ATOL = 1e-4, 1e-6  # tests/test_bdpt.py:203 (paired, 16 chunks vs 1)
BDPT_PT_REL = 0.05  # tests/test_bdpt.py:29, BDPT's mean against the path tracer's
LVC_REUSE_REL = 0.06  # tests/test_bdpt.py:185, reuse against no reuse
ESTIMATOR_SPP = 4  # samples of each side of the estimator checks at SMALL


def _timed_runs(label, fn, seeds, smi, lanes):
    """``fn(seed)`` over ``seeds`` (the first a warm-up) with the launch
    registry reset after the warm-up -> (last result, dict of ms per call,
    peak GiB, launches)."""
    import torch

    fn(seeds[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    times = []
    for seed in seeds[1:]:
        out, ms = _sync_ms(lambda: fn(seed))
        times.append(ms)
    launches = _launches()
    binned_launches = {k: v for k, v in cuda_build.launches().items() if k.startswith("binned")}
    assert not binned_launches, binned_launches
    line = dict(ms=times, ms_mean=sum(times) / len(times),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                launches={k: v / len(times) for k, v in launches.items()})
    print(f"[15 {label}] {lanes}: {', '.join(f'{t:.1f}' for t in times)} ms "
          f"(mean {line['ms_mean']:.1f}), peak {line['peak_gib']:.2f} GiB, launches a call "
          f"{line['launches']} | {smi}", flush=True)
    return out, line


def _bdpt_phase(dev, smi, scene, view, main5, img5):
    """Phase 15: BDPT at bench.py's configuration on the full atrium at
    1920x1080 in 16 chunks (its waves through K1/K2, timed samples, the
    launch counts, determinism, chunked = unchunked, BDPT = PT and
    cross-frame reuse at 480x270), then light tracing, ReSTIR DI, adaptive
    sampling, the Kronecker lattice and indirect_only -> (dict for the
    JSON line's ``paths``, K1 and K2 wave records)."""
    import dataclasses

    import numpy as np
    import torch
    from stratum_tpu_torch import profile_sample
    from stratum_tpu_torch.core import rng as srng
    from stratum_tpu_torch.ops import block_trace
    from stratum_tpu_torch.render import adaptive, bdpt, camera, integrator, lighttrace, restir
    from stratum_tpu_torch.scene import builtin, flatten

    W, H = FRAME
    n = W * H
    fat = scene.fat_bvh
    rng = np.random.default_rng(15)
    cfg = integrator.RenderConfig(width=W, height=H, **BDPT)
    assert integrator.resolved_tracer(scene, cfg) == "pallas"
    out = {}

    # -- one chunk's waves, as the wrappers get them -------------------------
    per = n // BDPT_CHUNKS
    px, py = camera.pixel_grid(W, H, dev)
    waves = {}
    bdpt.trace_bdpt(scene, view, cfg, 1, px[:per], py[:per], lane0=0, num_light_paths=n,
                    capture=waves)
    assert [w[0].shape[0] for w in waves["closest"]] == [per] * 8, len(waves["closest"])
    assert [w[0].shape[0] for w in waves["occluded"]] == [4 * per, 4 * per, 5 * per]
    lists = {}
    # the walks trace camera wave i, then light wave i
    for name, i in (("camera", 0), ("light", 1)):
        o, d, tm = waves["closest"][i]
        prep = block_trace._prepare(fat, o, d, tm)
        *_, st = block_trace.launch(fat, prep, False, stats="ncand")
        lists[name] = float(st.ncand.float().mean())
        del prep
    print(f"[15 lists] candidate groups per CTA, wave 0: camera {lists['camera']:.2f}, "
          f"light (from the emitters) {lists['light']:.2f}", flush=True)
    k1, k2 = {}, {}
    for label, i in (("camera wave 0", 0), ("camera wave 1", 2), ("light wave 0", 1),
                     ("light wave 1", 3)):
        o, d, tm = waves["closest"][i]
        k1[label] = _whole_wave(fat, False, o, d, tm, rng, f"BDPT {label}", "15", smi)
    for label, i in (("s=1 batch", 0), ("LVC batch", 1), ("t=1 splat batch", 2)):
        o, w, t = waves["occluded"][i]
        k2[label] = _whole_wave(fat, True, o, w, t, rng, f"BDPT {label}", "15", smi)
    del waves
    torch.cuda.empty_cache()

    # -- timed samples, launch counts, determinism, busy share ---------------
    def bdpt_sample(seed):
        return bdpt.render_bdpt_chunked(scene, view, cfg, seed, chunks=BDPT_CHUNKS)

    img, line = _timed_runs("BDPT", bdpt_sample, [0, 1, 2], smi, f"atrium {W}x{H}, "
                            f"{BDPT_CHUNKS} chunks of {per} lanes")
    assert line["launches"] == BDPT_LAUNCHES, line["launches"]
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
    same = torch.equal(img, bdpt_sample(2))
    busy, ops = profile_sample.device_profile(
        scene, view, cfg, 3, render=lambda s, v, c, seed: bdpt_sample(seed), cpu_ops=False)
    line.update(mean=float(img.mean()), same_seed_equal=same, busy_ms=busy,
                busy_share=None if busy is None else busy / line["ms_mean"],
                top_kernels=ops, lists=lists)
    print(f"[15 BDPT] {line['ms_mean']:.1f} ms/spp, image mean {line['mean']:.6f}, same-seed "
          f"renders bit-equal: {same}, device busy {busy} ms "
          f"({line['busy_share']}), top kernels {ops} | {smi}", flush=True)
    assert same
    out["bdpt"] = line

    # -- chunked = unchunked, BDPT = PT, reuse at 480x270 --------------------
    sw, sh = SMALL
    node, cam = flatten.find_camera(builtin.atrium().root)
    view_s = camera.make_view(node.to_world(), cam.fovy, sw, sh, device=dev)
    cfg_s = integrator.RenderConfig(width=sw, height=sh, **BDPT)
    paired = dataclasses.replace(cfg_s, lvc_connections=0)
    full = bdpt.render_bdpt_chunked(scene, view_s, paired, 5, chunks=1)
    chunked = bdpt.render_bdpt_chunked(scene, view_s, paired, 5, chunks=BDPT_CHUNKS)
    diff = torch.abs(chunked - full)
    exact = float((chunked == full).all(dim=-1).float().mean())
    within = bool((diff <= CHUNK_ATOL + CHUNK_RTOL * torch.abs(full)).all())
    bd = bdpt.render_bdpt_progressive(scene, view_s, cfg_s, ESTIMATOR_SPP, 10, 1)
    pt = integrator.render_path_progressive(
        scene, view_s, integrator.RenderConfig(width=sw, height=sh, max_bounces=3,
                                               bsdf="disney"), ESTIMATOR_SPP, 10)
    acc, state = torch.zeros_like(bd), None
    for s in range(2):
        frame, state = bdpt.render_bdpt_reuse(scene, view_s, cfg_s, 20 + s, state)
        assert bool(torch.isfinite(frame).all())
        acc = acc + frame
    base = bdpt.render_bdpt_progressive(scene, view_s, cfg_s, 2, 20, 1)
    est = dict(chunk_exact_share=exact, chunk_max_abs=float(diff.max()), chunk_within=within,
               bdpt_mean=float(bd.mean()), pt_mean=float(pt.mean()),
               reuse_mean=float(acc.mean() / 2), no_reuse_mean=float(base.mean()),
               reuse_state_rows=int(state["pos"].shape[0]))
    est["bdpt_pt_rel"] = abs(est["bdpt_mean"] - est["pt_mean"]) / est["pt_mean"]
    est["reuse_rel"] = abs(est["reuse_mean"] - est["no_reuse_mean"]) / est["no_reuse_mean"]
    print(f"[15 estimator] {sw}x{sh}: paired 16 chunks vs 1 within rtol {CHUNK_RTOL} / atol "
          f"{CHUNK_ATOL}: {within} (bit-equal pixels {exact:.4f}, max |diff| "
          f"{est['chunk_max_abs']:.3g}); BDPT {ESTIMATOR_SPP} spp mean {est['bdpt_mean']:.6f} vs "
          f"PT {est['pt_mean']:.6f} (rel {est['bdpt_pt_rel']:.3e}, bound {BDPT_PT_REL}); "
          f"reuse 2 frames {est['reuse_mean']:.6f} vs no reuse {est['no_reuse_mean']:.6f} "
          f"(rel {est['reuse_rel']:.3e}, bound {LVC_REUSE_REL}) | {smi}", flush=True)
    assert within and exact > 0.9
    assert bool(torch.isfinite(bd).all()) and est["bdpt_pt_rel"] <= BDPT_PT_REL
    assert est["reuse_rel"] <= LVC_REUSE_REL
    out["bdpt_estimator"] = est
    del full, chunked, bd, pt, acc, state, base
    torch.cuda.empty_cache()

    # -- light tracing -------------------------------------------------------
    lt_cfg = integrator.RenderConfig(width=W, height=H, max_bounces=3, bsdf="disney")
    img, line = _timed_runs("LT", lambda seed: lighttrace.render_lt(scene, view, lt_cfg, seed),
                            [0, 1, 2], smi, f"render_lt atrium {W}x{H}, {n} light paths")
    assert line["launches"] == {"closest": 5, "occluded": 4}, line["launches"]
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
    out["lt"] = dict(line, mean=float(img.mean()))

    # -- ReSTIR DI: three frames, the state fed back --------------------------
    rs_cfg = integrator.RenderConfig(width=W, height=H, max_bounces=3, bsdf="disney")
    state = restir.init_restir(n, device=dev)
    frames = []
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    for s in range(3):
        (state, img), ms = _sync_ms(lambda: restir.restir_di(
            scene, view, rs_cfg, state, s, candidates=4, spatial_taps=2))
        frames.append(ms)
        assert bool(torch.isfinite(img).all())
    line = dict(ms=frames, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                launches=_launches(), mean=float(img.mean()),
                m_mean=float(state.m.mean()))
    print(f"[15 ReSTIR] candidates 4, spatial_taps 2, {W}x{H}: frames "
          f"{', '.join(f'{t:.1f}' for t in frames)} ms, "
          f"peak {line['peak_gib']:.2f} GiB, launches {line['launches']}, image mean "
          f"{line['mean']:.6f}, mean M {line['m_mean']:.2f} | {smi}", flush=True)
    assert line["launches"] == {"closest": 3, "occluded": 3} and line["m_mean"] > 4
    out["restir"] = line

    # -- adaptive sampling -----------------------------------------------------
    ad_cfg = integrator.RenderConfig(width=W, height=H, **BENCH)
    torch.cuda.reset_peak_memory_stats()
    (img, st), ms = _sync_ms(lambda: adaptive.render_adaptive(scene, view, ad_cfg, 4, pilot=2,
                                                              frac=0.25, seed0=0))
    cnt = st.count
    line = dict(ms=ms, ms_per_budget_spp=ms / 4, count_mean=float(cnt.mean()),
                count_min=float(cnt.min()), count_max=float(cnt.max()), mean=float(img.mean()),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"[15 adaptive] a 4 spp budget, pilot 2, frac 0.25, {W}x{H}: {ms:.1f} ms "
          f"({line['ms_per_budget_spp']:.1f} ms per spp of budget), counts mean "
          f"{line['count_mean']:.4f} min {line['count_min']} max {line['count_max']}, image "
          f"mean {line['mean']:.6f} vs phase 5 {main5['mean']:.6f}, peak "
          f"{line['peak_gib']:.2f} GiB | {smi}", flush=True)
    assert bool(torch.isfinite(img).all()) and abs(line["count_mean"] - 4) <= 0.01
    assert abs(line["mean"] - main5["mean"]) <= PARITY_MEAN_REL * main5["mean"]
    out["adaptive"] = line

    # -- the Kronecker lattice, then indirect_only ----------------------------
    seed = 4  # phase 5's last sample
    old = srng.QMC
    srng.QMC = "kron"
    try:
        (kimg, _), ms = _sync_ms(lambda: integrator.render_path_with_counts(
            scene, view, integrator.RenderConfig(width=W, height=H, **BENCH), seed))
    finally:
        srng.QMC = old
    rel = abs(float(kimg.mean()) - main5["mean"]) / main5["mean"]
    out["kron"] = dict(ms=ms, mean=float(kimg.mean()), rel=rel, differs=not torch.equal(kimg, img5))
    print(f"[15 kron] one sample {ms:.1f} ms, image mean {out['kron']['mean']:.6f} vs rand "
          f"{main5['mean']:.6f} (rel {rel:.3e}, bound {PARITY_MEAN_REL}); QMC restored to "
          f"{srng.QMC!r} | {smi}", flush=True)
    assert srng.QMC == "rand" and rel <= PARITY_MEAN_REL and out["kron"]["differs"]
    assert bool(torch.isfinite(kimg).all())
    (iimg, n_rays), ms = _sync_ms(lambda: integrator.render_path_with_counts(
        scene, view, integrator.RenderConfig(width=W, height=H, indirect_only=True, **BENCH),
        seed))
    out["indirect_only"] = dict(ms=ms, mean=float(iimg.mean()), rays=int(n_rays))
    print(f"[15 indirect_only] one sample {ms:.1f} ms, image mean "
          f"{out['indirect_only']['mean']:.6f} (the full sample's {main5['mean']:.6f}) | {smi}",
          flush=True)
    assert bool(torch.isfinite(iimg).all()) and 0 < out["indirect_only"]["mean"] < main5["mean"]
    return out, k1, k2


FRAME_LAUNCHES = {"closest": 5, "occluded": 1}  # one denoised frame's sample
# tests/test_torch_denoise.py's DEN_TOL, doubled; the whole pass on a share of the pixels
DEN_RTOL, DEN_ATOL = 2 * 1e-5, 2 * 1e-6
DEN_WHOLE_SHARE = 0.99
PATH_SUM_RTOL, PATH_SUM_ATOL = 1e-4, 1e-5  # tests/test_torch_session.py's path-length sum
ANIMATED = "col_1.0_2_2"  # the atrium's pillar piece that phase 16 animates
ANIMATED_PIXELS = 100  # pixels of it the 1080p view must see


class _SplitTimer:
    """Wraps module functions so each call is timed on the host clock with
    a synchronise before and after it; ``ms`` sums them by label."""

    def __init__(self, targets):
        self.targets = targets  # label -> (module, attribute)
        self.ms = {k: 0.0 for k in targets}
        self._saved = {}

    def __enter__(self):
        for label, (mod, attr) in self.targets.items():
            fn = getattr(mod, attr)
            self._saved[label] = fn

            def timed(*a, _fn=fn, _label=label, **kw):
                out, ms = _sync_ms(lambda: _fn(*a, **kw))
                self.ms[_label] += ms
                return out

            setattr(mod, attr, timed)
        return self

    def __exit__(self, *exc):
        for label, (mod, attr) in self.targets.items():
            setattr(mod, attr, self._saved[label])


ATROUS_REPS = 10  # a-trous filter calls the kernel's per-launch times come from
_ATROUS_NAME = re.compile(r"atrous_kernel")


ATROUS_TAP_FP32 = 29  # f32 adds, multiplies and maxes of a tap (csrc/atrous.cu; none fused)
ATROUS_TAP_SFU = 5  # at the least: ex2 for each expf and for powf, rcp for each division


def _atrous_bound(h, w, it, iters, history_tap, ntaps):
    """(least ms, what bounds it) of a-trous launch ``it``: the bytes the
    iteration needs, each read and each write once, at the memory rate
    (colour, variance, normal and depth in, 32 B a pixel; colour | variance
    out for the next, 16 B, unless it is the last; colour, 12 B, if it is
    the last or the history tap's: the guide and dz the kernel keeps are
    its layout's, not needed bytes), or the arithmetic of ``ntaps`` taps a
    pixel, each ATROUS_TAP_FP32 instructions at the f32 lanes' rate (one a
    lane a clock, none fused) and ATROUS_TAP_SFU at the special-function
    units', whichever takes longest."""
    per = 32 + (0 if it + 1 == iters else 16) + (12 if it + 1 in (iters, history_tap) else 0)
    bytes_ms = per * h * w / PEAK_BYTES_S * 1e3
    taps = h * w * ntaps
    ops_ms = max(taps * ATROUS_TAP_FP32 / (PEAK_F32_FLOPS / 2),
                 taps * ATROUS_TAP_SFU / PEAK_SFU_S) * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _traced_atrous(dev, fn) -> dict:
    """The registry's a-trous launches over one call of ``fn`` (reset before it) beside
    the ``atrous_kernel`` launches a ``torch.profiler`` trace of that call
    records, after a priming op (a trace may miss a kernel): the program's
    count against the device's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    cuda_build.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    traced = sum(1 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and _ATROUS_NAME.search(e.name))
    return dict(counted=cuda_build.launches()["atrous_iteration"], traced=traced)


def _atrous_timing(dev, smi, color, variance, gbuf, dcfg, cpu_ref):
    """Phase 16: the a-trous kernel on the frame's inputs -> dict: each
    launch's device time (ATROUS_REPS filter calls, each under its own
    ``torch.profiler`` trace after a priming op, since a trace may miss a
    kernel; the median over the calls traced whole, by iteration) beside
    its bound (``_atrous_bound``), the launches counted beside the traced,
    the whole filter call timed back to back with CUDA events, its ``kernel_info``,
    and the plain loop on the card (host clock around a synchronised call),
    both held to ``cpu_ref``, the CPU port's plain loop (share of pixels
    within DEN_RTOL / DEN_ATOL)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stratum_tpu_torch.render import denoise

    h, w = color.shape[:2]
    iters = dcfg.atrous_iterations
    run = lambda: denoise.atrous_filter(color, variance, gbuf, dcfg)  # noqa: E731
    kern, _ = run()
    torch.cuda.synchronize()
    before = cuda_build.launches()["atrous_iteration"]
    per_it, traced = [[] for _ in range(iters)], 0
    for _ in range(ATROUS_REPS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                         and _ATROUS_NAME.search(e.name)), key=lambda e: e.time_range.start)
        traced += len(events)
        if len(events) == iters:
            for i, e in enumerate(events):
                per_it[i].append(e.time_range.elapsed_us() / 1e3)
    counted = cuda_build.launches()["atrous_iteration"] - before
    assert counted == iters * ATROUS_REPS and traced <= counted, (counted, traced)
    assert len(per_it[0]) >= ATROUS_REPS // 2, per_it
    per_it = [sorted(t) for t in per_it]
    ms = [t[len(t) // 2] for t in per_it]
    bound, bound_by = zip(*(_atrous_bound(h, w, i, iters, dcfg.history_tap,
                                          len(denoise._filter_taps(dcfg.filter_type, i)))
                            for i in range(iters)))
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ATROUS_REPS):
        run()
    stop.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(stop) / ATROUS_REPS
    plain, plain_ms = None, []
    for _ in range(3):
        (plain, _), t = _sync_ms(lambda: denoise._atrous_plain(color, variance, gbuf, dcfg))
        plain_ms.append(t)

    def share(x):
        b = cpu_ref
        ok = torch.abs(x.cpu() - b) <= DEN_ATOL + DEN_RTOL * torch.abs(b)
        return float(ok.all(dim=-1).float().mean())

    info = {k: denoise.kernel_info(k == "first") for k in ("first", "later")}
    line = dict(launch_ms=ms, launch_ms_all=per_it, bound_ms=list(bound), bound_by=list(bound_by),
                launches_per_call=counted / ATROUS_REPS, traced_launches=traced,
                calls_traced_whole=len(per_it[0]),
                call_ms=call_ms, plain_ms=plain_ms, plain_ms_per_iteration=min(plain_ms) / iters,
                kernel_within_cpu=share(kern), plain_within_cpu=share(plain),
                kernel_vs_plain_max_abs=float((kern - plain).abs().max()), info=info)
    print(f"[16 a-trous kernel] {w}x{h}, {iters} launches a call ({counted} counted, "
          f"{traced} traced over {ATROUS_REPS} calls, {len(per_it[0])} whole): "
          + ", ".join(f"it {i} {t:.4f} ms (bound {b:.4f}, {by}, {t / b:.1f}x)"
                      for i, (t, b, by) in enumerate(zip(ms, bound, bound_by)))
          + f"; a call {call_ms:.3f} ms back to back; plain loop on the card "
          f"{', '.join(f'{t:.1f}' for t in plain_ms)} ms a call "
          f"({line['plain_ms_per_iteration']:.2f} ms an iteration); within the CPU port's "
          f"bound: kernel {line['kernel_within_cpu']:.6f}, plain {line['plain_within_cpu']:.6f}; "
          f"kernel vs plain max |diff| {line['kernel_vs_plain_max_abs']:.3g}; {info} | {smi}",
          flush=True)
    assert info["first"]["local_bytes"] == 0 and info["later"]["local_bytes"] == 0, info
    assert line["kernel_within_cpu"] == 1.0
    return line


def _frame_phase(dev, smi, scene, view, main5):
    """Phase 16: the frame pipeline at 1920x1080 on the full atrium with
    the bench configuration: the G-buffer (its K1 wave against its bound
    and against plain, instance and depth where the slots agree), denoised
    session frames with a camera move (a split of each, the launches, peak
    memory, the device busy share), the card's denoiser against the CPU
    port, the session's batched / lanes / ReSTIR / adaptive steps and a
    checkpoint, every debug view and the path-length sum, an animated
    pillar's motion vectors, and the CLI in a subprocess -> (dict for the
    JSON line's ``paths``, the G-buffer wave record)."""
    import dataclasses

    import numpy as np
    import torch
    from stratum_tpu_torch import profile_sample
    from stratum_tpu_torch.io import image as simage
    from stratum_tpu_torch.ops import block_trace
    from stratum_tpu_torch.ops.intersect import T_MAX
    from stratum_tpu_torch.render import aov, camera, debug, denoise, integrator, session
    from stratum_tpu_torch.render import tonemap
    from stratum_tpu_torch.scene import builtin, flatten, graph

    W, H = FRAME
    n = W * H
    fat = scene.fat_bvh
    rng = np.random.default_rng(16)
    cfg = integrator.RenderConfig(width=W, height=H, **BENCH)
    out = {}

    # -- the G-buffer: one K1 wave of unsorted, unjittered primary rays ------
    aov.render_gbuffer(scene, view, view, cfg)
    gb_times = []
    for _ in range(3):
        cuda_build.reset_launches()
        gb, ms = _sync_ms(lambda: aov.render_gbuffer(scene, view, view, cfg))
        gb_times.append(ms)
        gb_launches = _launches()
        assert gb_launches == {"closest": 1, "occluded": 0}, gb_launches
    gb_ms = sum(gb_times) / len(gb_times)
    px, py = camera.pixel_grid(W, H, dev)
    half = torch.full((n, 2), 0.5, dtype=torch.float32, device=dev)
    o, d = camera.generate_rays(view, px, py, half, W, H)
    wave = _whole_wave(fat, False, o, d, torch.full((n,), T_MAX, device=dev), rng,
                       "G-buffer wave", "16", smi)
    sel = torch.from_numpy(np.sort(rng.choice(n, N_CHECK, replace=False))).to(dev)
    hp = block_trace.block_closest_plain(fat, o[sel], d[sel])
    hk = block_trace.block_closest(fat, o[sel], d[sel])
    same = hk.slot == hp.slot
    inst_plain = torch.where(hp.slot >= 0,
                             scene.slot_payload[hp.slot.clamp(min=0).long(), 26].to(torch.int32),
                             -1)
    inst = gb.instance.reshape(-1)[sel]
    depth = gb.depth.reshape(-1)[sel]
    hit = same & (hp.slot >= 0)
    inst_ok = bool((inst[same] == inst_plain[same]).all())
    depth_err = float((torch.abs(depth[hit] - hp.t[hit]) / hp.t[hit]).max())
    miss_ok = bool(torch.isinf(depth[same & (hp.slot < 0)]).all())
    line = dict(ms=gb_ms, ms_calls=gb_times, launches=gb_launches["closest"], wave=wave,
                slots_agree=float(same.float().mean()), instance_equal=inst_ok,
                depth_max_rel=depth_err, misses_inf=miss_ok,
                miss_share=float((gb.instance < 0).float().mean()))
    print(f"[16 G-buffer] render_gbuffer {W}x{H}: {', '.join(f'{t:.2f}' for t in gb_times)} "
          f"ms (mean {gb_ms:.2f}), K1 launches a call "
          f"{gb_launches['closest']}; on {N_CHECK} lanes slots agree "
          f"{line['slots_agree']:.5f}, instances equal where they do: {inst_ok}, depth max "
          f"rel err {depth_err:.3g}, misses inf: {miss_ok}, miss share "
          f"{line['miss_share']:.4f} | {smi}", flush=True)
    assert line["slots_agree"] >= BATCH_AGREE and inst_ok and miss_ok and depth_err <= T_REL
    out["gbuffer"] = line
    del o, d, half, hp, hk
    torch.cuda.empty_cache()

    # -- denoised session frames with a camera move --------------------------
    node, cam = flatten.find_camera(builtin.atrium().root)
    moved = node.to_world().copy()
    moved[:, 3] += (0.15, 0.05, 0.3)
    view2 = camera.make_view(moved, cam.fovy, W, H, device=dev)
    sess = session.RenderSession(scene, view, cfg, denoise=True)
    sess.frame()  # warm-up: the first frame also traces the G-buffer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    targets = {"sample": (integrator, "render_path"), "gbuffer": (aov, "render_gbuffer"),
               "temporal_accumulate": (denoise, "temporal_accumulate"),
               "atrous_filter": (denoise, "atrous_filter"), "tonemap": (tonemap, "tonemap")}
    # one a-trous launch an iteration on the card, the plain loop elsewhere
    atrous_want = sess.denoise_cfg.atrous_iterations * (torch.device(dev).type == "cuda")
    frames = []
    for i in range(4):
        if i == 2:
            sess.set_view(view2)
        cuda_build.reset_launches()
        with _SplitTimer(targets) as split:
            (shown, ms) = _sync_ms(lambda: tonemap.tonemap(sess.frame(), tonemap.TonemapMode.ACES))
        launches = _launches(dict(BLOCK_KEYS, atrous="atrous_iteration"))
        want = dict(FRAME_LAUNCHES, closest=FRAME_LAUNCHES["closest"] + (i == 2),
                    atrous=atrous_want)
        assert launches == want, (i, launches)
        parts = dict(split.ms)
        parts["other"] = ms - sum(parts.values())
        frames.append(dict(ms=ms, split=parts, launches=launches))
        print(f"[16 frame {i + 1}] denoised frame {ms:.1f} ms: "
              + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
              + f" ms; launches {launches}" + (" (after set_view)" if i == 2 else "")
              + f" | {smi}", flush=True)
        assert bool(torch.isfinite(shown).all())
    peak = torch.cuda.max_memory_allocated() / 2**30
    atrous_frame = _traced_atrous(dev, sess.frame)
    print(f"[16 frame a-trous] one frame: {atrous_frame['counted']} a-trous launches counted, "
          f"{atrous_frame['traced']} traced | {smi}", flush=True)
    assert atrous_frame["counted"] == atrous_want, atrous_frame
    assert atrous_frame["traced"] <= atrous_frame["counted"], atrous_frame
    busy, ops = profile_sample.device_profile(
        scene, view2, cfg, 0, render=lambda *a: sess.frame())
    mean_ms = sum(f["ms"] for f in frames) / len(frames)
    mean_split = {k: sum(f["split"][k] for f in frames) / len(frames) for k in frames[0]["split"]}
    out["frame"] = dict(frames=frames, ms_mean=mean_ms, split_mean=mean_split, peak_gib=peak,
                        busy_ms=busy, busy_share=None if busy is None else busy / mean_ms,
                        top_ops=ops, history_max=float(sess.denoise_state.history.max()))
    print(f"[16 frames] mean {mean_ms:.1f} ms a denoised frame ("
          + ", ".join(f"{k} {v:.1f}" for k, v in mean_split.items())
          + f"), a-trous share {mean_split['atrous_filter'] / mean_ms:.3f}, peak {peak:.2f} GiB, "
          f"device busy {busy} ms of a profiled frame ({out['frame']['busy_share']}), top ops "
          f"{ops} | {smi}", flush=True)
    assert out["frame"]["history_max"] >= 3.0

    # -- the card's denoiser against the CPU port ------------------------------
    # both stages on identical inputs, then the whole pass. The variance is
    # ill-conditioned (m2 - m1^2 where they nearly cancel), so an ulp of
    # luminance apart moves the luminance sigma of such pixels, and the
    # whole pass is held on a share of pixels; the a-trous filter fed the
    # same colour and variance, and the temporal colour and history, are
    # held on every pixel
    rad = sess.radiance()
    gbuf = sess.gbuffer()
    dcfg = dataclasses.replace(sess.denoise_cfg, history_tap=1)
    cpu = torch.device("cpu")
    state_h = denoise.DenoiseState(*(x.to(cpu) for x in sess.denoise_state))
    gbuf_h = aov.GBuffer(*(x.to(cpu) for x in gbuf))
    (st_c, den_c), den_ms = _sync_ms(lambda: denoise.denoise(sess.denoise_state, rad, gbuf, dcfg))
    t0 = time.perf_counter()
    st_h, den_h = denoise.denoise(state_h, rad.to(cpu), gbuf_h, dcfg)
    cpu_ms = (time.perf_counter() - t0) * 1e3

    def within(a, b):
        """(share of pixels within the bound, max |diff|, max relative diff)."""
        diff = torch.abs(a.cpu() - b)
        if diff.dim() == 2:
            diff, b = diff[..., None], b[..., None]
        ok = (diff <= DEN_ATOL + DEN_RTOL * torch.abs(b)).all(dim=-1)
        return (float(ok.float().mean()), float(diff.max()),
                float((diff / (torch.abs(b) + DEN_ATOL)).max()))

    _, col_c, var_c = denoise.temporal_accumulate(sess.denoise_state, rad, gbuf, dcfg)
    _, col_h, var_h = denoise.temporal_accumulate(state_h, rad.to(cpu), gbuf_h, dcfg)
    flt_c, _ = denoise.atrous_filter(col_h.to(dev), var_h.to(dev), gbuf, dcfg)
    flt_h, _ = denoise.atrous_filter(col_h, var_h, gbuf_h, dcfg)
    res = dict(whole=within(den_c, den_h), temporal_color=within(col_c, col_h),
               variance=within(var_c, var_h), filter=within(flt_c, flt_h))
    flips = int((st_c.history.cpu() != st_h.history).sum())
    out["denoise_vs_cpu"] = dict({f"{k}_{m}": v[i] for k, v in res.items()
                                  for i, m in enumerate(("share", "max_abs", "max_rel"))},
                                 history_differing=flips, card_ms=den_ms, cpu_ms=cpu_ms)
    print(f"[16 denoiser] card vs CPU port on one frame's radiance and G-buffer (history in, "
          f"history_tap 1), share of pixels within rtol {DEN_RTOL} / atol {DEN_ATOL} (max "
          f"|diff|, max rel): " + "; ".join(f"{k} {v[0]:.6f} ({v[1]:.3g}, {v[2]:.3g})"
                                            for k, v in res.items())
          + f"; history counts differing at {flips} of {n} pixels; card {den_ms:.1f} ms, "
          f"CPU {cpu_ms:.0f} ms | {smi}", flush=True)
    assert res["filter"][0] == 1.0 and res["temporal_color"][0] == 1.0 and flips == 0
    assert res["whole"][0] >= DEN_WHOLE_SHARE
    out["atrous_kernel"] = _atrous_timing(dev, smi, col_h.to(dev), var_h.to(dev), gbuf, dcfg,
                                          flt_h)
    out["atrous_kernel"].update(launches_per_frame=[f["launches"]["atrous"] for f in frames],
                                frame_traced=atrous_frame)
    del sess, st_c, den_c, st_h, den_h, rad, gbuf, state_h, gbuf_h, col_h, var_h, flt_c, flt_h
    del col_c, var_c
    torch.cuda.empty_cache()

    # -- the session's other paths, and a checkpoint ---------------------------
    def run(label, make, steps):
        s = make()
        cuda_build.reset_launches()
        img, ms = _sync_ms(lambda: steps(s))
        print(f"[16 session] {label}: {ms:.1f} ms, launches {_launches()}, "
              f"image mean {float(img.mean()):.6f} | {smi}", flush=True)
        assert bool(torch.isfinite(img).all())
        return s, img, ms

    def sequential(s):
        for _ in range(4):
            img = s.step(1)
        return img

    paths = {}
    sb, img_b, paths["batched_4"] = run("step(4) batched", lambda: session.RenderSession(
        scene, view, cfg), lambda s: s.step(4))
    _, img_s, paths["sequential_4"] = run("4 x step(1)", lambda: session.RenderSession(
        scene, view, cfg), sequential)
    batched_equal = bool(torch.allclose(img_b, img_s, rtol=1e-5, atol=1e-7))
    _, img_l, paths["lanes_4"] = run("spp_lanes=4, step(4)", lambda: session.RenderSession(
        scene, view, cfg, spp_lanes=4), lambda s: s.step(4))
    lanes_rel = abs(float(img_l.mean()) - float(img_s.mean())) / float(img_s.mean())
    _, _, paths["restir_step"] = run("ReSTIR step(1)", lambda: session.RenderSession(
        scene, view, cfg, use_restir=True, restir_spatial_taps=1), lambda s: s.step(1))
    sa = session.RenderSession(scene, view, cfg)
    sa.step(1)
    cuda_build.reset_launches()
    img_a, paths["adaptive_round"] = _sync_ms(lambda: sa.step_adaptive(1))
    print(f"[16 session] step_adaptive(1) after a 1-sample pilot: {paths['adaptive_round']:.1f} "
          f"ms, launches {_launches()}, spp {sa.spp:.4f} | {smi}", flush=True)
    ck = ROOT / "build" / "session_checkpoint.npz"
    ck.parent.mkdir(parents=True, exist_ok=True)
    sa.save_checkpoint(ck)
    back = session.RenderSession(scene, view, cfg)
    back.load_checkpoint(ck)
    ck_equal = (torch.equal(back.accum, sa.accum) and back.spp == sa.spp
                and torch.equal(back.sample_count, sa.sample_count)
                and torch.equal(back._accum_sq, sa._accum_sq)
                and back._seeds_used == sa._seeds_used)
    out["session"] = dict(ms=paths, batched_equals_sequential=batched_equal, lanes_rel=lanes_rel,
                          checkpoint_equal=ck_equal)
    print(f"[16 session] batched = sequential (rtol 1e-5): {batched_equal}; lanes mean rel "
          f"{lanes_rel:.3e} (bound {PARITY_MEAN_REL}); checkpoint round trip bit for bit: "
          f"{ck_equal} | {smi}", flush=True)
    assert batched_equal and lanes_rel <= PARITY_MEAN_REL and ck_equal
    assert bool(torch.isfinite(img_a).all())
    del sb, sa, back, img_b, img_s, img_l, img_a
    torch.cuda.empty_cache()

    # -- debug views, and the path-length sum -----------------------------------
    views = {}
    for mode in debug.DEBUG_MODES:
        m = mode.replace("_N", "_2")
        img, ms = _sync_ms(lambda: debug.render_debug(scene, view, cfg, m, seed=4, spp=1))
        assert tuple(img.shape) == (H, W, 3) and bool(torch.isfinite(img).all()), m
        views[m] = ms
    print(f"[16 debug views] every mode finite at {W}x{H}: "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in views.items()) + f" | {smi}", flush=True)
    full, _ = integrator.render_path_with_counts(scene, view, cfg, 4)
    total = torch.zeros_like(full)
    for e in range(1, cfg.max_bounces + 3):
        total = total + debug.render_debug(scene, view, cfg, f"path_length_{e}", seed=4, spp=1)
    err = torch.abs(total - full)
    sum_ok = bool((err <= PATH_SUM_ATOL + PATH_SUM_RTOL * torch.abs(full)).all())
    out["debug"] = dict(ms=views, path_sum_max_abs=float(err.max()), path_sum_within=sum_ok)
    print(f"[16 debug views] path_length_1..{cfg.max_bounces + 2} at seed 4 sum to the full "
          f"sample within rtol {PATH_SUM_RTOL} / atol {PATH_SUM_ATOL}: {sum_ok} (max |diff| "
          f"{float(err.max()):.3g})", flush=True)
    assert sum_ok
    del full, total, err
    torch.cuda.empty_cache()

    # -- an animated pillar: motion vectors on its pixels only -----------------
    g = builtin.atrium()
    pillar = next(x for x in g.root.descendants() if x.name == ANIMATED)
    m0 = pillar.find(graph.TransformComponent).matrix.copy()
    m1 = m0.copy()
    m1[:, 3] += (-2.0, 0.0, 0.0)
    pillar.make_component(graph.AnimationComponent(
        times=np.asarray([0.0, 1.0], np.float32), matrices=np.stack([m0, m1])))
    (anim, astats), flat_ms = _sync_ms(lambda: flatten.flatten(g.root, time=0.5, prev_time=0.4,
                                                              device=dev))
    agb = aov.render_gbuffer(anim, view, view, cfg)
    on = agb.instance == astats.instance_names.index(ANIMATED)
    centre = torch.stack(torch.meshgrid((torch.arange(W, device=dev) + 0.5) / W,
                                        (torch.arange(H, device=dev) + 0.5) / H,
                                        indexing="xy"), dim=-1)
    shift = torch.abs(agb.prev_uv - centre).amax(dim=-1)
    rest = (agb.instance >= 0) & ~on
    out["animated"] = dict(flatten_ms=flat_ms, pixels=int(on.sum()),
                           min_shift=float(shift[on].min()), rest_max_shift=float(shift[rest].max()))
    print(f"[16 animated] flatten(time=0.5, prev_time=0.4) {flat_ms:.0f} ms; {ANIMATED}: "
          f"{out['animated']['pixels']} pixels, prev_uv shift min "
          f"{out['animated']['min_shift']:.3g}; the other hits' max "
          f"{out['animated']['rest_max_shift']:.3g}", flush=True)
    assert out["animated"]["pixels"] > ANIMATED_PIXELS and out["animated"]["min_shift"] > 5e-4
    assert out["animated"]["rest_max_shift"] < 1e-4
    del anim, agb, g
    torch.cuda.empty_cache()

    # -- the CLI in a subprocess -----------------------------------------------
    png = ROOT / "build" / "cli_atrium.png"
    png.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "stratum_tpu_torch.cli", "--scene=atrium", f"--width={W}",
         f"--height={H}", "--spp=1", "--denoise", "--tonemap=aces", f"--out={png}"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    timing = [ln for ln in proc.stdout.splitlines() if ln.startswith("render:")]
    for ln in proc.stdout.strip().splitlines():
        print(f"[16 CLI] {ln}", flush=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    shape = simage.read_png(str(png)).shape
    out["cli"] = dict(rc=proc.returncode, wall_s=wall, png_shape=list(shape), timing=timing)
    print(f"[16 CLI] rc {proc.returncode}, {wall:.1f} s with start-up and scene build, PNG "
          f"{shape} | {smi}", flush=True)
    assert shape[:2] == (H, W) and len(timing) == 1
    return out, wave


# ---- phase 17: loaded scenes and the mesh ---------------------------------------------

LOADED = ROOT / "build" / "loaded"
SCAN_GRID = 1449  # vertices a side of the scan's height field: 2 x 1448^2 = 4,193,408 triangles
SCAN_SEED = 17
SCAN_RELIEF = 0.18  # height range of the field over its 2 x 2 extent
SCAN_LEAVES = 16384  # past this many SAH leaves K1/K2 take the culled list mode at gs=4
SCAN_XML = """<scene version="0.6.0">
  <sensor type="perspective">
    <float name="fov" value="50"/>
    <transform name="toWorld">
      <lookat origin="0 0.75 -1.55" target="0 -0.05 0.15" up="0 1 0"/>
    </transform>
  </sensor>
  <shape type="ply">
    <string name="filename" value="scan.ply"/>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.6 0.55 0.5"/></bsdf>
  </shape>
  <shape type="serialized">
    <string name="filename" value="marker.serialized"/>
    <bsdf type="roughconductor"><float name="alpha" value="0.09"/></bsdf>
    <transform name="toWorld">
      <scale value="0.08"/><translate x="0.25" y="0.12" z="-0.3"/>
    </transform>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld">
      <scale value="0.5"/><rotate x="1" angle="90"/><translate x="0.3" y="1.6" z="-0.2"/>
    </transform>
    <emitter type="area"><rgb name="radiance" value="12 12 12"/></emitter>
  </shape>
</scene>
"""
SCAN_SAMPLES = 5  # 1 + 4 samples
SCAN_WAVES = {"closest": 5, "occluded": 1}  # waves a sample
GLB_FIELDS = ("base_color", "metallic", "roughness", "emission", "eta", "transmission",
              "clearcoat", "clearcoat_gloss", "base_color_image")  # what glTF carries
SMOKE_MEDIUM = dict(albedo=(0.85, 0.85, 0.9), g=0.3)  # smoky_cornell()'s medium
MESH_SHARDS = 5  # shards on the one card: 414,720 pixels each at 1920x1080
MESH_RTOL, MESH_ATOL, MESH_EXACT = 1e-4, 1e-6, 0.9  # tests/test_parallel.py:27-32


def _write_scan(out: Path) -> dict:
    """The scan's files: a fractal height field from SCAN_SEED (spectral
    synthesis, 1/f^2.1 amplitude) as a binary little-endian PLY of
    SCAN_GRID^2 float x y z vertices and ``uchar int`` triangle lists, a
    small box written by ``write_serialized``, and SCAN_XML -> paths and
    counts."""
    import numpy as np
    from stratum_tpu_torch.scene.builtin import _box
    from stratum_tpu_torch.scene.loaders.serialized import write_serialized

    out.mkdir(parents=True, exist_ok=True)
    n = SCAN_GRID
    rng = np.random.default_rng(SCAN_SEED)
    f = np.fft.fftfreq(n)
    k = np.sqrt(f[:, None] ** 2 + f[None, :] ** 2)
    k[0, 0] = 1.0
    spec = np.fft.fft2(rng.normal(size=(n, n))) / k ** 2.1
    spec[0, 0] = 0.0
    h = np.real(np.fft.ifft2(spec))
    h = (SCAN_RELIEF * ((h - h.min()) / np.ptp(h) - 0.5)).astype(np.float32)
    u = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    zz, xx = np.meshgrid(u, u, indexing="ij")
    pos = np.stack([xx, h, zz], axis=-1).reshape(-1, 3)
    a = (np.arange(n - 1)[:, None] * n + np.arange(n - 1)[None, :]).reshape(-1)
    tri = np.stack([np.stack([a, a + n + 1, a + 1], -1), np.stack([a, a + n, a + n + 1], -1)],
                   axis=1).reshape(-1, 3)
    face = np.empty(len(tri), np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
    face["n"] = 3
    face["i"] = tri
    head = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(pos)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(tri)}\nproperty list uchar int vertex_indices\nend_header\n")
    (out / "scan.ply").write_bytes(head.encode() + pos.astype("<f4").tobytes() + face.tobytes())
    box_pos, box_idx = _box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    write_serialized(out / "marker.serialized", box_pos, box_idx)
    (out / "scan.xml").write_text(SCAN_XML)
    return dict(xml=out / "scan.xml", ply=out / "scan.ply", faces=len(tri),
                ply_bytes=(out / "scan.ply").stat().st_size)


def _scan(dev, smi):
    """Phase 17, the scan: written, loaded through Mitsuba XML and PLY,
    flattened; K1/K2 in their culled list mode on its waves (lists held to
    the plain list phase, the list / walk split against the forced overflow
    path), 1 + 4 samples -> (scene, view, dict)."""
    import numpy as np
    import torch
    from stratum_tpu_torch import cli, profile_sample
    from stratum_tpu_torch.ops import block_trace
    from stratum_tpu_torch.render import camera, integrator
    from stratum_tpu_torch.scene import flatten
    from stratum_tpu_torch.utils.flags import Options

    t0 = time.perf_counter()
    info = _write_scan(LOADED)
    t1 = time.perf_counter()
    g = cli.build_scene(Options([f"--scene={info['xml']}"]))
    t2 = time.perf_counter()
    scene, stats = flatten.flatten(g.root, device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    L, K = scene.fat_bvh.leaf_tri.shape
    G = -(-L // block_trace.GS)
    keys = block_trace.list_keys(G)
    mode = block_trace.resolve_list_mode(G)
    line = dict(triangles=stats.num_triangles, ply_faces=info["faces"],
                ply_bytes=info["ply_bytes"], leaves=L, leaf_size=K, groups=G, list_keys=keys,
                list_mode=mode, write_s=t1 - t0, load_s=t2 - t1, flatten_s=t3 - t2,
                scratch_ctas=block_trace.list_scratch_ctas(G, 16200))
    print(f"[17 scan] {stats.num_triangles} triangles ({info['faces']} PLY faces, "
          f"{info['ply_bytes']} B), {L} SAH leaves of {K}, {G} groups at gs={block_trace.GS}, "
          f"list_keys {keys} > {block_trace.MAX_LIST_KEYS}: {mode} lists (super-groups of "
          f"{block_trace.SUPER_SIZE}, {block_trace.CULL_LIST_KEYS} keys in shared memory); write "
          f"{t1 - t0:.2f} s, load (XML, PLY, serialized) {t2 - t1:.2f} s, flatten "
          f"{t3 - t2:.2f} s", flush=True)
    assert L > SCAN_LEAVES and mode == "culled", line
    W, H = FRAME
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, W, H, device=dev)
    cfg = integrator.RenderConfig(width=W, height=H, **BENCH)
    assert integrator.resolved_tracer(scene, cfg) == "pallas"
    closest, occluded = _colonnade_waves(scene, view, cfg, np.random.default_rng(17), "17 scan",
                                         split=True)
    launches, img, main = _timed_samples(scene, view, cfg, "17 scan", "scan", smi)
    # the culled mode enqueues a wave's CTAs in chunks, each chunk a kernel:
    # the count of one more sample against its trace's kernels, and every
    # sample enqueues as many
    one, traced = _traced_launches(lambda: integrator.render_path_with_counts(
        scene, view, cfg, SCAN_SAMPLES))
    print(f"[17 scan] kernels a sample: counted {one}, traced {traced}", flush=True)
    assert one == traced and one["closest"] % SCAN_WAVES["closest"] == 0, (one, traced)
    assert one["closest"] >= SCAN_WAVES["closest"] and one["occluded"] >= 1, one
    want = {f"block {k}": SCAN_SAMPLES * v for k, v in one.items()}
    want.update({"binned emit": 0, "binned closest": 0, "binned occluded": 0, **DISNEY_5,
                 **FINALIZE_5})
    assert launches == want, (launches, want)
    busy, ops = profile_sample.device_profile(scene, view, cfg, 1)
    share = ("not measured: the profiler recorded no device events" if busy is None
             else f"{busy:.3f} ms of a {main['ms_spp']:.1f} ms sample, "
                  f"{100 * busy / main['ms_spp']:.1f} %")
    print(f"[17 scan] device busy {share}; top ops "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ops[:6]) + f" | {smi}", flush=True)
    main.update(launches=launches, device_busy_ms=busy, top_ops_ms=ops[:6],
                busy_share=None if busy is None else busy / main["ms_spp"], scene=line)
    return scene, view, dict(path=main, waves=dict(closest=closest, occluded=occluded),
                             xml=str(info["xml"]))


def _scan_tools(scene, view, xml, smi):
    """Phase 17, tools and CLI: the CLI in a subprocess on the scan at
    1920x1080, 1 spp; ``tools.compare`` of its PNG against the same render
    in this process; ``tools.inspect --flatten`` on the scan -> dict."""
    import contextlib
    import io

    from stratum_tpu_torch.io.image import read_png, save_image
    from stratum_tpu_torch.render import integrator
    from stratum_tpu_torch.render import tonemap as stonemap
    from stratum_tpu_torch.tools import compare as tcompare
    from stratum_tpu_torch.tools import inspect as tinspect

    W, H = FRAME
    cli_png, own_png = LOADED / "cli_scan.png", LOADED / "scan_in_process.png"
    cli_png.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "stratum_tpu_torch.cli", f"--scene={xml}", f"--width={W}",
         f"--height={H}", "--spp=1", f"--out={cli_png}"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    for ln in proc.stdout.strip().splitlines():
        print(f"[17 CLI] {ln}", flush=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # the CLI's defaults: its RenderConfig, one batched sample at seed 0, the
    # raw tonemap, sRGB PNG
    cfg = integrator.RenderConfig(width=W, height=H, bsdf="disney")
    img, _ = integrator.render_path_batched(scene, view, cfg, 1, 0)
    save_image(str(own_png), stonemap.tonemap(img.cpu().numpy(), stonemap.TonemapMode.RAW,
                                              exposure=0.0).numpy())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tcompare.main([str(cli_png), str(own_png)])
    metrics = dict(ln.split() for ln in buf.getvalue().splitlines())
    for ln in buf.getvalue().splitlines():
        print(f"[17 compare] {ln}", flush=True)
    assert rc == 0 and float(metrics["mse"]) < 1e-4, metrics
    cli = dict(rc=proc.returncode, wall_s=wall, png_shape=list(read_png(cli_png).shape),
               timing=[ln for ln in proc.stdout.splitlines() if ln.startswith("render:")],
               compare={k: float(v) for k, v in metrics.items()})
    print(f"[17 CLI] rc {proc.returncode}, {wall:.1f} s with start-up, load and flatten | {smi}",
          flush=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = tinspect.main([f"--scene={xml}", "--flatten"])
    inspect_s = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for ln in lines:
        if ln.strip() and not ln.startswith("  ."):
            print(f"[17 inspect] {ln}", flush=True)
    assert rc == 0 and any(ln.startswith("instances") for ln in lines)
    return dict(cli=cli, inspect_s=inspect_s,
                inspect_stats=[ln for ln in lines if ln.startswith(("instances", "BVH"))])


def _write_glb(g, path: Path, tex_dir: Path):
    """A loaded graph's meshes, materials (the fields glTF carries, the
    base colour as the asset's PNG, embedded) and camera as one GLB
    (glTF 2.0 binary). The package has no glTF writer: this one exists for
    this check. A glTF camera looks down -z, so the node's matrix is the
    camera's with x and z negated, which the loader's flip restores."""
    import json
    import struct

    import numpy as np
    from stratum_tpu_torch.scene import flatten
    from stratum_tpu_torch.scene.graph import MeshPrimitive

    blob, views, accessors = bytearray(), [], []

    def view_of(data: bytes) -> int:
        blob.extend(b"\0" * (-len(blob) % 4))
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)})
        blob.extend(data)
        return len(views) - 1

    def accessor(arr, ctype, kind) -> int:
        accessors.append({"bufferView": view_of(arr.tobytes()), "componentType": ctype,
                          "count": int(arr.shape[0]), "type": kind})
        return len(accessors) - 1

    def f(x):
        return [float(v) for v in np.asarray(x, np.float32).reshape(-1)]

    nodes, meshes, materials, images, mat_of = [], [], [], [], {}
    for node in g.root.descendants():
        mp = node.find(MeshPrimitive)
        if mp is None:
            continue
        m = mp.material
        if id(m) not in mat_of:
            images.append({"bufferView": view_of((tex_dir / f"{node.name}.png").read_bytes()),
                           "mimeType": "image/png"})
            mat_of[id(m)] = len(materials)
            materials.append({
                "name": m.name,
                "pbrMetallicRoughness": {
                    "baseColorFactor": f(m.base_color) + [1.0],
                    "metallicFactor": f(m.metallic)[0], "roughnessFactor": f(m.roughness)[0],
                    "baseColorTexture": {"index": len(images) - 1}},
                "emissiveFactor": f(m.emission),
                "extensions": {
                    "KHR_materials_ior": {"ior": f(m.eta)[0]},
                    "KHR_materials_transmission": {"transmissionFactor": f(m.transmission)[0]},
                    "KHR_materials_clearcoat": {
                        "clearcoatFactor": f(m.clearcoat)[0],
                        "clearcoatRoughnessFactor": 1.0 - f(m.clearcoat_gloss)[0]}},
            })
        attrs = {"POSITION": accessor(np.ascontiguousarray(mp.positions, np.float32), 5126,
                                      "VEC3"),
                 "NORMAL": accessor(np.ascontiguousarray(mp.normals, np.float32), 5126, "VEC3"),
                 "TEXCOORD_0": accessor(np.ascontiguousarray(mp.uvs, np.float32), 5126, "VEC2")}
        idx = accessor(np.ascontiguousarray(mp.indices, np.uint32).reshape(-1), 5125, "SCALAR")
        meshes.append({"primitives": [{"attributes": attrs, "indices": idx,
                                       "material": mat_of[id(m)]}]})
        nodes.append({"name": node.name, "mesh": len(meshes) - 1})
    cam_node, cam = flatten.find_camera(g.root)
    m = np.eye(4, dtype=np.float32)
    m[:3] = cam_node.to_world()
    m[:3, 0] *= -1.0
    m[:3, 2] *= -1.0
    nodes.append({"name": "camera", "camera": 0, "matrix": f(m.T)})
    doc = {"asset": {"version": "2.0"}, "scene": 0,
           "scenes": [{"nodes": list(range(len(nodes)))}], "nodes": nodes, "meshes": meshes,
           "materials": materials, "images": images,
           "textures": [{"source": i} for i in range(len(images))],
           "cameras": [{"type": "perspective",
                        "perspective": {"yfov": float(cam.fovy), "znear": 0.01}}],
           "buffers": [{"byteLength": len(blob)}], "bufferViews": views,
           "accessors": accessors}
    payload = json.dumps(doc).encode()
    payload += b" " * (-len(payload) % 4)
    blob.extend(b"\0" * (-len(blob) % 4))
    body = (struct.pack("<II", len(payload), 0x4E4F534A) + payload
            + struct.pack("<II", len(blob), 0x004E4942) + bytes(blob))
    path.write_bytes(struct.pack("<4sII", b"glTF", 2, 12 + len(body)) + body)
    return path


def _scene_diff(a, b):
    """Names of the flattened arrays in which two scenes differ."""
    import torch

    fields = {"geo.positions": lambda s: s.geo.positions, "geo.normals": lambda s: s.geo.normals,
              "geo.uvs": lambda s: s.geo.uvs, "geo.indices": lambda s: s.geo.indices,
              "geo.tri_material": lambda s: s.geo.tri_material,
              "geo.packed_tri": lambda s: s.geo.packed_tri,
              "materials.packed": lambda s: s.materials.packed,
              "textures.flat": lambda s: s.textures.flat,
              "textures.quad": lambda s: s.textures.quad,
              "env.emission": lambda s: s.env.emission,
              "fat_bvh.leaf_tri": lambda s: s.fat_bvh.leaf_tri,
              "slot_payload": lambda s: s.slot_payload,
              "media.density": lambda s: s.media.density}
    return [k for k, get in fields.items()
            if get(a).shape != get(b).shape or not torch.equal(get(a), get(b))]


def _glb_colonnade(dev, smi):
    """Phase 17, the colonnade as textured glTF: phase 13's asset written
    as one GLB with its PNGs embedded, loaded with the port's decoder (PIL
    blocked), against the OBJ route -> dict."""
    import numpy as np
    import torch
    from stratum_tpu_torch import cli
    from stratum_tpu_torch.io.image import load_image
    from stratum_tpu_torch.render import camera, integrator
    from stratum_tpu_torch.scene import flatten, sample_assets
    from stratum_tpu_torch.scene.graph import EnvironmentComponent, MeshPrimitive
    from stratum_tpu_torch.utils.flags import Options

    out = LOADED / "colonnade"
    info = sample_assets.write_colonnade(out)
    t0 = time.perf_counter()
    g_obj = sample_assets.colonnade_graph(info)
    obj_s = time.perf_counter() - t0
    glb = _write_glb(g_obj, out / "colonnade.glb", out)
    # PIL blocked while the GLB loads (an import of it raises): its PNGs go
    # through the port's own decoder
    pil = {k: sys.modules.pop(k) for k in list(sys.modules) if k.split(".")[0] == "PIL"}
    sys.modules["PIL"] = None
    try:
        t0 = time.perf_counter()
        g_glb = cli.build_scene(Options([f"--scene={glb}"]))
        glb_s = time.perf_counter() - t0
    finally:
        del sys.modules["PIL"]
        sys.modules.update(pil)
    # glTF has no environment: the sky goes in as the CLI's --envmap adds it
    g_glb.root.add_child("envmap").make_component(EnvironmentComponent(
        color=np.full(3, 1.0, np.float32), image=load_image(str(info["env"]))[..., :3],
        source_path=str(info["env"])))
    mats = [(a.find(MeshPrimitive).material, b.find(MeshPrimitive).material)
            for a, b in zip([n for n in g_obj.root.descendants() if n.find(MeshPrimitive)],
                            [n for n in g_glb.root.descendants() if n.find(MeshPrimitive)])]
    field_diff = [f"{ma.name}.{k}" for ma, mb in mats for k in GLB_FIELDS
                  if not np.array_equal(np.asarray(getattr(ma, k)), np.asarray(getattr(mb, k)))]
    s_obj, _ = flatten.flatten(g_obj.root, device=dev)
    s_glb, stats = flatten.flatten(g_glb.root, device=dev)
    diff = _scene_diff(s_obj, s_glb)
    W, H = FRAME
    views = []
    for g in (g_obj, g_glb):
        node, cam = flatten.find_camera(g.root)
        views.append((node.to_world(), cam.fovy))
    same_cam = np.array_equal(views[0][0], views[1][0]) and views[0][1] == views[1][1]
    view = camera.make_view(views[1][0], views[1][1], W, H, device=dev)
    print(f"[17 glTF] colonnade as {glb.stat().st_size} B of GLB ({len(mats)} meshes, PNGs "
          f"embedded): load {glb_s:.2f} s with PIL blocked (OBJ route {obj_s:.2f} s); "
          f"{stats.num_triangles} triangles; material fields differing {field_diff}; flattened "
          f"arrays differing {diff}; camera equal {same_cam}", flush=True)
    assert len(mats) == 3 and not field_diff and same_cam
    assert not {"geo.positions", "geo.normals", "geo.uvs", "geo.indices", "textures.flat",
                "textures.quad"} & set(diff), diff
    cfg = integrator.RenderConfig(width=W, height=H, **BENCH)
    seed = 4  # phase 13's last timed sample
    img_obj = integrator.render_path(s_obj, view, cfg, seed)
    img_glb = integrator.render_path(s_glb, view, cfg, seed)
    same = bool(torch.equal(img_obj, img_glb))
    mean_o, mean_g = float(img_obj.mean()), float(img_glb.mean())
    rel = abs(mean_g - mean_o) / mean_o
    print(f"[17 glTF] sample {seed} at {W}x{H}: GLB route equal to the OBJ route bit for bit: "
          f"{same}; means {mean_g:.6f} vs {mean_o:.6f} (rel {rel:.2e}) | {smi}", flush=True)
    assert same if not diff else rel <= PARITY_MEAN_REL
    return dict(glb_bytes=glb.stat().st_size, glb_load_s=glb_s, obj_load_s=obj_s,
                triangles=stats.num_triangles, arrays_differing=diff, image_equal=same,
                mean=mean_g, mean_obj=mean_o)


def _volumes(dev, smi):
    """Phase 17, volumes: ``smoky_cornell()``'s grid written as .vol and
    .nvdb, each loaded into the box without its boxes, its 1080p sample
    against ``smoky_cornell()``'s -> dict."""
    import numpy as np
    import torch
    from stratum_tpu_torch.render import camera, integrator
    from stratum_tpu_torch.scene import builtin, flatten
    from stratum_tpu_torch.scene.graph import MediumComponent
    from stratum_tpu_torch.scene.loaders import volumes

    W, H = FRAME
    ref_g = builtin.smoky_cornell()
    mc = next(n.find(MediumComponent) for n in ref_g.root.descendants()
              if n.find(MediumComponent))
    LOADED.mkdir(parents=True, exist_ok=True)
    volumes.write_vol_grid(LOADED / "smoke.vol", mc.density, mc.box_lo, mc.box_hi)
    volumes.write_nvdb_grid(LOADED / "smoke.nvdb", mc.density, mc.box_lo, mc.box_hi)
    node, cam = flatten.find_camera(ref_g.root)
    view = camera.make_view(node.to_world(), cam.fovy, W, H, device=dev)
    cfg = integrator.RenderConfig(width=W, height=H, **CORNELL)
    seed = 4
    ref_scene, _ = flatten.flatten(ref_g.root, device=dev)
    ref = integrator.render_path(ref_scene, view, cfg, seed)
    del ref_scene
    out = {}
    for ext in ("vol", "nvdb"):
        g = builtin.cornell_box(boxes=False)
        t0 = time.perf_counter()
        lm = volumes.load_volume(g.root, LOADED / f"smoke.{ext}", **SMOKE_MEDIUM).find(
            MediumComponent)
        load_s = time.perf_counter() - t0
        grid_equal = (np.array_equal(lm.density, mc.density)
                      and np.array_equal(lm.box_lo, mc.box_lo)
                      and np.array_equal(lm.box_hi, mc.box_hi))
        scene, _ = flatten.flatten(g.root, device=dev)
        t0 = time.perf_counter()
        img = integrator.render_path(scene, view, cfg, seed)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        same = bool(torch.equal(img, ref))
        print(f"[17 volumes] smoke.{ext} ({(LOADED / f'smoke.{ext}').stat().st_size} B, "
              f"{tuple(lm.density.shape)}): load {load_s * 1e3:.1f} ms, grid and box equal "
              f"{grid_equal}; sample {seed} ({ms:.1f} ms) equal to smoky_cornell()'s bit for "
              f"bit: {same} | {smi}", flush=True)
        assert grid_equal and same
        out[ext] = dict(load_ms=load_s * 1e3, grid_equal=grid_equal, image_equal=same,
                        sample_ms=ms)
        del scene
    return out


def _mesh(dev, smi, atrium, atrium_view, main5, img5):
    """Phase 17, the mesh on one card: ``make_mesh()``; the Cornell path
    sharded against ``render_path``; the atrium in 5 shards of whole
    granules, bit for bit against phase 5's sample; one denoised
    ``RenderSession`` frame on the mesh -> dict."""
    import numpy as np
    import torch
    from stratum_tpu_torch.parallel import mesh as pmesh
    from stratum_tpu_torch.render import camera, integrator, session
    from stratum_tpu_torch.scene import builtin, flatten

    W, H = FRAME
    one = pmesh.make_mesh()
    assert one.size == 1, one
    five = pmesh.make_mesh([DEVICE] * MESH_SHARDS)
    out = {}
    g = builtin.cornell_box()
    scene, _ = flatten.flatten(g.root, device=dev)
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, W, H, device=dev)
    cfg = integrator.RenderConfig(width=W, height=H, **CORNELL)
    seed = 4
    ref = integrator.render_path(scene, view, cfg, seed).cpu().numpy().reshape(-1, 3)
    for name, m in (("one", one), ("five", five)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = pmesh.render_path_sharded(scene, view, cfg, seed, m)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = img.cpu().numpy().reshape(-1, 3)
        close = bool(np.allclose(got, ref, rtol=MESH_RTOL, atol=MESH_ATOL))
        exact = float((got == ref).all(axis=-1).mean())
        print(f"[17 mesh] Cornell ({integrator.resolved_tracer(scene, cfg)}), {m.size} "
              f"shard(s): {ms:.1f} ms, allclose(rtol {MESH_RTOL}, atol {MESH_ATOL}) {close}, "
              f"pixels bit-equal {exact:.6f}", flush=True)
        assert close and exact > MESH_EXACT
        out[f"cornell_{name}"] = dict(ms=ms, allclose=close, exact_share=exact)
    del scene
    cfg = integrator.RenderConfig(width=W, height=H, **BENCH)
    seed = 4  # phase 5's last sample
    granule = pmesh._granule(cfg)
    cuts = [sl.start for _, sl in pmesh._shards(W * H, five, granule=granule)]
    whole = all(c % granule == 0 for c in cuts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, rays = pmesh.render_path_sharded_with_counts(atrium, atrium_view, cfg, seed, five)
    rays = int(rays)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    img_np, ref5 = img.cpu().numpy(), img5.cpu().numpy()
    mean_rel = abs(img_np.mean() - ref5.mean()) / ref5.mean()
    pix = float(np.all(np.abs(img_np - ref5) <= 1e-3 * (1 + np.abs(ref5)), axis=-1).mean())
    _, rays5 = integrator.render_path_with_counts(atrium, atrium_view, cfg, seed)
    rays5 = int(rays5)  # phase 5's sample 4 traced these
    rays_rel = abs(rays - rays5) / rays5
    same = bool(torch.equal(img, img5))
    print(f"[17 mesh] atrium, {MESH_SHARDS} shards (first lanes {cuts}; whole {granule}-lane "
          f"granules: {whole}): {ms:.1f} ms vs {main5['ms_spp']:.1f} ms/spp (phase 5); against "
          f"phase 5's sample {seed}: mean rel {mean_rel:.2e}, pixels agreeing {pix:.6f}, rays {rays} "
          f"(unsharded {rays5}, rel {rays_rel:.2e}), bit for bit: "
          f"{same} | {smi}", flush=True)
    assert mean_rel <= PARITY_MEAN_REL and pix >= PARITY_PIXEL_SHARE
    assert rays_rel <= PARITY_RAYS_REL
    # shards of whole granules draw the unsharded render's light-tile groups
    assert whole and same and rays == rays5, (cuts, same, rays, rays5)
    out["atrium_five"] = dict(ms=ms, mean_rel=float(mean_rel), pixels=pix, rays=rays,
                              rays_rel=rays_rel, image_equal=same, shard_starts=cuts,
                              whole_granules=whole)
    sess = session.RenderSession(atrium, atrium_view, cfg, denoise=True, mesh=one)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame = sess.frame()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    finite = bool(torch.isfinite(frame).all())
    print(f"[17 mesh] RenderSession(denoise=True, mesh=make_mesh()) frame: {ms:.1f} ms, "
          f"finite {finite}, mean {float(frame.mean()):.6f} | {smi}", flush=True)
    assert finite
    out["session_frame"] = dict(ms=ms, mean=float(frame.mean()))
    return out


def _loaded_phase(dev, smi, atrium, atrium_view, main5, img5):
    """Phase 17: loaded scenes and the mesh -> (dict, scan waves)."""
    import torch

    scan_scene, scan_view, scan = _scan(dev, smi)
    tools = _scan_tools(scan_scene, scan_view, scan["xml"], smi)
    del scan_scene
    torch.cuda.empty_cache()
    glb = _glb_colonnade(dev, smi)
    torch.cuda.empty_cache()
    vols = _volumes(dev, smi)
    mesh = _mesh(dev, smi, atrium, atrium_view, main5, img5)
    torch.cuda.empty_cache()
    return dict(scan=scan["path"], tools=tools, gltf=glb, volumes=vols, mesh=mesh), scan["waves"]


# ---- 18: the Disney BSDF kernels (csrc/disney.cu) ------------------------------
DISNEY_CONFIGS = ("atrium", "sphereflake")  # portbench/configs/ whose sample feeds phase 18
DISNEY_SEED = 20261018
DISNEY_REPS = 5  # traced launches a captured call
_DISNEY_NAME = re.compile(r"disney_(eval|sample)_kernel")
# needed bytes a lane: 11 material floats, wo and wi or u in; f, pdf and
# pdf_rev out (eval), and wi and eta besides (sample)
DISNEY_BYTES = {"eval": 4 * (11 + 3 + 3) + 4 * 5, "sample": 4 * (11 + 3 + 3) + 4 * 9}


def _config_scene(dev, name: str):
    """A benchmark configuration (``portbench/configs/<name>``, its scene
    built as ``portbench.harness`` builds it) on the card -> (scene, view,
    RenderConfig, flatten s)."""
    import importlib

    import torch

    from portbench import harness
    from stratum_tpu_torch.render import camera, integrator
    from stratum_tpu_torch.scene import flatten

    conf = harness.load_json(ROOT / "portbench" / "configs" / f"{name}.json")
    raw = importlib.import_module(f"portbench.scenes.{conf['scene']}").build(
        {**conf.get("scene_params", {}), "camera": conf["camera"]}, DISNEY_SEED, None)
    t0 = time.perf_counter()
    scene, _ = flatten.flatten(harness.build_program_scene(raw).root,
                               env_probability=float(conf["env_probability"]), device=dev)
    torch.cuda.synchronize()
    flatten_s = time.perf_counter() - t0
    w, h = int(conf["width"]), int(conf["height"])
    view = camera.make_view(raw["camera"]["camera_to_world"], raw["camera"]["fovy"], w, h,
                            device=dev)
    return scene, view, integrator.RenderConfig(width=w, height=h, **conf["render"]), flatten_s


def _disney_sample_calls(dev, name: str):
    """One sample of a benchmark configuration (:func:`_config_scene`) with
    every Disney call's inputs kept -> (calls [(op, depth, mat, wo, wi or
    u)], the registry's Disney launches of the sample, flatten s)."""
    import torch

    from stratum_tpu_torch.render import disney, integrator

    scene, view, cfg, flatten_s = _config_scene(dev, name)
    calls = []
    real = {"eval": disney.disney_eval, "sample": disney.disney_sample}

    def keep(op):
        def call(mat, wo, arg):
            calls.append((op, sum(c[0] == "sample" for c in calls), mat, wo, arg))
            return real[op](mat, wo, arg)
        return call

    cuda_build.reset_launches()
    disney.disney_eval, disney.disney_sample = keep("eval"), keep("sample")
    try:
        integrator.render_path_with_counts(scene, view, cfg, DISNEY_SEED)
    finally:
        disney.disney_eval, disney.disney_sample = real["eval"], real["sample"]
    torch.cuda.synchronize()
    return calls, _launches({"eval": "disney_eval", "sample": "disney_sample"}), flatten_s


def _differing_lanes(got, want) -> int:
    """Lanes where two outputs differ by value, or where one is NaN and the
    other not."""
    import torch

    gn, wn = torch.isnan(got), torch.isnan(want)
    bad = (gn != wn) | (~gn & ~wn & (got != want))
    return int(bad.reshape(bad.shape[0], -1).any(-1).sum())


def _disney_phase(dev, smi):
    """Phase 18: the Disney kernels on the inputs of every bounce of one
    1920x1080 sample of each benchmark configuration in DISNEY_CONFIGS:
    each captured call (an eval for NEE and a sample a bounce) run by the
    kernel and by the plain torch body on the card, the differing lanes of
    every output printed (all must be 0: the kernel is the plain body bit
    for bit) beside the differing 32-bit words; each launch's device time
    (median of DISNEY_REPS ``torch.profiler``-traced launches, and
    DISNEY_REPS launches back to back between CUDA events) beside its
    bound, the needed bytes at the memory rate; the plain body's time on
    the card (host clock, synchronised); each kernel's registers, stack
    frame and spills (ptxas's report: no spill)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stratum_tpu_torch.render import disney

    info = {op: disney.kernel_info(op == "sample") for op in ("eval", "sample")}
    print(f"[18 disney] kernel_info {info}; ptxas: {cuda_build.ptxas_report('disney.cu')}",
          flush=True)
    out, bad = {}, []
    for name in DISNEY_CONFIGS:
        calls, launches, flatten_s = _disney_sample_calls(dev, name)
        rows = []
        for op, depth, mat, wo, arg in calls:
            kern = disney.disney_eval if op == "eval" else disney.disney_sample
            plain = disney._disney_eval_plain if op == "eval" else disney._disney_sample_plain
            got, (want, plain_ms) = kern(mat, wo, arg), _sync_ms(lambda: plain(mat, wo, arg))
            diff = {f: _differing_lanes(a, b) for f, a, b in zip(got._fields, got, want)}
            words = {f: int((a.view(torch.int32) != b.view(torch.int32)).sum())
                     for f, a, b in zip(got._fields, got, want)}
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.ones(1, device=dev).add_(1)
                torch.cuda.synchronize()
                for _ in range(DISNEY_REPS):
                    kern(mat, wo, arg)
                torch.cuda.synchronize()
            times = sorted(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                           if e.device_type == DeviceType.CUDA and _DISNEY_NAME.search(e.name))
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(DISNEY_REPS):
                kern(mat, wo, arg)
            stop.record()
            torch.cuda.synchronize()
            back_ms = start.elapsed_time(stop) / DISNEY_REPS
            lanes = got.pdf_fwd.numel()
            bound = lanes * DISNEY_BYTES[op] / PEAK_BYTES_S * 1e3
            ms = times[len(times) // 2] if times else None
            row = dict(op=op, depth=depth, lanes=lanes, differing=diff, words=words, ms=ms,
                       traced=len(times), back_to_back_ms=back_ms, bound_ms=bound,
                       plain_ms=plain_ms)
            rows.append(row)
            if any(diff.values()):
                bad.append((name, op, depth, diff))
            print(f"[18 disney] {name} bounce {depth} {op}: {lanes:,} lanes, differing lanes "
                  f"{diff}, differing words {words}; kernel "
                  + (f"{ms:.4f} ms ({len(times)} traced" if ms else "not traced (a trace may "
                     "miss a kernel")
                  + f"; {back_ms:.4f} ms a launch back to back; bound {bound:.4f} ms, bytes, "
                  f"{(ms or back_ms) / bound:.1f}x); plain body on the card {plain_ms:.2f} ms",
                  flush=True)
        print(f"[18 disney] {name}: {len(calls)} calls, {launches} launches in the sample "
              f"(flatten {flatten_s:.1f} s) | {smi}", flush=True)
        out[name] = dict(launches=launches, calls=rows, flatten_s=flatten_s)
        assert launches == {"eval": 5, "sample": 5} and len(calls) == 10, (launches, len(calls))
        del calls
        torch.cuda.empty_cache()
    assert not bad, bad
    assert all(i["spill_stores"] == 0 and i["spill_loads"] == 0 for i in info.values()), info
    return dict(info=info, **out)


# ---- 19: finalize_hit (csrc/finalize.cu) ---------------------------------------
FINALIZE_REPS = 5  # traced launches a captured wave
# needed bytes a lane: the slot, origin and direction, the payload row read
# and written, tri and bary. Lanes share rows (every miss reads row 0), which
# L2 serves, so the tighter bound counts each distinct row read once
FINALIZE_BYTES = 4 + 24 + 352 + 352 + 4 + 8
FINALIZE_ROW_BYTES = 352


def _finalize_sample_calls(dev, name: str):
    """One sample of a benchmark configuration (:func:`_config_scene`) under
    a ``torch.profiler`` trace of the device with the inputs of every
    ``finalize_hit`` call kept (copies: the path may reuse its buffers) ->
    (scene, calls [(origin, direction, slot-mode HitRecord)], launches
    counted by the registry, ``finalize_hit_kernel`` launches traced,
    flatten s)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stratum_tpu_torch.ops import block_trace
    from stratum_tpu_torch.render import integrator

    scene, view, cfg, flatten_s = _config_scene(dev, name)
    calls, real = [], block_trace.finalize_hit

    def keep(slot_payload, o, d, h):
        if h.slot is not None:
            calls.append((o.clone(), d.clone(), h._replace(t=h.t.clone(), slot=h.slot.clone())))
        return real(slot_payload, o, d, h)

    torch.cuda.synchronize()
    cuda_build.reset_launches()
    block_trace.finalize_hit = keep
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            integrator.render_path_with_counts(scene, view, cfg, DISNEY_SEED)
            torch.cuda.synchronize()
    finally:
        block_trace.finalize_hit = real
    traced = sum(1 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "finalize_hit_kernel" in e.name)
    return scene, calls, cuda_build.launches()["finalize_hit"], traced, flatten_s


def _finalize_phase(dev, smi):
    """Phase 19: ``finalize_hit``'s kernel on the five closest waves of one
    1920x1080 sample of each benchmark configuration in DISNEY_CONFIGS:
    the launches counted against those traced; each wave run by the kernel
    and by the plain torch body on the card, the differing 32-bit words of
    tri, bary and payload printed (all must be 0: the kernel is the plain
    body bit for bit); each launch's device time (median of FINALIZE_REPS
    ``torch.profiler``-traced launches, and FINALIZE_REPS launches back to
    back between CUDA events) beside its bound, FINALIZE_BYTES a lane at
    the memory rate, and the tighter bound that reads each distinct row
    once; the plain body's time on the card (host clock,
    synchronised); the kernel's registers, shared memory and spills
    (ptxas's report: no spill)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stratum_tpu_torch.ops import block_trace

    info = block_trace.finalize_kernel_info()
    print(f"[19 finalize] kernel_info {info}; ptxas: {cuda_build.ptxas_report('finalize.cu')}",
          flush=True)
    out, bad = dict(info=info), []
    for name in DISNEY_CONFIGS:
        scene, calls, counted, traced, flatten_s = _finalize_sample_calls(dev, name)
        payload = scene.slot_payload
        rows = []
        for wave, (o, d, h) in enumerate(calls):
            got = block_trace.finalize_hit(payload, o, d, h)
            want, plain_ms = _sync_ms(lambda: block_trace.finalize_hit_plain(payload, o, d, h))
            words = {k: int((getattr(got, k).view(torch.int32) != w.view(torch.int32)).sum())
                     for k, w in zip(("tri", "bary", "payload"), want)}
            del got, want
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.ones(1, device=dev).add_(1)
                torch.cuda.synchronize()
                for _ in range(FINALIZE_REPS):
                    block_trace.finalize_hit(payload, o, d, h)
                torch.cuda.synchronize()
            times = sorted(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                           if e.device_type == DeviceType.CUDA
                           and "finalize_hit_kernel" in e.name)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(FINALIZE_REPS):
                block_trace.finalize_hit(payload, o, d, h)
            stop.record()
            torch.cuda.synchronize()
            back_ms = start.elapsed_time(stop) / FINALIZE_REPS
            lanes = h.slot.shape[0]
            bound = lanes * FINALIZE_BYTES / PEAK_BYTES_S * 1e3
            distinct = int(torch.unique(torch.clamp(h.slot, min=0)).numel())
            bound_distinct = (lanes * (FINALIZE_BYTES - FINALIZE_ROW_BYTES)
                              + distinct * FINALIZE_ROW_BYTES) / PEAK_BYTES_S * 1e3
            ms = times[len(times) // 2] if times else None
            hits = int((h.slot >= 0).sum())
            rows.append(dict(wave=wave, lanes=lanes, hits=hits, distinct_rows=distinct,
                             words=words, ms=ms, traced=len(times), back_to_back_ms=back_ms,
                             bound_ms=bound, bound_distinct_ms=bound_distinct,
                             plain_ms=plain_ms))
            if any(words.values()):
                bad.append((name, wave, words))
            print(f"[19 finalize] {name} wave {wave}: {lanes:,} lanes ({hits:,} hits, "
                  f"{distinct:,} distinct rows), differing words {words}; kernel "
                  + (f"{ms:.4f} ms ({len(times)} traced" if ms else "not traced (a trace may "
                     "miss a kernel")
                  + f"; {back_ms:.4f} ms a launch back to back; bound {bound:.4f} ms, bytes, "
                  f"{(ms or back_ms) / bound:.2f}x; each distinct row read once "
                  f"{bound_distinct:.4f} ms, {(ms or back_ms) / bound_distinct:.2f}x); "
                  f"plain body on the card {plain_ms:.2f} ms", flush=True)
        print(f"[19 finalize] {name}: {len(calls)} waves, {counted} launches counted, "
              f"{traced} traced in the sample (flatten {flatten_s:.1f} s) | {smi}", flush=True)
        out[name] = dict(counted=counted, traced=traced, waves=rows, flatten_s=flatten_s)
        assert counted == traced == len(calls) == 5, (counted, traced, len(calls))
        del calls, scene
        torch.cuda.empty_cache()
    assert not bad, bad
    assert info["spill_stores"] == 0 and info["spill_loads"] == 0, info
    return out


def _gpu_tests():
    """Phase 12: tests/test_torch_cuda.py in a subprocess (no conftest: the
    card has no JAX); every test must pass, none skip."""
    import re

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
         "tests/test_torch_cuda.py", "-m", "cuda", "-q", "-rP"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
    )
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    for ln in proc.stdout.splitlines():  # what the passing tests printed (-rP)
        if ln.startswith("[T2 past 2^-12]"):
            print(f"[12 gpu tests] {ln}", flush=True)
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
    k12 = _launches()
    assert k12["closest"] >= 2 and k12["occluded"] >= 1, k12

    # the main path's own waves: one sample's five closest waves (the
    # unsorted primary peel, then four sorted bounces with dead lanes) and
    # its one deferred shadow wave of 5 x W x H lanes, as the wrappers get them
    waves = {}
    integrator.render_path_with_counts(scene, view, cfg, 0, capture=waves)

    def list_lengths(o, d, bound, prep, occluded, ms):
        """The wave's lists held to the plain list phase and its list / walk
        split (``_list_split``), beside the reference's mean list length per
        2048-ray block."""
        split = _list_split(fat, o, d, bound, prep, occluded, ms)
        old = block_trace.candidate_lists(fat, o, d, bound, prep.gs)
        return split, float(old.ncand.float().mean())

    for occl in (False, True):
        for gs_ in (block_trace.GS, 1):
            G_ = -(-L // gs_)
            mode_ = block_trace.resolve_list_mode(G_)
            info = block_trace.kernel_info(occl, G_, mode_)
            print(f"[3 kernel] block_trace_kernel<{str(occl).lower()}, {mode_} lists> at "
                  f"gs={gs_} (G={G_}): {info}", flush=True)
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
        split, per_block = list_lengths(o, d, tm, prep, False, ms)
        per_cta = split["ncand_cta"]
        print(f"[3 main-path waves] closest wave {i} ({c['rays']} lanes, {c['live']} live): "
              f"kernel {ms:.3f} ms (bound {bound_ms:.3f} ms, {bound_by}; {tests} tests), "
              f"wrapper (prep + kernel) {wrap_ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"candidate groups per CTA {per_cta:.2f} (per 2048-ray block {per_block:.2f}); "
              f"{_split_text(split)}", flush=True)
        _check_closest(f"closest wave {i}", c)
        closest_waves.append(dict(c, ms=ms, wrapper_ms=wrap_ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by, tests=tests,
                                  ncand_cta=per_cta, ncand_block=per_block, split=split))
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
    split_o, per_block_o = list_lengths(o, w, limit, prep, True, ms_o)
    per_cta_o = split_o["ncand_cta"]
    print(f"[3 main-path waves] deferred shadow wave ({t.numel()} lanes, "
          f"{int((t > 0).sum())} live): kernel {ms_o:.3f} ms (bound {bound_o[0]:.3f} ms, "
          f"{bound_o[1]}; {tests_o} tests), wrapper (prep + kernel) "
          f"{wrap_ms_o:.3f} ms, plain {plain_ms_o:.3f} ms, candidate groups per CTA "
          f"{per_cta_o:.2f} (per 2048-ray block {per_block_o:.2f}); {_split_text(split_o)}",
          flush=True)
    occ = _check_occluded("occluded deferred wave", ok, op, t > 0)
    del prep, ok

    # K3: the same kernel over single-leaf candidate lists (gs = 1)
    o1w, d1w, tm1w, hp1w = wave1
    prep = block_trace._prepare(fat, o1w, d1w, tm1w, gs=1)
    _, ms_k3 = _timed(lambda: block_trace.launch(fat, prep, False), reps=3)
    hk3 = block_trace.block_closest(fat, o1w, d1w, tm1w, gs=1)
    k3c = _compare_closest(fat, o1w, d1w, hk3, hp1w, tm1w > 0)
    bound_k3 = _bound(closest_waves[1]["tests"], _block_bytes(fat, prep, False))
    split_k3, per_block = list_lengths(o1w, d1w, tm1w, prep, False, ms_k3)
    print(f"[3 K3] closest wave 1 at gs=1: kernel {ms_k3:.3f} ms vs gs=4 "
          f"{closest_waves[1]['ms']:.3f} ms, candidates per CTA {split_k3['ncand_cta']:.2f} "
          f"(per 2048-ray block {per_block:.2f}); {_split_text(split_k3)}", flush=True)
    _check_closest("K3 closest wave 1", k3c)
    prep = block_trace._prepare(fat, o, w, limit, gs=1)
    _, ms_k3o = _timed(lambda: block_trace.launch(fat, prep, True), reps=3)
    ok3 = block_trace.block_occluded(fat, o, w, t, gs=1)
    split_k3o, per_block = list_lengths(o, w, limit, prep, True, ms_k3o)
    print(f"[3 K3] deferred shadow wave at gs=1: kernel {ms_k3o:.3f} ms vs gs=4 "
          f"{ms_o:.3f} ms, candidates per CTA {split_k3o['ncand_cta']:.2f} (per 2048-ray block "
          f"{per_block:.2f}); {_split_text(split_k3o)}", flush=True)
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
                        "binned closest": 0, "binned occluded": 0, **DISNEY_5,
                        **FINALIZE_5}, launches

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
                         "binned closest": 20, "binned occluded": 5, **DISNEY_5,
                         **FINALIZE_5}, launches6
    print(f"[6 binned path] {main6['ms_spp']:.1f} ms/spp vs {main5['ms_spp']:.1f} (phase 5); "
          f"image mean {main6['mean']:.6f} vs {main5['mean']:.6f} "
          f"(rel {abs(main6['mean'] - main5['mean']) / main5['mean']:.2e})", flush=True)

    # ---- 7: other configurations -------------------------------------------
    seed = 4  # phase 5's last sample
    for label, extra in (("binned_bounces=1", dict(binned_bounces=1)), ("gs=1", dict(gs=1))):
        cfg7 = integrator.RenderConfig(width=W, height=H, **BENCH, **extra)
        out = []
        k3_launches, traced = _traced_launches(lambda: out.append(
            integrator.render_path_with_counts(scene, view, cfg7, seed)[0]))
        img = out[0]
        mean = float(img.mean())
        rel = abs(mean - main5["mean"]) / main5["mean"]
        same = bool(torch.equal(img, img5))
        print(f"[7 {label}] image mean {mean:.6f} vs {main5['mean']:.6f} (rel {rel:.2e}), "
              f"equal to phase 5's sample {seed} bit for bit: {same}; "
              f"launches {dict(cuda_build.launches())}",
              flush=True)
        assert bool(torch.isfinite(img).all()) and rel <= PARITY_MEAN_REL
        assert k3_launches == traced, (label, k3_launches, traced)
        if label == "gs=1":
            # 759 single leaves: the culled mode, each wave at least one kernel
            # and the deferred wave (5 bounces of lanes) in chunks
            assert k3_launches["closest"] % 5 == 0 and k3_launches["occluded"] > 1, k3_launches
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

    # ---- 13: the textured colonnade (bench.py's config 4) ------------------
    col = _colonnade(dev, smi)

    # ---- 14: the rest of the path integrator --------------------------------
    torch.cuda.empty_cache()
    wave = _wavefront(dev, smi, scene, view, main5, img5)

    # ---- 15: BDPT, light tracing, ReSTIR, adaptive, kron, indirect_only -----
    torch.cuda.empty_cache()
    more, bd_k1, bd_k2 = _bdpt_phase(dev, smi, scene, view, main5, img5)

    # ---- 16: the frame pipeline ----------------------------------------------
    torch.cuda.empty_cache()
    frame, gb_wave = _frame_phase(dev, smi, scene, view, main5)
    atrous = frame["atrous_kernel"]

    # ---- 17: loaded scenes and the mesh ----------------------------------------
    torch.cuda.empty_cache()
    loaded, scan_waves = _loaded_phase(dev, smi, scene, view, main5, img5)
    scan_k1, scan_k2 = scan_waves["closest"], scan_waves["occluded"]

    # ---- 18: the Disney BSDF kernels on the benchmark's samples --------------
    torch.cuda.empty_cache()
    dis = _disney_phase(dev, smi)

    # ---- 19: finalize_hit on the benchmark's samples ---------------------------
    torch.cuda.empty_cache()
    fin = _finalize_phase(dev, smi)

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

    def bdpt_waves(kind, rows):
        """BDPT's waves of one kernel (phase 15) for the JSON line."""
        keys = ("lanes", "wave_live", "ms", "bound_ms", "bound_by", "plain_slice_ms", "tests",
                "agree")
        return dict(launches_per_sample=more["bdpt"]["launches"][kind],
                    waves={k: {f: c[f] for f in keys} for k, c in rows.items()},
                    max_abs_err=max(c.get("max_abs_err", float(c.get("mismatch", 0) > 0))
                                    for c in rows.values()))

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
             wave_split=[c["split"] for c in closest_waves],
             forced_list_modes=past["atrium_forced"]["closest"],
             bdpt=bdpt_waves("closest", bd_k1),
             gbuffer=dict(launches_per_frame=frame["gbuffer"]["launches"],
                          **{k: gb_wave[k] for k in ("lanes", "ms", "bound_ms", "bound_by",
                                                     "plain_slice_ms", "tests", "agree")}),
             colonnade=dict(launches=col["path"]["launches"]["block closest"],
                            wave_ms=[c["ms"] for c in col["waves"]["closest"]],
                            wave_bound_ms=[c["bound_ms"] for c in col["waves"]["closest"]],
                            wave_plain_slice_ms=[c["plain_slice_ms"]
                                                 for c in col["waves"]["closest"]],
                            agree=min(c["agree"] for c in col["waves"]["closest"]),
                            max_abs_err=max(c["max_abs_err"] for c in col["waves"]["closest"]),
                            tri_tests=[c["tests"] for c in col["waves"]["closest"]],
                            wave_ncand_cta=[c["ncand_cta"] for c in col["waves"]["closest"]]),
             scan=dict(launches=loaded["scan"]["launches"]["block closest"],
                       list_mode=loaded["scan"]["scene"]["list_mode"],
                       leaves=loaded["scan"]["scene"]["leaves"],
                       wave_ms=[c["ms"] for c in scan_k1],
                       wave_bound_ms=[c["bound_ms"] for c in scan_k1],
                       wave_bound_by=[c["bound_by"] for c in scan_k1],
                       wave_plain_slice_ms=[c["plain_slice_ms"] for c in scan_k1],
                       agree=min(c["agree"] for c in scan_k1),
                       max_abs_err=max(c["max_abs_err"] for c in scan_k1),
                       tri_tests=[c["tests"] for c in scan_k1],
                       wave_ncand_cta=[c["ncand_cta"] for c in scan_k1],
                       wave_split=[c["split"] for c in scan_k1],
                       wave_ms_forced_overflow=[c["split"]["global"]["ms"] for c in scan_k1],
                       wave_overflow=[c["split"]["culled"]["overflow"] for c in scan_k1])),
        dict(bt, name="block_trace occluded (K2)",
             replaces="stratum_tpu/ops/pallas_trace.py:1242",
             launches=launches["block occluded"], max_abs_err=float(occ["mismatch"] > 0),
             ms=ms_o, plain_ms=plain_ms_o, bound_ms=bound_o[0], bound_by=bound_o[1],
             wrapper_ms=wrap_ms_o, agree=occ["agree"], mismatch=occ["mismatch"],
             ncand_cta=per_cta_o, ncand_block=per_block_o, tri_tests=tests_o, rays=occ["rays"],
             live=occ["live"], split=split_o, forced_list_modes=past["atrium_forced"]["occluded"],
             bdpt=bdpt_waves("occluded", bd_k2),
             colonnade=dict(launches=col["path"]["launches"]["block occluded"],
                            ms=col["waves"]["occluded"]["ms"],
                            bound_ms=col["waves"]["occluded"]["bound_ms"],
                            plain_slice_ms=col["waves"]["occluded"]["plain_slice_ms"],
                            agree=col["waves"]["occluded"]["agree"],
                            tri_tests=col["waves"]["occluded"]["tests"],
                            ncand_cta=col["waves"]["occluded"]["ncand_cta"]),
             scan=dict(launches=loaded["scan"]["launches"]["block occluded"],
                       ms_forced_overflow=scan_k2["split"]["global"]["ms"],
                       overflow=scan_k2["split"]["culled"]["overflow"],
                       **{k: scan_k2[k] for k in ("ms", "bound_ms", "bound_by",
                                                  "plain_slice_ms", "agree", "tests",
                                                  "ncand_cta", "lanes", "split")})),
        dict(bt, name="block_trace closest at gs=1 (K3)",
             replaces="stratum_tpu/ops/pallas_trace.py:532",
             launches=k3_launches["closest"], max_abs_err=k3c["max_abs_err"],
             ms=ms_k3, plain_ms=closest_waves[1]["plain_ms"], bound_ms=bound_k3[0],
             bound_by=bound_k3[1], gs4_ms=closest_waves[1]["ms"], agree=k3c["agree"],
             split=split_k3,
             past_budget={k: v for k, v in past["closest"].items() if k != "emit"}),
        dict(bt, name="block_trace occluded at gs=1 (K3)",
             replaces="stratum_tpu/ops/pallas_trace.py:958",
             launches=k3_launches["occluded"], max_abs_err=float(k3o["mismatch"] > 0),
             ms=ms_k3o, plain_ms=plain_ms_o, bound_ms=bound_k3o[0], bound_by=bound_k3o[1],
             gs4_ms=ms_o, agree=k3o["agree"], mismatch=k3o["mismatch"], split=split_k3o,
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
        dict(common, name="a-trous iteration", source="stratum_tpu_torch/csrc/atrous.cu",
             replaces="stratum_tpu/render/denoise.py::atrous_filter", pallas=False,
             note="the reference's jnp a-trous filter, not a Pallas kernel",
             launches=atrous["launches_per_frame"][0],
             launches_traced=atrous["frame_traced"]["traced"],
             max_abs_err=atrous["kernel_vs_plain_max_abs"],
             ms=sum(atrous["launch_ms"]) / len(atrous["launch_ms"]),
             plain_ms=atrous["plain_ms_per_iteration"],
             bound_ms=sum(atrous["bound_ms"]) / len(atrous["bound_ms"]),
             bound_by="/".join(sorted(set(atrous["bound_by"]))),
             wave_ms=atrous["launch_ms"], wave_bound_ms=atrous["bound_ms"],
             wave_bound_by=atrous["bound_by"]),
    ] + [
        dict(common, name=f"Disney {op}", source="stratum_tpu_torch/csrc/disney.cu",
             replaces=f"stratum_tpu/render/disney.py::disney_{op}", pallas=False,
             note="the reference's jnp Disney BSDF, not a Pallas kernel",
             launches=launches[f"disney {op}"],
             max_abs_err=0.0 if not any(any(c["differing"].values()) for k in DISNEY_CONFIGS
                                        for c in dis[k]["calls"]) else None,
             info=dis["info"][op],
             **{k: {f: [c[f] for c in dis[k]["calls"] if c["op"] == op]
                    for f in ("ms", "back_to_back_ms", "bound_ms", "plain_ms", "lanes")}
                for k in DISNEY_CONFIGS})
        for op in ("eval", "sample")
    ] + [
        dict(common, name="finalize_hit", source="stratum_tpu_torch/csrc/finalize.cu",
             replaces="stratum_tpu/ops/pallas_trace.py:1877-1902", pallas=False,
             note="the reference's jnp finalize_hit, not a Pallas kernel",
             launches=launches["finalize"],
             max_abs_err=0.0 if not any(any(w["words"].values()) for k in DISNEY_CONFIGS
                                        for w in fin[k]["waves"]) else None,
             info=fin["info"],
             **{k: dict(counted=fin[k]["counted"], traced=fin[k]["traced"],
                        **{f: [w[f] for w in fin[k]["waves"]]
                           for f in ("ms", "back_to_back_ms", "bound_ms", "bound_distinct_ms",
                                     "plain_ms", "lanes")})
                for k in DISNEY_CONFIGS})
    ] + t_kernels
    print(json.dumps({"kernels": kernels,
                      "paths": {"main": main5, "binned": main6, "cornell": cornell,
                                "colonnade": col["path"], **wave, **more, **frame,
                                "scan": loaded["scan"]},
                      "loaded": {k: loaded[k] for k in ("tools", "gltf", "volumes", "mesh")},
                      "colonnade": {k: col[k] for k in ("golden", "tracers")},
                      "past_budgets": {k: past[k] for k in ("leaves", "triangles", "list_keys",
                                                           "emit_tile")},
                      "goldens": gold, "gpu_tests": gpu}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
