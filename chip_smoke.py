#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``stratum_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line of results:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the CUDA kernels from ``stratum_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernel against plain version: the block-trace kernel (closest and
   occluded) against its plain torch version on the full 132,778-triangle
   atrium, on 65,536-ray batches (primary, cosine secondary, shadow rays
   toward presampled lights) and on the waves one 1920x1080 sample of the
   main path hands the wrappers (five closest waves of 2,073,600 lanes, the
   deferred shadow wave of 10,368,000 lanes), with both times;
4. parity: the tiny atrium at 64x32, seeds 0-3, against the JAX reference's
   golden images (tests/golden/torch_atrium_tiny.npz);
5. main path: ``render_path_with_counts`` on the full atrium at 1920x1080
   with the bench configuration (Disney, 4 bounces, presample 4096,
   coherent tiles 16): 1 warm-up and 4 timed samples; the kernel launch
   counters are zeroed just before and read just after this phase.

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


def _check_closest(name, c):
    print(f"    {name}: {c}")
    assert c["agree"] >= BATCH_AGREE, (name, c)
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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from stratum_tpu_torch.core import math as smath
    from stratum_tpu_torch.ops import block_trace
    from stratum_tpu_torch.ops.intersect import T_MAX, ray_offset
    from stratum_tpu_torch.render import camera, integrator
    from stratum_tpu_torch.render.shading import shading_point_from_row
    from stratum_tpu_torch.scene import builtin, flatten
    from stratum_tpu_torch.utils import cuda_build

    dev = torch.device(DEVICE)
    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {smi} | {kind} x{torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- 2: build ---------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.load("block_trace")
    ptxas = [ln.strip() for ln in cuda_build.BUILD_LOG.get("block_trace", "").splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[2 build] block_trace.cu -> {cuda_build.library_path('block_trace').name} "
          f"in {time.perf_counter() - t0:.3f} s; ptxas: {' | '.join(ptxas)}", flush=True)

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

    def secondary_and_shadow(o, d, h):
        """Cosine-sampled bounce rays and shadow rays toward presampled
        lights from the hits of ``h`` (misses become dead lanes)."""
        n = o.shape[0]
        hf = block_trace.finalize_hit(scene.slot_payload, o, d, h)
        sp = shading_point_from_row(hf.payload[:, :32], hf.tri, hf.bary, d)
        u = torch.from_numpy(rng.random((n, 2), dtype=np.float32)).to(dev)
        d2 = smath.to_world(smath.sample_cos_hemisphere(u[:, 0], u[:, 1]), sp.geom_normal)
        o2 = ray_offset(sp.position, sp.geom_normal)
        tm2 = torch.where(hf.hit, T_MAX, 0.0)
        idx = torch.from_numpy(rng.integers(0, cfg.presample_lights, n)).to(dev)
        ls = integrator.tile_row_sample(tile, idx)
        wi, dist, cos_l, _ = integrator.light_segment(ls, sp.position, o2, lo, hi)
        tm3 = torch.where(hf.hit & (cos_l > 0), dist, 0.0)
        return (o2, d2, tm2), (o2, wi, tm3)

    sel = torch.from_numpy(np.sort(rng.choice(W * H, N_CHECK, replace=False))).to(dev)
    o1, d1 = o_full[sel], d_full[sel]
    hk1 = block_trace.block_closest(fat, o1, d1)
    hp1 = block_trace.block_closest_plain(fat, o1, d1)
    (o2, d2, tm2), (o3, w3, tm3) = secondary_and_shadow(o1, d1, hk1)
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
    closest_waves = []
    for i, (o, d, tm) in enumerate(waves["closest"]):
        prep = block_trace._prepare(fat, o, d, tm)
        _, ms = _timed(lambda: block_trace.launch(fat, prep, False), reps=3)
        hk, wrap_ms = _timed(lambda: block_trace.block_closest(fat, o, d, tm))
        hp, plain_ms = _timed(
            lambda: block_trace.block_closest_plain(fat, o, d, tm), warmup=False)
        c = _compare_closest(fat, o, d, hk, hp, tm > 0)
        print(f"[3 main-path waves] closest wave {i} ({c['rays']} lanes, {c['live']} live): "
              f"kernel {ms:.3f} ms, wrapper (prep + kernel) {wrap_ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, candidate groups/block "
              f"{prep.ncand.float().mean().item():.2f}", flush=True)
        _check_closest(f"closest wave {i}", c)
        closest_waves.append(dict(c, ms=ms, wrapper_ms=wrap_ms, plain_ms=plain_ms))
        del prep, hk, hp
    ((o, w, t),) = waves["occluded"]
    prep = block_trace._prepare(fat, o, w, t * block_trace.SHADOW_EPS)
    _, ms_o = _timed(lambda: block_trace.launch(fat, prep, True), reps=3)
    ok, wrap_ms_o = _timed(lambda: block_trace.block_occluded(fat, o, w, t))
    op, plain_ms_o = _timed(
        lambda: block_trace.block_occluded_plain(fat, o, w, t), warmup=False)
    print(f"[3 main-path waves] deferred shadow wave ({t.numel()} lanes, "
          f"{int((t > 0).sum())} live): kernel {ms_o:.3f} ms, wrapper (prep + kernel) "
          f"{wrap_ms_o:.3f} ms, plain {plain_ms_o:.3f} ms, candidate groups/block "
          f"{prep.ncand.float().mean().item():.2f}", flush=True)
    occ = _check_occluded("occluded deferred wave", ok, op, t > 0)
    del waves, prep, ok, op, o, w, t
    torch.cuda.empty_cache()

    # ---- 4: parity with the JAX reference's golden images -----------------
    gold = np.load(ROOT / "tests" / "golden" / "torch_atrium_tiny.npz")
    tw, th = 64, 32
    tiny, _ = flatten.flatten(builtin.atrium(columns=1, stacks=6, slices=12).root, device=dev)
    view_t = camera.make_view(gold["camera_to_world"], float(gold["fovy"]), tw, th, device=dev)
    cfg_t = integrator.RenderConfig(width=tw, height=th, **BENCH)
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in block_trace.LAUNCHES:
        block_trace.LAUNCHES[k] = 0
    samples, times, total_rays = 5, [], 0
    for seed in range(samples):
        t0 = time.perf_counter()
        img, n = integrator.render_path_with_counts(scene, view, cfg, seed)
        n = int(n)  # synchronizes, like the reference bench's fetch
        torch.cuda.synchronize()
        if seed > 0:  # sample 0 is the warm-up
            times.append(time.perf_counter() - t0)
            total_rays += n
    launches = dict(block_trace.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    mean = float(img.mean())
    ms_spp = sum(times) / len(times) * 1e3
    mrays = total_rays / sum(times) / 1e6
    print(f"[5 main path] atrium {W}x{H} {cfg.max_bounces} bounces disney: "
          f"{ms_spp:.1f} ms/spp, {mrays:.3f} Mrays/s ({total_rays // len(times)} rays/spp), "
          f"launches/sample closest {launches['closest'] / samples} occluded "
          f"{launches['occluded'] / samples}, peak {peak_gib:.2f} GiB, "
          f"image mean {mean:.6f} | {smi}", flush=True)
    assert bool(torch.isfinite(img).all()) and mean > 0
    assert launches == {"closest": 5 * samples, "occluded": samples}, launches
    assert total_rays // len(times) > W * H

    # ms / plain_ms / wrapper_ms of K1 are means per closest wave over the
    # main path's five waves; K2's are the deferred shadow wave's. K2's
    # output is a 0/1 flag, so its max_abs_err is max |kernel - plain| over
    # those flags and ``mismatch`` counts the lanes where they differ.
    n_w = len(closest_waves)
    kernels = [
        dict(name="block_trace closest (K1)", route="cuda",
             source="stratum_tpu_torch/csrc/block_trace.cu",
             replaces="stratum_tpu/ops/pallas_trace.py:1242",
             launches=launches["closest"],
             max_abs_err=max(c["max_abs_err"] for c in closest_waves),
             ms=sum(c["ms"] for c in closest_waves) / n_w,
             plain_ms=sum(c["plain_ms"] for c in closest_waves) / n_w,
             wrapper_ms=sum(c["wrapper_ms"] for c in closest_waves) / n_w,
             agree=min(c["agree"] for c in closest_waves),
             wave_ms=[c["ms"] for c in closest_waves],
             wave_plain_ms=[c["plain_ms"] for c in closest_waves],
             rays=[c["rays"] for c in closest_waves],
             live=[c["live"] for c in closest_waves]),
        dict(name="block_trace occluded (K2)", route="cuda",
             source="stratum_tpu_torch/csrc/block_trace.cu",
             replaces="stratum_tpu/ops/pallas_trace.py:1242",
             launches=launches["occluded"], max_abs_err=float(occ["mismatch"] > 0),
             ms=ms_o, plain_ms=plain_ms_o, wrapper_ms=wrap_ms_o,
             agree=occ["agree"], mismatch=occ["mismatch"], rays=occ["rays"],
             live=occ["live"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
