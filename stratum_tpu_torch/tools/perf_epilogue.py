"""T2: the cost of the visit's epilogue. The counterpart of
tools/perf_epilogue.py (TPU kernel ``main.<locals>.kernel`` :106,
pallas_call :156).

One exec is the C=48 product of a bf16 ``[48, 4K]`` slab with the rays
perturbed per iteration (``rays + i * 1e-9``), then one epilogue:

  none      min of the a band into best (the product alone)
  classify  sign-normalised validity, min of stn (no argmin, no commit)
  nodiv     the full epilogue with the divide replaced by a multiply
  full      the real epilogue (``classify`` + ``select_update``)
  fused     min-chain validity + xor sign flip + deferred valid/inf fold

The perturbation promotes the bf16 rays to f32, and the reference's
product is then a true f32 one: in Pallas interpret mode the slab times the
unrounded f32 rays (checked: an all-ones slab against rays of 1 + 2^-12
gives 48 * (1 + 2^-12) exactly, not 48). The kernel computes the same by
splitting the f32 rays into three bf16 parts, hi + mid + lo, whose sum is
the f32 value exactly, and running three bf16 products into one f32
accumulator. Where the rays are bf16 values of magnitude >= 2^-8 the
perturbation rounds away and mid = lo = 0.

On the card the execs run in ``csrc/microbench.cu``'s epilogue kernel: one
CTA per 128 lanes, one warp per 16 lanes. ``python3 -m
stratum_tpu_torch.tools.perf_epilogue [--k=512] [--sw=128] [--iters=64]
[--reps=20] [--cpu]`` prints ns per exec of each variant.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from stratum_tpu_torch import tools
from stratum_tpu_torch.ops import mt_commit as mt
from stratum_tpu_torch.utils.flags import Options

VARIANTS = ("none", "classify", "nodiv", "full", "fused")
LANES = 128  # lanes per CTA of the kernel
# |best| between two runs that sum the products in other orders, relative:
# the packed argmin's 2^-13 band, doubled for the f32 sums of a
# well-conditioned winner (~1e-6 relative); a winner whose determinant
# nearly cancels, or that sits on a validity edge, can exceed it
REL_TOL = 2.0 ** -12

LAUNCHES = {"epilogue": 0}


def run(slab, rays, variant: str, k: int, sw: int, iters: int) -> torch.Tensor:
    """``[1, sw]`` f32 best after ``iters`` execs. slab: bf16 [48, 4k]; rays:
    bf16 [48, sw]. CUDA tensors launch the kernel, CPU tensors run
    :func:`run_plain`."""
    if slab.device.type == "cpu":
        return run_plain(slab, rays, variant, k, sw, iters)
    if not (8 <= k <= 1 << mt.IDX_BITS and k % 8 == 0):
        raise ValueError(f"k = {k}: the kernel takes multiples of 8 up to {1 << mt.IDX_BITS}")
    if sw % LANES:
        raise ValueError(f"sw = {sw}: the kernel takes multiples of {LANES}")
    tools.check(slab, "slab", torch.bfloat16, (mt.C, 4 * k))
    tools.check(rays, "rays", torch.bfloat16, (mt.C, sw))
    out = torch.empty((1, sw), dtype=torch.float32, device=slab.device)
    tools.launch("mb_epilogue", [slab.data_ptr(), rays.data_ptr(), out.data_ptr()],
                 [VARIANTS.index(variant), k, sw, iters], slab.device)
    LAUNCHES["epilogue"] += 1
    return out


def run_plain(slab, rays, variant: str, k: int, sw: int, iters: int) -> torch.Tensor:
    """Plain torch twin of :func:`run`, step for step as the TPU kernel
    (perf_epilogue.py:106-146)."""
    best = torch.full((sw,), mt.T_INIT, device=slab.device)
    for i in range(iters):
        r = rays.float() + float(np.float32(i) * np.float32(1e-9))
        a, u, v, t = mt.bands(mt.mt_product(slab, r))
        if variant == "none":
            best = torch.minimum(best, a.amin(dim=0))
        elif variant == "classify":
            abs_a, stn, valid = mt.mt_classify(a, u, v, t, cap=False)
            best = torch.minimum(best, torch.where(valid, stn, float("inf")).amin(dim=0))
        elif variant in ("nodiv", "full"):
            abs_a, stn, valid = mt.mt_classify(a, u, v, t, cap=False)
            best = mt.select_update_tool(valid, stn, abs_a, best, div=variant == "full")
        elif variant == "fused":
            abs_a, stn, m1, m2 = mt.classify_fused(a, u, v, t)
            best = mt.select_fused(m1, m2, stn, abs_a, best)
        else:
            raise ValueError(variant)
    return best[None]


def main(argv=None) -> dict:
    opts = Options(sys.argv[1:] if argv is None else argv)
    device = tools.device_of(opts)
    K = opts.get_int("k", 512)
    SW = opts.get_int("sw", 128)
    ITERS = opts.get_int("iters", 64)
    REPS = opts.get_int("reps", 20)
    print(f"devices: {tools.describe(device)}  k={K} sw={SW} iters={ITERS}")
    rng = np.random.default_rng(0)
    slab = tools.from_numpy(rng.standard_normal((mt.C, 4 * K)), device, torch.bfloat16)
    rays = tools.from_numpy(rng.standard_normal((mt.C, SW)), device, torch.bfloat16)

    results = {}
    for variant in VARIANTS:
        out, dt = tools.time_call(lambda: run(slab, rays, variant, K, SW, ITERS), REPS, device)
        dt /= ITERS
        results[variant] = dict(ns_per_exec=dt * 1e9, out=out)
        print(f"{variant:9s}: {dt*1e9:8.1f} ns/exec")
    sm_flops = tools.PEAK_BF16_FLOPS / tools.SMS
    bound = 2 * mt.C * 4 * K * SW / sm_flops
    print(f"tensor-core bound of one C=48 exec on one SM: {bound*1e9:8.1f} ns "
          f"(three bf16 products: {3 * bound*1e9:8.1f} ns)")
    return results


if __name__ == "__main__":
    main()
