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
CTA per 128 lanes (two warpgroups of 64, the three products wgmma), the
slab streamed through a TMA ring of 32-row tiles on every exec. ``python3 -m
stratum_tpu_torch.tools.perf_epilogue [--k=512] [--sw=128] [--iters=64]
[--reps=20] [--cpu]`` prints ns per exec of each variant.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from stratum_tpu_torch import tools
from stratum_tpu_torch.ops import mt_commit as mt
from stratum_tpu_torch.utils import cuda_build
from stratum_tpu_torch.utils.flags import Options

VARIANTS = ("none", "classify", "nodiv", "full", "fused")
LANES = 128  # lanes per CTA of the kernel
# |best| between two runs that sum the products in other orders, relative:
# the packed argmin's 2^-13 band, doubled for the f32 sums of a
# well-conditioned winner (~1e-6 relative). A winner whose sums cancel past
# CANCELLING can exceed it: the checks hold each lane to :func:`tolerance`
REL_TOL = 2.0 ** -12

_KERNEL = cuda_build.entry("microbench.cu", "mb_epilogue", "ppp iiii p")


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
    cuda_build.check(slab, "slab", torch.bfloat16, (mt.C, 4 * k), slab.device)
    cuda_build.check(rays, "rays", torch.bfloat16, (mt.C, sw), slab.device)
    out = torch.empty((1, sw), dtype=torch.float32, device=slab.device)
    cuda_build.launch(_KERNEL, slab.device, slab.data_ptr(), rays.data_ptr(), out.data_ptr(),
                      VARIANTS.index(variant), k, sw, iters)
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


def tolerance(slab, rays, variant: str, k: int, iters: int, want: torch.Tensor) -> torch.Tensor:
    """Per-lane bound on |best| of two runs that sum each candidate's 48
    products in other orders (``want``: [1, sw], one of them). Each sum may
    differ by SUM_ULPS x 48 x the sum of its terms' magnitudes; carried into
    the value the variant minimises (a; stn; stn |a|; stn / |a|) that is the
    candidate's error. Over every candidate (exec, row) that may be valid on
    either side (each accept condition held within its sums' errors, the
    closer-than-best test left out) and whose value may reach the lane's
    best, the bound is the largest error plus, where the minimum is packed,
    the packed argmin's band (2^-13 of the value on each side)."""
    u_sum = tools.SUM_ULPS * mt.C
    s = slab.double()
    bound = torch.zeros_like(want, dtype=torch.float64)
    best = want.double().abs()
    for i in range(iters):
        r = (rays.float() + float(np.float32(i) * np.float32(1e-9))).double()
        a, u, v, t = (x.T @ r for x in s.chunk(4, dim=1))
        ea, eu, ev, et = (u_sum * (x.abs().T @ r.abs()) for x in s.chunk(4, dim=1))
        sgn = torch.sign(a)
        abs_a, su, sv, stn = a.abs(), u * sgn, v * sgn, t * sgn
        maybe = ((abs_a + ea > 1e-12) & (su + eu >= 0) & (sv + ev >= 0)
                 & (su + sv - eu - ev <= abs_a + ea) & (stn + et > 1e-4 * (abs_a - ea)))
        if variant == "none":
            val, err, maybe = a, ea, torch.ones_like(maybe)
        elif variant == "classify":
            val, err = stn, et
        elif variant == "nodiv":
            val, err = stn * abs_a, et * abs_a + stn.abs() * ea
        else:
            val = stn / abs_a
            err = (et + val.abs() * ea) / abs_a
        band = 0.0 if variant in ("none", "classify") else 2.0 ** -12 * val.abs()
        reach = maybe & (val - err - band <= best + 2.0 ** -12 * best)
        bound = torch.maximum(bound, torch.where(reach, err + band, 0.0).amax(dim=0, keepdim=True))
    return bound


# Where an f32 run sums a candidate's 48 products whose magnitudes add to c
# times the sum's own, its value moves by up to SUM_ULPS x 48 x c relative:
# past REL_TOL's 2^-12 once c exceeds this (about 10.7)
CANCELLING = 2.0 ** -12 / (tools.SUM_ULPS * mt.C)


def witness(slab, rays, variant: str, k: int, iters: int) -> dict:
    """The variant run in float64, products exact: per lane ([sw] tensors)
    its best (the least value over valid candidates; every candidate for
    ``none``), the exec and row of the candidate that gives it, that
    candidate's |a|, and how far its sums cancel: ``cancel_a`` and
    ``cancel_t``, the sum of the magnitudes of its 48 a (t_num) products
    over the magnitude of their sum (1 where nothing cancels; past
    CANCELLING the f32 sums may move its value beyond REL_TOL)."""
    s = slab.double()
    sw = rays.shape[1]
    di = [float(np.float32(i) * np.float32(1e-9)) for i in range(iters)]
    best = torch.full((sw,), float("inf"), dtype=torch.float64, device=slab.device)
    exe = torch.zeros(sw, dtype=torch.long, device=slab.device)
    row = torch.zeros(sw, dtype=torch.long, device=slab.device)
    for i in range(iters):
        r = (rays.float() + di[i]).double()
        a, u, v, t = (x.T @ r for x in s.chunk(4, dim=1))
        sgn = torch.sign(a)
        abs_a, su, sv, stn = a.abs(), u * sgn, v * sgn, t * sgn
        if variant == "none":
            val = a
        else:
            valid = ((abs_a > 1e-12) & (su >= 0) & (sv >= 0) & (su + sv <= abs_a)
                     & (stn > 1e-4 * abs_a))
            val = {"classify": stn, "nodiv": stn * abs_a}.get(
                variant, stn / abs_a.clamp(min=1e-300))
            val = torch.where(valid, val, float("inf"))
        m, at = val.min(dim=0)
        closer = m < best
        best = torch.where(closer, m, best)
        exe = torch.where(closer, i, exe)
        row = torch.where(closer, at, row)
    r = (rays.float() + torch.tensor(di, device=slab.device)[exe]).double()
    terms_a = s[:, row] * r
    terms_t = s[:, 3 * k + row] * r
    abs_a = terms_a.sum(dim=0).abs()
    return dict(best=best, exec=exe, row=row, abs_a=abs_a,
                cancel_a=terms_a.abs().sum(dim=0) / abs_a,
                cancel_t=terms_t.abs().sum(dim=0) / terms_t.sum(dim=0).abs())


def past_band(slab, rays, variant: str, k: int, iters: int, got, want) -> list:
    """The lanes where two runs (``got``, ``want``: [1, sw]) differ by more
    than REL_TOL of the value, each beside the float64 run's winner
    (:func:`witness`) -> [dict(lane, cancel, line)]: ``cancel`` the larger of
    the winner's two cancellations, ``line`` all of it in words."""
    g, w = got[0].double(), want[0].double()
    past = (g != w) & ((g - w).abs() > REL_TOL * w.abs())
    if not bool(past.any()):
        return []
    wit = witness(slab, rays, variant, k, iters)
    out = []
    for lane in past.nonzero().flatten().tolist():
        ca, ct = float(wit["cancel_a"][lane]), float(wit["cancel_t"][lane])
        out.append(dict(lane=lane, cancel=max(ca, ct), line=(
            f"{variant} k={k} lane {lane}: {float(g[lane]):.9e} against {float(w[lane]):.9e} "
            f"({float((g[lane] - w[lane]).abs() / w[lane].abs()):.3e} relative), float64 "
            f"{float(wit['best'][lane]):.9e}; its winner exec {int(wit['exec'][lane])}, row "
            f"{int(wit['row'][lane])}, |a| {float(wit['abs_a'][lane]):.4e}, a sums cancel "
            f"{ca:.1f}x, t_num {ct:.1f}x")))
    return out


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
