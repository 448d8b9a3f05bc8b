"""T1: where does a sub-commit's time go? The counterpart of
tools/perf_commit_pipeline.py (TPU kernel ``_kernel`` :77, pallas_call
:264).

Each variant runs ``iters`` visits of one sub-commit: a bf16 c48 product
``[48, 4K] x [48, B]`` (B = 128 lanes; 256 for ``epi_x2`` / ``epi_w256``)
whose slab comes from a 4-deep ring, then a consume or commit. The variants
are the reference's: ``bare`` (product, row 0 consumed), ``classify``
(+ ``mt_classify``, accumulated), ``epi`` (the real commit:
``select_update`` with the packed argmin), ``epi_when`` (each commit under
``word[i % 8] & 1``), ``epi_while`` (trip count read from the device tensor
``n``), ``epi_drain`` (each commit gated on a CTA-wide min of best),
``epi_x2`` (two 128-lane sub-commits per visit), ``epi_w256`` (one 256-lane
commit) and ``ring`` (the deferred-merge commit). The output is ``[2, 128]``
f32: ``best + acc[0]`` and the slot.

On the card the visit is ``csrc/microbench.cu``'s commit-pipeline kernel:
one CTA, two warpgroups of 64 lanes on wgmma, the slab streamed through a
TMA ring of 32-row tiles by a producer warpgroup. ``epi_x2`` runs two such
128-lane commits back to back, each its own pass over the slab;
``epi_w256`` one commit of warpgroups of 128 lanes on 16-row tiles, each
tile streamed once for all 256. ``run_inner`` also takes
the lanes of several independent CTAs side by side, which times a visit
per SM with the card full (the tool itself runs one). ``python3 -m
stratum_tpu_torch.tools.perf_commit_pipeline [--iters=2048]
[--base_iters=512] [--k=1024] [--cpu]`` prints each variant's marginal ns
per commit between the two trip counts.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from stratum_tpu_torch import tools
from stratum_tpu_torch.ops import mt_commit as mt
from stratum_tpu_torch.utils import cuda_build
from stratum_tpu_torch.utils.flags import Options

NL = 4  # slab ring depth
B = 128  # sub-block width
VARIANTS = ("bare", "classify", "epi", "epi_when", "epi_while", "epi_drain",
            "epi_x2", "epi_w256", "ring")
WIDE = ("epi_x2", "epi_w256")  # 256 lanes, two commits per visit in the ns math
SINK = 512  # f32 per-thread sink of the classify variant's unread rows

_KERNEL = cuda_build.entry("microbench.cu", "mb_commit_pipeline", "pppppp iiii p")


def lanes_of(variant: str) -> int:
    return 2 * B if variant in WIDE else B


def run_inner(rays, feat, word, n, variant: str, k: int, iters: int) -> torch.Tensor:
    """``[2, 128]`` f32 (best + acc row 0, slot) of ``iters`` visits (``n[0]``
    for ``epi_while`` and ``ring``). rays: bf16 [48, lanes]; feat: bf16
    [4, 48, 4k]; word: i32 [8]; n: i32 [1]. Rays of ``ctas`` x lanes
    columns run that many independent CTAs over the same slabs and give
    ``[2, ctas x 128]``. CUDA tensors launch the kernel, CPU tensors run
    :func:`run_inner_plain`."""
    if rays.device.type == "cpu":
        return run_inner_plain(rays, feat, word, n, variant, k, iters)
    lanes = lanes_of(variant)
    ctas = rays.shape[1] // lanes
    if not (8 <= k <= 1 << mt.IDX_BITS and k % 8 == 0):
        raise ValueError(f"k = {k}: the kernel takes multiples of 8 up to {1 << mt.IDX_BITS}")
    for x, name, dt, shape in ((rays, "rays", torch.bfloat16, (mt.C, max(ctas, 1) * lanes)),
                               (feat, "feat", torch.bfloat16, (NL, mt.C, 4 * k)),
                               (word, "word", torch.int32, (8,)),
                               (n, "n", torch.int32, (1,))):
        cuda_build.check(x, name, dt, shape, rays.device)
    out = torch.empty((2, ctas * B), dtype=torch.float32, device=rays.device)
    sink = torch.empty(ctas * SINK, dtype=torch.float32, device=rays.device)
    cuda_build.launch(_KERNEL, rays.device,
                      *(x.data_ptr() for x in (rays, feat, word, n, out, sink)),
                      VARIANTS.index(variant), k, iters, ctas)
    return out


def run_inner_plain(rays, feat, word, n, variant: str, k: int, iters: int) -> torch.Tensor:
    """Plain torch twin of :func:`run_inner`, step for step as the TPU
    kernel (perf_commit_pipeline.py:77-241), one CTA's lanes at a time."""
    lanes = lanes_of(variant)
    if rays.shape[1] > lanes:
        return torch.cat([run_inner_plain(rays[:, i:i + lanes], feat, word, n, variant, k, iters)
                          for i in range(0, rays.shape[1], lanes)], dim=1)
    dev = rays.device
    best = torch.full((lanes,), mt.T_INIT, device=dev)
    slot = torch.full((lanes,), -1.0, device=dev)
    acc = torch.zeros((2, B), device=dev)  # the rows of acc the output reads

    def visit(i, lo=0, w=B):
        return mt.bands(mt.mt_product(feat[i % NL], rays[:, lo:lo + w]))

    def commit(i, lo=0, w=B):
        abs_a, stn, valid = mt.mt_classify(*visit(i, lo, w))
        best[lo:lo + w], slot[lo:lo + w] = mt.select_update(
            valid, stn, abs_a, best[lo:lo + w], slot[lo:lo + w], i * k)

    if variant == "bare":
        for i in range(iters):
            acc[0] = acc[0] + visit(i)[0][0]
    elif variant == "classify":
        for i in range(iters):
            abs_a, stn, valid = mt.mt_classify(*visit(i))
            acc[0] = acc[0] + torch.where(valid, stn, abs_a)[0]
    elif variant in ("epi", "epi_when", "epi_drain"):
        for i in range(iters):
            if variant == "epi_when" and not int(word[i % 8]) & 1:
                continue
            if variant == "epi_drain" and not float(best.min()) > -1.0:
                continue
            commit(i)
    elif variant == "epi_while":
        for c in range(int(n[0])):
            commit(c)
    elif variant == "epi_x2":
        for i in range(iters):
            commit(i, 0, B)
            commit(i, B, B)
    elif variant == "epi_w256":
        for i in range(iters):
            commit(i, 0, 2 * B)
    elif variant == "ring":
        acc.fill_(float("inf"))
        want = True
        for c in range(int(n[0])):
            if c > 0:
                closer = acc[0] < best
                best, slot = torch.where(closer, acc[0], best), torch.where(closer, acc[1], slot)
                acc[0] = float("inf")
            if want:
                abs_a, stn, valid = mt.mt_classify(*visit(c))
                acc[0], acc[1] = mt.ring_pack(valid, stn, abs_a, c, k)
            want = float(best[:B].min()) > -1.0
        if int(n[0]) > 0:
            closer = acc[0] < best
            best, slot = torch.where(closer, acc[0], best), torch.where(closer, acc[1], slot)
    else:
        raise ValueError(variant)
    return torch.stack([best[:B] + acc[0], slot[:B]])


def tolerance(rays, feat, k: int, iters: int, variant: str, out: torch.Tensor) -> torch.Tensor:
    """Per-lane bound on the difference of row 0 of ``out`` ([2, 128]) and
    of another run that sums the products in other orders, for lanes with
    the same slot. ``bare`` / ``classify``: acc[0] sums iters x 48 products
    of row 0 of the a or t band, plus two ulps of the output. The commits:
    the packed argmin's cleared band (2^-13 relative) and the Newton
    reciprocal (2^-16), plus the f32 error of the winner's two sums (a,
    t_num) carried into stn / |a|; twice that for ``ring``, whose output
    adds a second t."""
    r = rays.double()[:, :B].abs()
    f = feat.double()
    t = out[0].double().abs()
    if variant in ("bare", "classify"):
        rows = f[torch.arange(iters, device=f.device) % NL][:, :, [0, 3 * k]].abs().sum(dim=0)
        s = (rows.T @ r).amax(dim=0)
        ulp = torch.nextafter(out[0], torch.full_like(out[0], float("inf"))) - out[0]
        return tools.SUM_ULPS * (mt.C + iters) * s + 2 * ulp.double().abs()
    slot = out[1].long().clamp(min=0)
    i, row = slot // k % NL, slot % k
    fa = f[i, :, row] * rays.double()[:, :B].T  # the winner's a terms per lane
    ft = f[i, :, 3 * k + row] * rays.double()[:, :B].T  # and its t_num terms
    err = tools.SUM_ULPS * mt.C * (ft.abs().sum(dim=1) + t * fa.abs().sum(dim=1))
    bound = (2.0 ** -13 + 2.0 ** -16) * t + err / fa.sum(dim=1).abs()
    return 2 * bound if variant == "ring" else bound


def operands(variant: str, k: int, iters: int, device):
    """The reference's timing operands (perf_commit_pipeline.py:285-294):
    uniform [0, 0.5) rays and slabs from seed 0, every word bit set. With
    them no candidate is ever valid (every product row is positive and
    su + sv > |a|), so nothing commits; the commit work does not depend on
    the data."""
    rng = np.random.default_rng(0)
    rays = rng.random((mt.C, lanes_of(variant)), np.float32) * 0.5
    feat = rng.random((NL, mt.C, 4 * k), np.float32) * 0.5
    return (tools.from_numpy(rays, device, torch.bfloat16),
            tools.from_numpy(feat, device, torch.bfloat16),
            torch.full((8,), 0xFF, dtype=torch.int32, device=device),
            torch.tensor([iters], dtype=torch.int32, device=device))


def main(argv=None) -> dict:
    opts = Options(sys.argv[1:] if argv is None else argv)
    iters = opts.get_int("iters", 2048)
    base_iters = opts.get_int("base_iters", 512)
    k = opts.get_int("k", 1024)
    device = tools.device_of(opts)
    print(f"devices: {tools.describe(device)}  iters={base_iters}->{iters} k={k}")
    results, base_ns = {}, None

    def timed(v, it):
        args = operands(v, k, it, device)
        return tools.time_call(lambda: run_inner(*args, v, k, it), 8, device)[1]

    for v in VARIANTS:
        # the marginal cost between two trip counts cancels the launch
        d_lo = timed(v, base_iters)
        d_hi = timed(v, iters)
        per = 2 if v in WIDE else 1
        ns = (d_hi - d_lo) / ((iters - base_iters) * per) * 1e9
        note = ""
        if v == "bare":
            base_ns = ns
        elif base_ns:
            note = f"  ({ns - base_ns:+8.1f} over bare)"
        print(f"{v:10s}: {d_hi * 1e3:8.3f} ms  {ns:8.1f} ns/commit "
              f"(marginal){note}", flush=True)
        results[v] = dict(ms=d_hi * 1e3, ms_base=d_lo * 1e3, ns_per_commit=ns)
    return results


if __name__ == "__main__":
    main()
