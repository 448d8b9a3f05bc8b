"""T3: does a loop of c48 products scale with its trip count? The
counterpart of tools/probe_mxu_loop.py (TPU kernel ``_kernel`` :35,
pallas_call :60).

``iters`` bf16 products ``[48, 4K] x [48, 128]`` whose slab comes from a
4-deep ring; row 0 of each is accumulated, and a scalar carry
``carry + out[0, 0] * 1e-30`` runs beside. With ``dep`` the carry, rounded
to bf16, is added to the rays before every product, so no product can start
before the previous one ends. The output ``[1, 128]`` is ``acc[0] + carry``.

On the card the loop is ``csrc/microbench.cu``'s product-loop kernel, the
commit pipeline's bare visit (wgmma products of the slab's 32-row tiles,
streamed by TMA through a ring in shared memory) plus the carry, in one CTA
(the carry is one scalar that every lane reads). ``python3 -m
stratum_tpu_torch.tools.probe_mxu_loop [--k=1024] [--cpu]`` times it at 256,
1024 and 4096 iterations, without and with ``dep``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from stratum_tpu_torch import tools
from stratum_tpu_torch.ops import mt_commit as mt
from stratum_tpu_torch.utils import cuda_build
from stratum_tpu_torch.utils.flags import Options

B = 128
NL = 4
TRIPS = (256, 1024, 4096)  # the trip counts main() times

_KERNEL = cuda_build.entry("microbench.cu", "mb_mxu_loop", "ppp iii p")


def run(rays, feat, iters: int, dep: bool) -> torch.Tensor:
    """``[1, 128]`` f32 ``acc[0] + carry`` after ``iters`` products. rays:
    bf16 [48, 128]; feat: bf16 [4, 48, 4k]. CUDA tensors launch the kernel,
    CPU tensors run :func:`run_plain`."""
    if rays.device.type == "cpu":
        return run_plain(rays, feat, iters, dep)
    k = feat.shape[-1] // 4
    if not (8 <= k and k % 8 == 0):
        raise ValueError(f"k = {k}: the kernel takes multiples of 8")
    cuda_build.check(rays, "rays", torch.bfloat16, (mt.C, B), rays.device)
    cuda_build.check(feat, "feat", torch.bfloat16, (NL, mt.C, 4 * k), rays.device)
    out = torch.empty((1, B), dtype=torch.float32, device=rays.device)
    cuda_build.launch(_KERNEL, rays.device, rays.data_ptr(), feat.data_ptr(), out.data_ptr(), k,
                      iters, int(bool(dep)))
    return out


def run_plain(rays, feat, iters: int, dep: bool) -> torch.Tensor:
    """Plain torch twin of :func:`run`, step for step as the TPU kernel
    (probe_mxu_loop.py:35-55); the carry stays a 0-d f32 tensor."""
    acc = torch.zeros(B, device=rays.device)
    carry = torch.zeros((), device=rays.device)
    for i in range(iters):
        r = rays + carry.to(torch.bfloat16) if dep else rays
        out = mt.mt_product(feat[i % NL], r)
        acc = acc + out[0]
        carry = carry + out[0, 0] * 1e-30
    return (acc + carry)[None]


def tolerance(rays, feat, iters: int) -> torch.Tensor:
    """Bound on |out| between two runs that sum the products in other
    orders ([1, 128]): each output sums iters x 48 products (the carry's
    share is below 1e-26)."""
    s = feat.double()[torch.arange(iters, device=feat.device) % NL, :, 0].abs().sum(dim=0)
    return (tools.SUM_ULPS * (mt.C + iters) * (s @ rays.double().abs()))[None] + 1e-26


def main(argv=None) -> dict:
    opts = Options(sys.argv[1:] if argv is None else argv)
    k = opts.get_int("k", 1024)
    device = tools.device_of(opts)
    print(f"devices: {tools.describe(device)}  k={k}")
    rng = np.random.default_rng(0)
    rays = tools.from_numpy(rng.random((mt.C, B), np.float32) * 0.5, device, torch.bfloat16)
    feat = tools.from_numpy(rng.random((NL, mt.C, 4 * k), np.float32) * 0.5, device,
                            torch.bfloat16)
    results = {}
    for dep in (False, True):
        prev = None
        for iters in TRIPS:
            out, dt = tools.time_call(lambda: run(rays, feat, iters, dep), 8, device)
            scale = "" if prev is None else f"  x{dt/prev:.2f} vs prev"
            prev = dt
            print(f"  dep={int(dep)} iters={iters:5d}: {dt*1e3:8.3f} ms "
                  f"{dt/iters*1e9:8.1f} ns/iter{scale} "
                  f"(out[0,0]={float(out[0, 0]):.4e})", flush=True)
            results[(int(dep), iters)] = dict(ms=dt * 1e3, ns_per_iter=dt / iters * 1e9)
    return results


if __name__ == "__main__":
    main()
