"""T4: the cost model of the traversal contraction. The counterpart of
tools/bench_mxu_model.py (TPU kernel ``_mm_kernel`` :35, pallas_call :80).

``iters`` iterations of ``acc += a^T @ b`` with a: f32 [C, M] and b: f32
[C, B], both rounded to bf16 for the product (f32 accumulation). Iteration
i scales b by ``fi`` (``fi *= 1.0000001`` in f32 after every iteration), so
no product can be hoisted; ``passes`` products per iteration multiply
``b * fi + p`` for p = 0 .. passes - 1 and are summed in that order;
``passes = 0`` is the control that adds the broadcast row ``b[0] * fi``
instead. ``reps`` splits M into equal slices that the TPU multiplied as
separate calls (see below for the card). The output is the whole ``[M, B]`` f32 accumulator.

Two defects of the reference are not copied: its scratch accumulator is
never zeroed (in interpret mode it returns NaN; the port starts from 0), and
it builds its operands as constants inside the jitted call, which lets XLA
fold the program (the port takes runtime tensors).

On the card the loop is ``csrc/microbench.cu``'s model kernel: one CTA (one
warpgroup) per output tile of 64 rows and 16, 32 or 64 columns (the widest
whose grid still fills the card; :func:`geometry` reads the library's
choice), its accumulator in the wgmma registers across all iterations and
passes, a^T in registers as bf16 (C padded with zeros to a multiple of 16),
and each pass's operand bf16(b fi + p) staged by the CTA's own threads into
shared memory while the last iteration's wgmmas run. ``reps`` changes
nothing there: a slice of M / reps rows is whole tiles, each already a
product of its own, so the per-leaf case (``reps=8``) launches exactly what
its batched twin launches and cannot price separate calls. The grid is 128
CTAs at M = 1024 and B = 128 or 512, 256 at M = 8192, B = 128 and 1,024 at
M = 8192, B = 512. ``python3 -m stratum_tpu_torch.tools.bench_mxu_model
[--cpu]`` prints the marginal ns per pass of the reference's 11 cases and,
on the card, each case's CTAs.
"""

from __future__ import annotations

import ctypes
import functools
import sys

import numpy as np
import torch

from stratum_tpu_torch import tools
from stratum_tpu_torch.ops import mt_commit as mt
from stratum_tpu_torch.utils import cuda_build
from stratum_tpu_torch.utils.flags import Options

ITERS = 512
MAX_C = 128
FI_STEP = np.float32(1.0000001)
CASES = [
    # (label, C, M, B, passes, reps)
    ("current sub-visit: [16,1024]x[16,128] x3", 16, 1024, 128, 3, 1),
    ("current, 1-pass bf16", 16, 1024, 128, 1, 1),
    ("8 leaves, 8 calls x3 (per-leaf)", 16, 8192, 128, 3, 8),
    ("8 leaves, 1 call  x3 (batched-M)", 16, 8192, 128, 3, 1),
    ("8 leaves, 1 call  x1", 16, 8192, 128, 1, 1),
    ("deep C=128: [128,1024]x[128,128] x3", 128, 1024, 128, 3, 1),
    ("deep C=128, 1-pass", 128, 1024, 128, 1, 1),
    ("wide B: [16,1024]x[16,512] x3", 16, 1024, 512, 3, 1),
    ("wide B batched: [16,8192]x[16,512] x3", 16, 8192, 512, 3, 1),
    ("C=8:  [8,1024]x[8,128] x3", 8, 1024, 128, 3, 1),
    ("C=32: [32,1024]x[32,128] x3", 32, 1024, 128, 3, 1),
]

_KERNEL = cuda_build.entry("microbench.cu", "mb_mxu_model", "ppp iiiiii p")
_TILE = cuda_build.entry("microbench.cu", "mb_mxu_model_tile", "iiii p")


@functools.lru_cache(maxsize=None)
def geometry(c: int, m: int, b: int, passes: int) -> tuple:
    """((rows, columns) of one CTA's output tile, the kernel's variant for
    ``tools.kernel_info(4, ...)``) that the built library takes for an
    [m, b] output at C = c and ``passes``."""
    out = (ctypes.c_int * 3)()
    if _TILE(c, m, b, passes, out) != 0:
        raise ValueError(f"C={c}, passes={passes}: the kernel takes 1 <= C <= {MAX_C} and "
                         "passes >= 0")
    return (out[0], out[1]), out[2]


def ctas(m: int, b: int) -> int:
    """CTAs of the kernel's grid for an [m, b] output."""
    (tm, tn), _ = geometry(1, m, b, 1)
    return m // tm * (b // tn)


def run(a, b, iters: int, passes: int, reps: int) -> torch.Tensor:
    """``[M, B]`` f32 accumulator after ``iters`` iterations. a: f32 [C, M];
    b: f32 [C, B]. CUDA tensors launch the kernel, CPU tensors run
    :func:`run_plain`."""
    if a.device.type == "cpu":
        return run_plain(a, b, iters, passes, reps)
    c, m = a.shape
    nb = b.shape[1]
    (tm, tn), _ = geometry(c, m, nb, passes)
    if not (m % (tm * reps) == 0 and nb % tn == 0):
        raise ValueError(f"M={m}, B={nb}, reps={reps}: the kernel takes M a multiple of "
                         f"{tm} * reps and B a multiple of {tn}")
    cuda_build.check(a, "a", torch.float32, (c, m), a.device)
    cuda_build.check(b, "b", torch.float32, (c, nb), a.device)
    out = torch.empty((m, nb), dtype=torch.float32, device=a.device)
    cuda_build.launch(_KERNEL, a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), c, m, nb,
                      iters, passes, reps)
    return out


def run_plain(a, b, iters: int, passes: int, reps: int) -> torch.Tensor:
    """Plain torch twin of :func:`run`, step for step as the TPU kernel
    (bench_mxu_model.py:35-73), with the accumulator zeroed."""
    c, m = a.shape
    ms = m // reps
    acc = torch.zeros((m, b.shape[1]), device=a.device)
    a16 = a.to(torch.bfloat16)
    fi = torch.ones((), device=a.device)
    for _ in range(iters):
        bb = b * fi
        for r in range(reps):
            sl = a16[:, r * ms:(r + 1) * ms]
            if passes == 0:
                out = bb[0:1].expand(ms, -1)
            else:
                out = mt.mt_product(sl, bb.to(torch.bfloat16))
                for p in range(passes - 1):
                    out = out + mt.mt_product(sl, (bb + float(p + 1)).to(torch.bfloat16))
            acc[r * ms:(r + 1) * ms] = acc[r * ms:(r + 1) * ms] + out
        fi = fi * float(FI_STEP)
    return acc


def tolerance(a, b, iters: int, passes: int) -> torch.Tensor:
    """Bound on |out| between two runs that sum the products in other
    orders ([M, B]): each output sums iters x passes x C products (the pass
    operands are below (|b| fi + p)(1 + 2^-8) after their bf16 rounding;
    fi stays below FI_STEP^iters)."""
    fi = float(FI_STEP) ** iters
    ab = b.double().abs() * fi
    if passes == 0:
        return tools.SUM_ULPS * iters * ab[0:1].expand(a.shape[1], -1) * iters
    ops = sum(ab + p for p in range(passes)) * (1 + 2.0 ** -8)
    n = a.shape[0] + passes + iters
    return tools.SUM_ULPS * n * iters * (a.double().abs().T @ ops)


def main(argv=None) -> dict:
    opts = Options(sys.argv[1:] if argv is None else argv)
    device = tools.device_of(opts)
    print(f"devices: {tools.describe(device)}")

    def timeit(c, m, b, passes, reps):
        # runtime operands with the reference's values
        a_t = torch.full((c, m), 0.5, device=device)
        b_t = torch.full((c, b), 0.25, device=device)
        return tools.time_call(lambda: run(a_t, b_t, ITERS, passes, reps), 8, device)[1] / ITERS

    # slope method: the same shape at passes=1 and passes=5; (t5-t1)/4 is
    # the marginal cost of one more product pass, loop and consume costs
    # cancelled
    results = {}
    for label, c, m, b, _passes, reps in CASES:
        t1 = timeit(c, m, b, 1, reps)
        t5 = timeit(c, m, b, 5, reps)
        per_pass = max((t5 - t1) / 4.0, 1e-12)
        mflop = 2.0 * c * m * b / 1e6
        eff = 2.0 * 16 * m * b / 1e6  # useful MT work at 16-feature rows
        grid = ctas(m, b) if device.type == "cuda" else None
        # MFLOP per second / 1e6 is TFLOP/s (the reference labels it GFLOP/s)
        print(
            f"{label:45s} {per_pass * 1e9:9.1f} ns/pass "
            f"(t1={t1 * 1e9:7.1f} t5={t5 * 1e9:7.1f})  "
            f"{mflop / per_pass / 1e6:9.1f} TFLOP/s issued "
            f"({eff / per_pass / 1e6:8.1f} useful/pass)"
            + ("" if grid is None else f"  {grid} CTAs")
        )
        results[label] = dict(c=c, m=m, b=b, reps=reps, ctas=grid,
                              ns_per_pass=per_pass * 1e9,
                              t1_ns=t1 * 1e9, t5_ns=t5 * 1e9,
                              tflops=mflop / per_pass / 1e6)
    return results


if __name__ == "__main__":
    main()
