"""Hopper counterparts of the JAX package's four TPU microbenchmarks of the
traced leaf visit (the repository's ``tools/`` scripts of the same names):

* ``perf_commit_pipeline`` (T1): visits of one sub-commit, nine variants;
* ``perf_epilogue`` (T2): the c48 product under five epilogues;
* ``probe_mxu_loop`` (T3): a loop of c48 products, optionally carried;
* ``bench_mxu_model`` (T4): the cost model of the contraction.

Each module holds its kernel's wrapper (source ``csrc/microbench.cu``, a
``LAUNCHES`` count), its plain torch version and a ``main`` that keeps the
reference's ``--key=value`` options and output, timed with CUDA events::

    python3 -m stratum_tpu_torch.tools.perf_commit_pipeline [--k=1024] ...

They run on the card unless given ``--cpu``, which runs the plain versions
on the CPU (for tests and rehearsal; the times it prints are the CPU's).
"""

from __future__ import annotations

import ctypes
import subprocess
import time

import numpy as np
import torch

# bf16 dense tensor-core peak and memory rate of one H100 SXM (NVIDIA data
# sheet); the tools' per-SM bounds divide the peak by its 132 SMs
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
SMS = 132
# Where two f32 sums of the same products are taken in other orders, each of
# their n additions may round the partial sum by up to one ulp (tensor cores
# may truncate instead of rounding to nearest), on both sides: the absolute
# difference stays below SUM_ULPS * n * (sum of the products' magnitudes).
SUM_ULPS = 2 * 2.0 ** -23


def from_numpy(x: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A numpy array on ``device``, converted to ``dtype`` there (f32 to
    bf16 rounds to nearest even, as ``astype(jnp.bfloat16)`` does)."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return t if dtype is None else t.to(dtype)


def device_of(opts) -> torch.device:
    """The tools' device: the card, or the CPU with ``--cpu`` (or
    ``--interpret``, the reference's CPU mode). Without a card the default
    raises instead of falling back."""
    if opts.get_bool("cpu", False) or opts.get_bool("interpret", False):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on the card, or pass --cpu")
    return torch.device("cuda", 0)


def describe(device: torch.device) -> str:
    """The device line the tools print: the card's name and power limit as
    nvidia-smi gives them, or the CPU."""
    if device.type != "cuda":
        return "cpu (plain torch versions)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(device)} ({smi})"


def time_call(fn, reps: int, device: torch.device):
    """(last result, mean seconds per call) of ``fn`` over ``reps`` calls
    after one warm-up call: CUDA events on the card, the host clock on the
    CPU."""
    out = fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return out, start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return out, (time.perf_counter() - t0) / reps


def check(x: torch.Tensor, name: str, dtype, shape) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of this type and shape."""
    from stratum_tpu_torch.ops.block_trace import _check

    if x.device.type != "cuda":
        raise ValueError(f"{name} is on {x.device}: the kernel takes CUDA tensors")
    _check(x, name, dtype, shape, x.device)


_SIGNATURES = {  # C entry point -> (pointer args, int args)
    "mb_commit_pipeline": (6, 4),
    "mb_epilogue": (3, 4),
    "mb_mxu_loop": (3, 3),
    "mb_mxu_model": (3, 6),
}


def lib() -> ctypes.CDLL:
    """``csrc/microbench.cu``, built on first use, with its entry points
    bound (pointers, then ints, then the stream; each returns a cudaError)."""
    from stratum_tpu_torch.utils import cuda_build

    so = cuda_build.load("microbench")
    if not getattr(so, "_stratum_bound", False):
        for fn, (ptrs, ints) in _SIGNATURES.items():
            f = getattr(so, fn)
            f.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p]
            f.restype = ctypes.c_int
        so._stratum_bound = True
    return so


def launch(fn: str, ptrs, ints, device: torch.device) -> None:
    """Call one entry point on the current stream; raise if it refused."""
    rc = getattr(lib(), fn)(*ptrs, *ints, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {rc}")
