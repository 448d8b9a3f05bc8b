"""Hopper counterparts of the JAX package's four TPU microbenchmarks of the
traced leaf visit (the repository's ``tools/`` scripts of the same names):

* ``perf_commit_pipeline`` (T1): visits of one sub-commit, nine variants;
* ``perf_epilogue`` (T2): the c48 product under five epilogues;
* ``probe_mxu_loop`` (T3): a loop of c48 products, optionally carried;
* ``bench_mxu_model`` (T4): the cost model of the contraction.

Each module holds its kernel's wrapper (source ``csrc/microbench.cu``;
``cuda_build.launches()`` counts its launches by entry point), its plain
torch version and a ``main`` that keeps the
reference's ``--key=value`` options and output, timed with CUDA events::

    python3 -m stratum_tpu_torch.tools.perf_commit_pipeline [--k=1024] ...

They run on the card unless given ``--cpu``, which runs the plain versions
on the CPU (for tests and rehearsal; the times it prints are the CPU's).
"""

from __future__ import annotations

import collections
import ctypes
import re
import shutil
import subprocess
import time

import numpy as np
import torch

from stratum_tpu_torch.utils import cuda_build

# bf16 dense tensor-core peak and memory rate of one H100 SXM (NVIDIA data
# sheet); the tools' per-SM bounds divide the peak by its 132 SMs
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
SMS = 132
# Thread instructions an SM completes per clock, by pipe (CUDA C++
# Programming Guide, throughput of arithmetic instructions at compute
# capability 9.0): every instruction issues at one warp instruction per
# scheduler and clock (four schedulers), the FP32 pipe (FFMA, FMUL, FADD)
# runs at that rate, the integer, logic, compare, min / max and select pipe
# at half of it, the multifunction unit (MUFU: rcp, ex2, ...) at an eighth
PIPE_RATES = {"issue": 128, "fp32": 128, "alu": 64, "mufu": 16}
# Where two f32 sums of the same products are taken in other orders, each of
# their n additions may round the partial sum by up to one ulp (tensor cores
# may truncate instead of rounding to nearest), on both sides: the absolute
# difference stays below SUM_ULPS * n * (sum of the products' magnitudes).
SUM_ULPS = 2 * 2.0 ** -23


def visit_bound_sm(flops: float, tests: int, ops: dict, clock_hz: float) -> dict:
    """Least time (s) of one visit on one SM: the larger of its tensor-core
    product (``flops`` at 1/132 of the bf16 peak) and its epilogue on the
    CUDA cores: ``tests`` (lane, row) tests, each of ``ops`` instructions
    by pipe ({"fp32", "alu", "mufu", "other"}; absent keys are 0, others
    are not read), the longest of the pipes' times at PIPE_RATES per clock
    of ``clock_hz``, where "issue" counts every instruction. Both halves
    are returned, with each pipe's time, beside the bound and what sets it."""
    tensor = flops / PEAK_BF16_FLOPS * SMS
    n = {p: ops.get(p, 0) for p in ("fp32", "alu", "mufu", "other")}
    n["issue"] = sum(n.values())
    pipes = {p: tests * n[p] / (PIPE_RATES[p] * clock_hz) for p in PIPE_RATES}
    pipe = max(pipes, key=pipes.get)
    cuda = pipes[pipe]
    return dict(tensor_s=tensor, epilogue_s=cuda, pipes_s=pipes, epilogue_pipe=pipe,
                bound_s=max(tensor, cuda),
                bound_by=f"epilogue ({pipe})" if cuda > tensor else "product")


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock as nvidia-smi reports it (Hz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return float(out) * 1e6


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


_INFO = cuda_build.entry("microbench.cu", "mb_info", "ii p")
_KERNEL_NAME = cuda_build.entry("microbench.cu", "mb_kernel_name", "ii p")


def kernel_info(tool: int, variant: int) -> dict:
    """The compiled kernel of T``tool`` (1-4) and a variant (T1, T2: its
    index in the tool's VARIANTS; T3: 0; T4: as ``bench_mxu_model.geometry``
    gives it): registers per thread, static and dynamic shared memory
    (bytes; T4's at 5 passes or the most that fit), resident CTAs per SM,
    local (spill) bytes per thread, threads per CTA, the [rows, columns] of
    the output one CTA writes (``tile``), and its symbol."""
    info = cuda_build.kernel_info(_INFO, ("registers", "static_smem", "dynamic_smem",
                                          "ctas_per_sm", "local_bytes", "threads", "tile_rows",
                                          "tile_cols"), tool, variant)
    name = ctypes.c_char_p()
    rc = _KERNEL_NAME(tool, variant, ctypes.byref(name))
    if rc != 0:
        raise RuntimeError(f"mb_kernel_name failed: cudaError {rc}")
    return dict(info, tile=(info["tile_rows"], info["tile_cols"]), symbol=name.value.decode())


def library_sass() -> str:
    """``cuobjdump -sass`` of the built ``csrc/microbench.cu``."""
    cuda_build.load("microbench")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(cuda_build.library_path("microbench"))],
                          capture_output=True, text=True, timeout=300, check=True).stdout


# SASS opcodes (before the first ".") of the CUDA-core pipes of
# PIPE_RATES; every other instruction (tensor cores, the uniform datapath,
# memory, barriers, branches) takes an issue slot only
SASS_PIPES = {
    "fp32": ("FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I"),
    "mufu": ("MUFU",),
    "alu": ("FSETP", "FSEL", "FMNMX", "FCHK", "ISETP", "IADD3", "VIADD", "IMAD", "LEA", "LOP3",
            "PLOP3", "SEL", "SHF", "MOV", "PRMT", "P2R", "R2P", "VIMNMX", "VIADDMNMX", "IMNMX"),
}
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]\s+)?([A-Za-z0-9_.]+)([^;]*);")


def _sass_function(sass: str, symbol: str) -> list:
    """One function of a ``cuobjdump -sass`` listing as (address, predicated,
    opcode, branch target or None) per instruction."""
    body = sass.split("Function : " + symbol + "\n", 1)[1].split("Function : ", 1)[0]
    ins = []
    for m in _SASS_LINE.finditer(body):
        op = m.group(3)
        target = re.search(r"0x([0-9a-f]+)", m.group(4)) if op.startswith("BRA") else None
        ins.append((int(m.group(1), 16), bool(m.group(2)), op,
                    int(target.group(1), 16) if target else None))
    return ins


def _loop_path(ins: list, marker: str, symbol: str) -> list:
    """The opcodes of the innermost loop that holds an instruction starting
    with ``marker``, walked from its head to its back branch along the path
    an iteration takes (a conditional forward branch falls through, unless
    the block it falls into holds the division's range check or slow-path
    call, FCHK / CALL, which only operands out of the fast path's range
    take); every instruction once."""
    at = {a: i for i, (a, *_) in enumerate(ins)}
    marked = [a for a, _, op, _ in ins if op.startswith(marker)]
    head, back = min(((t, a) for a, _, op, t in ins
                      if t is not None and t <= a and any(t <= h <= a for h in marked)),
                     key=lambda loop: loop[1] - loop[0])
    i, path = at[head], []
    while True:
        a, cond, op, t = ins[i]
        path.append(op)
        assert len(path) <= len(ins), symbol
        if a == back:
            return path
        if t is not None and not cond:
            i = at[t]
            continue
        if t is not None and a < t <= back:
            j = i + 1
            while ins[j][3] is None and ins[j][0] < t and not ins[j][2].startswith(("FCHK", "CALL")):
                j += 1
            if ins[j][2].startswith(("FCHK", "CALL")):
                i = at[t]
                continue
        i += 1


def _by_pipe(path: list, per: float) -> dict:
    """{"fp32", "alu", "mufu", "other"}: the opcodes of ``path`` by pipe
    (SASS_PIPES; "other" every remaining instruction), each divided by
    ``per``."""
    count = collections.Counter(op.split(".")[0] for op in path)
    ops = {pipe: sum(count[o] for o in names) / per for pipe, names in SASS_PIPES.items()}
    ops["other"] = len(path) / per - sum(ops.values())
    return ops


def sass_visit_ops(sass: str, symbol: str, parts: int) -> dict:
    """Instructions per (lane, row) test, by pipe, of one tile visit of a
    T1 / T2 / T3 kernel, counted from its SASS (``cuobjdump -sass``): the
    innermost loop that issues wgmmas (HGMMA), walked along the path a tile
    takes (``_loop_path``). The tests on that path follow from its HGMMAs:
    an m64nNk16 covers 64 x N x 16 products, a test needs 4 bands x 48 x
    ``parts`` (T2's three bf16 parts) of them, over a warpgroup's 128
    threads -> {"fp32", "alu", "mufu", "other"} per test, and "tests" per
    thread on the path."""
    path = _loop_path(_sass_function(sass, symbol), "HGMMA", symbol)
    tests = sum(64 * int(re.match(r"HGMMA\.64x(\d+)x16", op).group(1)) * 16
                for op in path if op.startswith("HGMMA")) / (4 * 48 * parts * 128)
    return dict(_by_pipe(path, tests), tests=tests)


def sass_pass_ops(sass: str, symbol: str, stagers: int) -> dict:
    """Thread instructions of one pass of one T4 CTA (one warpgroup), by
    pipe, counted from its SASS: the iteration loop's two inner loops over
    the passes, the staging of the B operands (the innermost loop that
    stores to shared memory, STS; run by the ``stagers`` threads that write
    a pass's tile) and the issue of their wgmmas (the innermost loop that
    holds HGMMA; run by all 128 threads), each walked once -> {"fp32",
    "alu", "mufu", "other"}, and "hgmma", the wgmmas of a pass."""
    ins = _sass_function(sass, symbol)
    stage, issue = _loop_path(ins, "STS", symbol), _loop_path(ins, "HGMMA", symbol)
    a, b = _by_pipe(stage, 1), _by_pipe(issue, 1)
    return dict({p: stagers * a[p] + 128 * b[p] for p in a},
                hgmma=sum(op.startswith("HGMMA") for op in issue))

