"""Build the port's native sources on first use and bind them with ctypes.

Each ``stratum_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into ``build/stratum_tpu_torch/`` at the
repository root, keyed by a hash of the source and the flags, so an edited
kernel is rebuilt and an unchanged one is loaded as it is; the compiler's
report (ptxas registers and spills) is kept beside the library and read
into ``BUILD_LOG`` when it loads. A plain C
interface keeps the build to seconds (no PyTorch headers). :func:`build`
does the same for any source and compiler; ``utils/native.py`` builds the
host-side C++ helpers with it.

This module is also the one seam between the port and its native entry
points. Each is declared once, as data, beside the Python code that calls
it (:func:`entry`); :func:`launch` enqueues a kernel's entry point on its
tensors' device and counts what it enqueued in one registry
(:func:`launches`, :func:`reset_launches`); :func:`kernel_info` reads an
``*_info`` entry's out-array and ptxas's report (:func:`ptxas_report`);
:func:`check` holds a tensor to what a kernel takes.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "stratum_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_LOADED: dict = {}
BUILD_LOG: dict = {}  # source file name -> compiler report (ptxas registers, ...) of its library


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return nvcc


def _library_path(src: Path, flags, key: bytes = b"") -> Path:
    tag = hashlib.sha1(src.read_bytes() + " ".join(flags).encode() + key).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{tag}.so"


def library_path(name: str) -> Path:
    return _library_path(CSRC / f"{name}.cu", NVCC_FLAGS)


def build(source: str, compiler: Callable[[], str], flags, key: bytes = b"") -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>`` as a shared library:
    ``compiler()`` names the compiler (called only when a build is due),
    ``flags`` precede ``-o <library> <source>``, and ``key`` adds to the
    hash that names the library."""
    if source in _LOADED:
        return _LOADED[source]
    src = CSRC / source
    out = _library_path(src, flags, key)
    log = out.with_name(out.name + ".log")  # the compiler's report beside the library
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(BUILD_DIR))
        os.close(fd)
        cmd = [compiler(), *flags, "-o", tmp, str(src)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{Path(cmd[0]).name} failed for {source}:\n{proc.stdout}\n{proc.stderr}"
                )
            log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    if log.exists():
        BUILD_LOG[source] = log.read_text()
    _LOADED[source] = ctypes.CDLL(str(out))
    return _LOADED[source]


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return build(f"{name}.cu", _nvcc, NVCC_FLAGS)


# argument kinds of a signature: a pointer (device or host), an int, a
# float, a long long, and a pointer to an int the function writes
_KINDS = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
          "q": ctypes.c_longlong, "n": ctypes.POINTER(ctypes.c_int)}
ENTRIES: dict = {}  # entry-point name -> its Entry, every one declared
_LAUNCHES = collections.Counter()  # kernels enqueued, by entry point (and op)


class Entry:
    """One C entry point of the library built from ``csrc/<source>``. Its
    signature has a letter an argument (spaces are ignored): ``p`` a
    pointer, ``i`` an int, ``f`` a float, ``q`` a long long, ``n`` a
    pointer to an int the function writes; it returns a ``cudaError_t``
    (an int, 0 on success). The first call loads the library through
    ``loader`` and binds the function; a call with another number of
    arguments raises TypeError before it reaches C."""

    def __init__(self, source: str, name: str, signature: str, loader: Callable):
        self.source, self.name, self.loader = source, name, loader
        self.signature = signature.replace(" ", "")
        if not self.signature or set(self.signature) - set(_KINDS):
            raise ValueError(f"{name}: bad signature {signature!r}")
        self.counts = self.signature.endswith("np")  # a launcher's count of kernels
        self.fn = None

    def __call__(self, *args) -> int:
        if len(args) != len(self.signature):
            raise TypeError(f"{self.name} takes {len(self.signature)} arguments, "
                            f"not {len(args)}")
        fn = self.fn
        if fn is None:
            fn = getattr(self.loader(), self.name)
            fn.argtypes = [_KINDS[k] for k in self.signature]
            fn.restype = ctypes.c_int
            self.fn = fn
        return fn(*args)


def entry(source: str, name: str, signature: str, loader: Optional[Callable] = None) -> Entry:
    """Declare the entry point ``name`` of ``csrc/<source>`` (see
    :class:`Entry`); ``loader`` builds and loads the library, by default
    :func:`load` of a ``.cu`` source."""
    e = Entry(source, name, signature, loader or (lambda: load(Path(source).stem)))
    ENTRIES[name] = e
    return e


def launch(fn: Entry, device: torch.device, *args, op: Optional[str] = None) -> int:
    """Enqueue ``fn(*args, [count,] stream)`` with ``device`` current (the
    runtime launches on the current device), on that device's current
    stream; an entry whose signature ends in ``np`` takes before the stream
    an int it sets to the kernels it enqueued, every other one enqueues
    one. Raises RuntimeError naming the entry and the cudaError; else adds
    the kernels to the registry under the entry's name (``name/op`` with
    ``op``) and returns them."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if fn.counts:
            launched = ctypes.c_int(0)
            rc = fn(*args, ctypes.byref(launched), stream)
            kernels = launched.value
        else:
            rc = fn(*args, stream)
            kernels = 1
    if rc != 0:
        raise RuntimeError(f"{fn.name} launch failed: cudaError {rc}")
    _LAUNCHES[fn.name if op is None else f"{fn.name}/{op}"] += kernels
    return kernels


def launches() -> collections.Counter:
    """A copy of the registry: kernels enqueued by :func:`launch`, by
    entry-point name (``name/op`` where the caller gave an op)."""
    return _LAUNCHES.copy()


def reset_launches() -> None:
    _LAUNCHES.clear()


_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
FRAME_KEYS = ("stack_bytes", "spill_stores", "spill_loads")


def ptxas_report(source: str) -> dict:
    """ptxas's report of ``csrc/<source>``'s library (``BUILD_LOG``) as
    {kernel symbol: {"registers", "stack_bytes", "spill_stores",
    "spill_loads"}}, in the report's order; {} without a report."""
    out, kernel = {}, None
    for ln in BUILD_LOG.get(source, "").splitlines():
        if "Function properties for" in ln:
            kernel = ln.split("Function properties for", 1)[1].strip()
            out[kernel] = dict.fromkeys(("registers",) + FRAME_KEYS)
        elif kernel is not None and (m := _FRAME.search(ln)):
            out[kernel].update(zip(FRAME_KEYS, map(int, m.groups())))
        elif kernel is not None and (m := re.search(r"Used (\d+) registers", ln)):
            out[kernel]["registers"] = int(m[1])
    return out


def kernel_info(fn: Entry, names, *args, kernel: Optional[str] = None) -> dict:
    """Call the ``*_info`` entry ``fn`` with ``args`` and an int out-array
    of ``len(names)``, and name its fields by ``names`` (a None name skips
    its field); with ``kernel``, add ``stack_bytes``, ``spill_stores`` and
    ``spill_loads`` of the last kernel in ptxas's report whose symbol holds
    ``kernel`` (None without a report)."""
    out = (ctypes.c_int * len(names))()
    rc = fn(*args, out)
    if rc != 0:
        raise RuntimeError(f"{fn.name} failed: cudaError {rc}")
    info = {k: v for k, v in zip(names, out) if k is not None}
    if kernel is not None:
        frames = [f for sym, f in ptxas_report(fn.source).items() if kernel in sym]
        info.update({k: frames[-1][k] if frames else None for k in FRAME_KEYS})
    return info


def check(x: torch.Tensor, name: str, dtype, shape, device: torch.device,
          contiguous: bool = True) -> None:
    """Raise unless ``x`` lies on the CUDA device ``device`` with ``dtype``
    and ``shape``, and is contiguous unless ``contiguous`` is False (a
    kernel that takes the tensor's strides)."""
    if x.device != device or device.type != "cuda":
        raise ValueError(f"{name} is on {x.device}: the kernel takes CUDA tensors on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
