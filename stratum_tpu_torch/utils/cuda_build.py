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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable

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
