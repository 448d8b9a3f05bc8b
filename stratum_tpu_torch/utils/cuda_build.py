"""Build the port's CUDA kernels on first use and bind them with ctypes.

Each ``stratum_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into ``build/stratum_tpu_torch/`` at the
repository root, keyed by a hash of the source and the flags, so an edited
kernel is rebuilt and an unchanged one is loaded as it is. A plain C
interface keeps the build to seconds (no PyTorch headers).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "stratum_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_LOADED: dict = {}
BUILD_LOG: dict = {}  # name -> ptxas report (registers, shared memory)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    tag = hashlib.sha1(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    if name in _LOADED:
        return _LOADED[name]
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(BUILD_DIR))
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}"
                )
            BUILD_LOG[name] = proc.stderr
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    _LOADED[name] = ctypes.CDLL(str(out))
    return _LOADED[name]
