"""The port's host-side C++ helpers (counterpart of stratum_tpu/utils/native.py).

Each ``stratum_tpu_torch/csrc/<name>.cpp`` exposes a plain C interface and
is compiled by ``g++`` on first use through ``utils/cuda_build.build`` (the
same build directory and source-hash naming as the kernels). The hash also
covers the host's CPU flags: ``-march=native`` code from another host could
stop on an illegal instruction. The flags are the JAX package's, so both
packages build the same SAH leaves.
"""

from __future__ import annotations

import ctypes
import shutil

import numpy as np

from stratum_tpu_torch.utils import cuda_build

GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's C++ helpers cannot be built")
    return gxx


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cpp``; raises if ``g++`` is
    missing or the build fails."""
    return cuda_build.build(f"{name}.cpp", _gxx, GXX_FLAGS, _cpu_flags())


_SAH_BUILD = cuda_build.entry("sah_builder.cpp", "sah_build", "pi pi i ppn",
                              lambda: load("sah_builder"))


def sah_order(positions: np.ndarray, indices: np.ndarray, leaf_size: int):
    """Binned-SAH triangle ordering and leaf offsets from
    ``csrc/sah_builder.cpp`` -> (order [T] int32, leaf_offsets [L+1] int32)."""
    pos = np.ascontiguousarray(positions, np.float32)
    idx = np.ascontiguousarray(indices, np.int32)
    t = idx.shape[0]
    order = np.empty(t, np.int32)
    offsets = np.empty(t + 1, np.int32)
    nl = ctypes.c_int(0)
    rc = _SAH_BUILD(pos.ctypes.data, pos.shape[0], idx.ctypes.data, t, leaf_size,
                    order.ctypes.data, offsets.ctypes.data, ctypes.byref(nl))
    if rc != 0:
        raise RuntimeError(f"sah_build failed with code {rc}")
    return order, offsets[: nl.value + 1]
