"""Mitsuba ``.serialized`` mesh loader and writer (counterpart of
stratum_tpu/scene/loaders/serialized.py, numpy + zlib only;
src/Node/loaders/load_serialized.cpp): a sequence of zlib-deflated mesh
blobs with a trailing offset table (load_serialized.cpp:85+); each blob
holds flags (normals/uvs/colors/float16), counts, and raw vertex/index data
(11-60).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_FLAG_NORMALS = 0x0001
_FLAG_UVS = 0x0002
_FLAG_COLORS = 0x0008
_FLAG_FLOAT16 = 0x2000  # "single precision" flag is 0x1000; 0x2000 = half


def load_serialized_mesh(path, shape_index: int = 0):
    """Load one mesh from a .serialized file. Returns (positions [V,3],
    normals [V,3] | None, uvs [V,2] | None, indices [T,3])."""
    data = Path(path).read_bytes()
    fmt, version = struct.unpack_from("<HH", data, 0)
    if fmt != 0x041C:
        raise ValueError(f"{path}: not a mitsuba serialized file (magic {fmt:#x})")
    # trailing dictionary: last 4 bytes = mesh count, before it the offsets
    (count,) = struct.unpack_from("<I", data, len(data) - 4)
    if version >= 4:
        off_table = struct.unpack_from(
            f"<{count}Q", data, len(data) - 4 - 8 * count
        )
    else:
        off_table = struct.unpack_from(
            f"<{count}I", data, len(data) - 4 - 4 * count
        )
    start = off_table[shape_index]
    end = (
        off_table[shape_index + 1]
        if shape_index + 1 < count
        else len(data) - 4 - (8 if version >= 4 else 4) * count
    )
    blob = zlib.decompress(data[start + 4 : end])

    pos = 0
    (flags,) = struct.unpack_from("<I", blob, pos)
    pos += 4
    if version >= 4:
        # null-terminated shape name
        zero = blob.index(b"\0", pos)
        pos = zero + 1
    num_vertices, num_triangles = struct.unpack_from("<QQ", blob, pos)
    pos += 16
    dtype = np.float16 if flags & _FLAG_FLOAT16 else np.float64
    if version >= 3 and not (flags & _FLAG_FLOAT16):
        dtype = np.float32 if flags & 0x1000 else np.float64

    def read(n):
        nonlocal pos
        arr = np.frombuffer(blob, dtype, count=n, offset=pos)
        pos += arr.nbytes
        return arr.astype(np.float32)

    positions = read(3 * num_vertices).reshape(-1, 3)
    normals = (
        read(3 * num_vertices).reshape(-1, 3) if flags & _FLAG_NORMALS else None
    )
    uvs = read(2 * num_vertices).reshape(-1, 2) if flags & _FLAG_UVS else None
    if flags & _FLAG_COLORS:
        read(3 * num_vertices)
    itype = np.uint32 if num_vertices <= 0xFFFFFFFF else np.uint64
    indices = np.frombuffer(
        blob, itype, count=3 * num_triangles, offset=pos
    ).reshape(-1, 3).astype(np.int32)
    return positions, normals, uvs, indices


def write_serialized(path, positions, indices, normals=None, uvs=None):
    """Writer (for tests): one mesh, version-3 single-precision layout."""
    flags = 0x1000
    body = b""
    if normals is not None:
        flags |= _FLAG_NORMALS
    if uvs is not None:
        flags |= _FLAG_UVS
    body += struct.pack("<I", flags)
    body += struct.pack("<QQ", len(positions), len(indices))
    body += np.asarray(positions, np.float32).tobytes()
    if normals is not None:
        body += np.asarray(normals, np.float32).tobytes()
    if uvs is not None:
        body += np.asarray(uvs, np.float32).tobytes()
    body += np.asarray(indices, np.uint32).tobytes()
    blob = struct.pack("<HH", 0x041C, 3) + zlib.compress(body)
    out = blob + struct.pack("<I", 0) + struct.pack("<I", 1)
    Path(path).write_bytes(out)
