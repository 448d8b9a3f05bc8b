"""PLY mesh loader, ASCII and binary little/big endian (counterpart of
stratum_tpu/scene/loaders/ply.py, numpy only). Handles vertex x/y/z [+
nx/ny/nz + u/v (s/t)] properties and polygon faces, fan-triangulated.

The reference walks binary faces one at a time. Here, when every face list
of a binary file has the same length (a triangle or a quad mesh), one
structured ``np.frombuffer`` reads them all and the fan is built by
slicing, in the loop's order; mixed lengths take the loop.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _uniform_faces(body, pos, count, endian, count_type, index_type):
    """Binary face lists all of one length -> (triangles [F * (n - 2), 3]
    int32, bytes read); None when the lengths differ or fewer than 3."""
    if count == 0 or pos >= len(body):
        return None
    n = int(np.frombuffer(body, endian + count_type, count=1, offset=pos)[0])
    if n < 3:
        return None
    dt = np.dtype([("n", endian + count_type), ("i", endian + index_type, (n,))])
    if pos + dt.itemsize * count > len(body):
        return None
    rec = np.frombuffer(body, dt, count=count, offset=pos)
    if not bool((rec["n"] == n).all()):
        return None
    idx = rec["i"].astype(np.int64)
    fan = np.stack(
        [np.repeat(idx[:, :1], n - 2, axis=1), idx[:, 1:n - 1], idx[:, 2:n]], axis=-1
    )
    return fan.reshape(-1, 3).astype(np.int32), dt.itemsize * count


def load_ply_mesh(path):
    """Returns (positions [V,3], normals|None, uvs|None, indices [T,3])."""
    raw = Path(path).read_bytes()
    end_header = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end_header].decode("ascii", errors="replace").splitlines()
    body = raw[end_header:]

    fmt = "ascii"
    elements = []  # (name, count, [(prop_name, dtype, is_list, count_type)])
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append((parts[4], _PLY_TYPES[parts[3]], True, _PLY_TYPES[parts[2]]))
            else:
                elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]], False, None))

    endian = "<" if fmt == "binary_little_endian" else ">"
    verts: dict[str, np.ndarray] = {}
    faces: list = []
    tri_blocks: list = []  # triangles of the one-read face path
    if fmt == "ascii":
        tokens = body.decode("ascii", errors="replace").split()
        ti = 0
        for name, count, props in elements:
            if name == "vertex":
                cols = {p[0]: np.empty(count, np.float32) for p in props}
                for k in range(count):
                    for p in props:
                        cols[p[0]][k] = float(tokens[ti])
                        ti += 1
                verts = cols
            elif name == "face":
                for _ in range(count):
                    ln = int(tokens[ti])
                    ti += 1
                    idx = [int(tokens[ti + j]) for j in range(ln)]
                    ti += ln
                    for j in range(1, ln - 1):
                        faces.append((idx[0], idx[j], idx[j + 1]))
            else:
                for _ in range(count):
                    for p in props:
                        if p[2]:
                            ln = int(tokens[ti]); ti += 1 + ln
                        else:
                            ti += 1
    else:
        pos = 0
        for name, count, props in elements:
            if name == "vertex" and not any(p[2] for p in props):
                dt = np.dtype([(p[0], endian + p[1]) for p in props])
                arr = np.frombuffer(body, dt, count=count, offset=pos)
                pos += dt.itemsize * count
                verts = {p[0]: arr[p[0]].astype(np.float32) for p in props}
            elif name == "face":
                fast = _uniform_faces(body, pos, count, endian, props[0][3], props[0][1])
                if fast is not None:
                    tri_blocks.append(fast[0])
                    pos += fast[1]
                    continue
                for _ in range(count):
                    (ln,) = np.frombuffer(
                        body, endian + props[0][3], count=1, offset=pos
                    )
                    pos += np.dtype(props[0][3]).itemsize
                    idx = np.frombuffer(
                        body, endian + props[0][1], count=int(ln), offset=pos
                    ).astype(np.int64)
                    pos += np.dtype(props[0][1]).itemsize * int(ln)
                    for j in range(1, int(ln) - 1):
                        faces.append((idx[0], idx[j], idx[j + 1]))
            else:
                raise ValueError(f"unsupported ply element {name!r}")

    positions = np.stack(
        [verts["x"], verts["y"], verts["z"]], axis=-1
    ).astype(np.float32)
    normals = (
        np.stack([verts["nx"], verts["ny"], verts["nz"]], axis=-1).astype(np.float32)
        if "nx" in verts
        else None
    )
    uv_keys = ("u", "v") if "u" in verts else (("s", "t") if "s" in verts else None)
    uvs = (
        np.stack([verts[uv_keys[0]], verts[uv_keys[1]]], axis=-1).astype(np.float32)
        if uv_keys
        else None
    )
    indices = np.concatenate(tri_blocks) if tri_blocks else np.asarray(faces, np.int32)
    return positions, normals, uvs, indices
