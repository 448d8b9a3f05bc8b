"""STL mesh loader, binary and ASCII (counterpart of
stratum_tpu/scene/loaders/stl.py, numpy only; the reference's assimp STL
path, src/Node/loaders/load_assimp.cpp). Vertices are deduplicated and
carry the average of their facets' normals.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def load_stl_mesh(path):
    """Returns (positions [V,3], normals [V,3] (facet), uvs None,
    indices [T,3]). Vertices are deduplicated so smooth normals can be
    recomputed downstream if desired."""
    raw = Path(path).read_bytes()
    if raw[:5].lower() == b"solid" and b"facet" in raw[:1024]:
        tris, normals = _parse_ascii(raw)
    else:
        tris, normals = _parse_binary(raw)
    flat = tris.reshape(-1, 3)
    verts, inverse = np.unique(
        flat.round(decimals=6), axis=0, return_inverse=True
    )
    indices = inverse.reshape(-1, 3).astype(np.int32)
    # per-vertex normal = averaged facet normals (area handled downstream)
    vn = np.zeros_like(verts)
    fn = np.repeat(normals, 3, axis=0)
    np.add.at(vn, inverse, fn)
    ln = np.linalg.norm(vn, axis=-1, keepdims=True)
    vn = np.where(ln > 1e-12, vn / np.maximum(ln, 1e-20), [0.0, 0.0, 1.0])
    return (
        verts.astype(np.float32),
        vn.astype(np.float32),
        None,
        indices,
    )


def _parse_binary(raw: bytes):
    (n,) = struct.unpack_from("<I", raw, 80)
    rec = np.frombuffer(raw, np.uint8, count=n * 50, offset=84)
    rec = rec.reshape(n, 50)
    f = rec[:, :48].copy().view("<f4").reshape(n, 12)
    normals = f[:, 0:3]
    tris = f[:, 3:12].reshape(n, 3, 3)
    return tris.astype(np.float32), normals.astype(np.float32)


def _parse_ascii(raw: bytes):
    tris = []
    normals = []
    cur = []
    for line in raw.decode("ascii", errors="replace").splitlines():
        t = line.split()
        if not t:
            continue
        if t[0] == "facet" and t[1] == "normal":
            normals.append([float(x) for x in t[2:5]])
        elif t[0] == "vertex":
            cur.append([float(x) for x in t[1:4]])
        elif t[0] == "endfacet":
            if len(cur) >= 3:
                tris.append(cur[:3])
            cur = []
    return (
        np.asarray(tris, np.float32),
        np.asarray(normals, np.float32),
    )


def load_stl(parent, path, material=None):
    """Attach the mesh as a child node (the Scene::load dispatch pattern,
    Node/Scene.hpp:116-137)."""
    from stratum_tpu_torch.scene.graph import MeshPrimitive

    pos, nrm, uvs, idx = load_stl_mesh(path)
    node = parent.add_child(Path(path).stem)
    node.make_component(
        MeshPrimitive(
            positions=pos, indices=idx, normals=nrm, uvs=uvs,
            material=material,
        )
    )
    return node
