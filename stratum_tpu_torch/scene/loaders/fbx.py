"""Binary FBX loader and writer: meshes, transforms, materials
(counterpart of stratum_tpu/scene/loaders/fbx.py, numpy + zlib only; the
reference's assimp FBX path, src/Node/loaders/load_assimp.cpp:14-41).
Covered subset, the parts a renderer consumes:

- node-record tree (both the 32-bit pre-7500 and 64-bit 7500+ layouts),
  property scalars/strings and zlib-compressed arrays;
- Objects/Geometry: Vertices + PolygonVertexIndex (fan-triangulated),
  LayerElementNormal / LayerElementUV (ByPolygonVertex | ByVertice,
  Direct | IndexToDirect), LayerElementMaterial (AllSame | ByPolygon);
- Objects/Model: Lcl Translation/Rotation(euler XYZ deg)/Scaling +
  PreRotation from Properties70;
- Objects/Material: Diffuse/Specular/Emissive colors + Shininess ->
  Disney via the diffuse-specular conversion (scene/material.py);
- Connections: OO links Geometry->Model, Material->Model, Model->Model.

ASCII FBX and animation/skin/camera payloads are out of scope.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from stratum_tpu_torch.scene.graph import MeshPrimitive, Node, TransformComponent
from stratum_tpu_torch.scene.material import Material, make_diffuse_specular_material

_MAGIC = b"Kaydara FBX Binary  \x00"

_ARRAY_TYPES = {
    b"f": ("<f4", 4), b"d": ("<f8", 8), b"l": ("<i8", 8),
    b"i": ("<i4", 4), b"b": ("<u1", 1),
}
_SCALAR_TYPES = {
    b"Y": ("<h", 2), b"C": ("<b", 1), b"I": ("<i", 4),
    b"F": ("<f", 4), b"D": ("<d", 8), b"L": ("<q", 8),
}


class FbxNode:
    __slots__ = ("name", "props", "children")

    def __init__(self, name, props, children):
        self.name = name
        self.props = props
        self.children = children

    def find(self, name):
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find_all(self, name):
        return [c for c in self.children if c.name == name]


def _parse_props(raw, off, count):
    props = []
    for _ in range(count):
        t = raw[off : off + 1]
        off += 1
        if t in _SCALAR_TYPES:
            fmt, size = _SCALAR_TYPES[t]
            props.append(struct.unpack_from(fmt, raw, off)[0])
            off += size
        elif t in _ARRAY_TYPES:
            dtype, itemsize = _ARRAY_TYPES[t]
            n, enc, comp = struct.unpack_from("<III", raw, off)
            off += 12
            if enc == 1:
                buf = zlib.decompress(raw[off : off + comp])
                off += comp
            else:
                buf = raw[off : off + n * itemsize]
                off += n * itemsize
            props.append(np.frombuffer(buf, dtype, count=n))
        elif t in (b"S", b"R"):
            (n,) = struct.unpack_from("<I", raw, off)
            off += 4
            data = raw[off : off + n]
            off += n
            props.append(data.decode("utf-8", "replace") if t == b"S" else data)
        else:
            raise ValueError(f"unknown FBX property type {t!r}")
    return props, off


def _parse_node(raw, off, big):
    """One node record; returns (FbxNode | None, new offset). None = the
    NULL terminator record."""
    if big:  # FBX >= 7500: 64-bit offsets
        end, num_props, _plen = struct.unpack_from("<QQQ", raw, off)
        off += 24
    else:
        end, num_props, _plen = struct.unpack_from("<III", raw, off)
        off += 12
    name_len = raw[off]
    off += 1
    if end == 0:
        return None, off
    name = raw[off : off + name_len].decode("ascii", "replace")
    off += name_len
    props, off = _parse_props(raw, off, num_props)
    children = []
    while off < end:
        child, off = _parse_node(raw, off, big)
        if child is None:
            break
        children.append(child)
    return FbxNode(name, props, children), end


def parse_fbx(path):
    """-> (root FbxNode, version)."""
    raw = Path(path).read_bytes()
    if raw[: len(_MAGIC)] != _MAGIC:
        raise ValueError(f"{path}: not a binary FBX file (ASCII unsupported)")
    (version,) = struct.unpack_from("<I", raw, 23)
    big = version >= 7500
    off = 27
    top = []
    while off < len(raw):
        node, off = _parse_node(raw, off, big)
        if node is None:
            break
        top.append(node)
    return FbxNode("", [], top), version


def _prop70(node, name, default=None):
    """Properties70 lookup: P records are [name, type, label, flags, v...]."""
    p70 = node.find("Properties70")
    if p70 is None:
        return default
    for p in p70.find_all("P"):
        if p.props and p.props[0] == name:
            vals = p.props[4:]
            return vals if len(vals) > 1 else (vals[0] if vals else default)
    return default


def _euler_to_matrix(rx, ry, rz):
    """FBX default rotation order XYZ (applied X then Y then Z): R=Rz Ry Rx."""
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float64)
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float64)
    return mz @ my @ mx


def _model_transform(model: FbxNode) -> np.ndarray:
    t = np.asarray(
        _prop70(model, "Lcl Translation", (0.0, 0.0, 0.0)), np.float64
    )
    r = np.radians(
        np.asarray(_prop70(model, "Lcl Rotation", (0.0, 0.0, 0.0)), np.float64)
    )
    pre = np.radians(
        np.asarray(_prop70(model, "PreRotation", (0.0, 0.0, 0.0)), np.float64)
    )
    s = np.asarray(_prop70(model, "Lcl Scaling", (1.0, 1.0, 1.0)), np.float64)
    m = _euler_to_matrix(*pre) @ _euler_to_matrix(*r) @ np.diag(s)
    return np.concatenate([m, t[:, None]], axis=1).astype(np.float32)  # [3,4]


def _layer_values(geo: FbxNode, layer_name, value_name, index_name, n_pv, nv):
    """Resolve a LayerElement to per-polygon-vertex rows [n_pv, C] or
    per-vertex rows [nv, C] (returned with a flag)."""
    layer = geo.find(layer_name)
    if layer is None:
        return None, False
    mapping = ""
    ref = "Direct"
    vals = idx = None
    for c in layer.children:
        if c.name == "MappingInformationType":
            mapping = c.props[0]
        elif c.name == "ReferenceInformationType":
            ref = c.props[0]
        elif c.name == value_name:
            vals = np.asarray(c.props[0], np.float64)
        elif c.name == index_name:
            idx = np.asarray(c.props[0], np.int64)
    if vals is None:
        return None, False
    comp = 3 if value_name == "Normals" else 2
    vals = vals.reshape(-1, comp)
    if ref == "IndexToDirect" and idx is not None:
        vals = vals[np.clip(idx, 0, len(vals) - 1)]
    if mapping == "ByPolygonVertex":
        return vals[:n_pv].astype(np.float32), True
    if mapping in ("ByVertice", "ByVertex"):
        return vals[:nv].astype(np.float32), False
    if mapping == "AllSame":
        return np.broadcast_to(vals[:1], (n_pv, comp)).astype(np.float32), True
    return None, False


def _triangulate(geo: FbxNode):
    """Geometry node -> (positions [V,3], tri indices [T,3], per-corner
    normals/uvs or None, per-triangle material slot [T])."""
    verts = np.asarray(geo.find("Vertices").props[0], np.float64).reshape(-1, 3)
    pvi = np.asarray(geo.find("PolygonVertexIndex").props[0], np.int64)
    n_pv = len(pvi)
    # polygons end at negative indices (value = ~index)
    poly_end = np.flatnonzero(pvi < 0)
    corners = np.where(pvi < 0, ~pvi, pvi)
    tris = []
    tri_poly = []
    tri_corners = []
    start = 0
    for p, end in enumerate(poly_end):
        m = end - start + 1  # corners in this polygon
        for k in range(1, m - 1):  # fan
            tris.append(
                (corners[start], corners[start + k], corners[start + k + 1])
            )
            tri_corners.append((start, start + k, start + k + 1))
            tri_poly.append(p)
        start = end + 1
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    tri_corners = np.asarray(tri_corners, np.int64).reshape(-1, 3)
    tri_poly = np.asarray(tri_poly, np.int64)

    normals, n_percorner = _layer_values(
        geo, "LayerElementNormal", "Normals", "NormalsIndex", n_pv, len(verts)
    )
    uvs, u_percorner = _layer_values(
        geo, "LayerElementUV", "UV", "UVIndex", n_pv, len(verts)
    )

    # material slots
    mat_slot = np.zeros(len(tris), np.int64)
    lm = geo.find("LayerElementMaterial")
    if lm is not None:
        mapping = ""
        mats = None
        for c in lm.children:
            if c.name == "MappingInformationType":
                mapping = c.props[0]
            elif c.name == "Materials":
                mats = np.asarray(c.props[0], np.int64)
        if mats is not None and mapping == "ByPolygon":
            mat_slot = mats[np.clip(tri_poly, 0, len(mats) - 1)]
        # AllSame / missing -> slot 0

    # per-corner attributes force vertex splitting: emit one vertex per
    # triangle corner keyed by (position index, corner) when needed
    if (normals is not None and n_percorner) or (uvs is not None and u_percorner):
        pos_out = verts[tris.reshape(-1)].astype(np.float32)
        idx_out = np.arange(len(pos_out), np.int64).reshape(-1, 3)
        cr = tri_corners.reshape(-1)
        nrm_out = None
        if normals is not None:
            nrm_out = (normals[cr] if n_percorner else
                       normals[tris.reshape(-1)]).astype(np.float32)
        uv_out = None
        if uvs is not None:
            uv_out = (uvs[cr] if u_percorner else
                      uvs[tris.reshape(-1)]).astype(np.float32)
            uv_out = np.stack([uv_out[:, 0], 1.0 - uv_out[:, 1]], axis=-1)
        return (
            pos_out, idx_out.astype(np.int32), nrm_out, uv_out, mat_slot
        )
    nrm_out = normals.astype(np.float32) if normals is not None else None
    uv_out = None
    if uvs is not None:
        uv_out = np.stack([uvs[:, 0], 1.0 - uvs[:, 1]], axis=-1).astype(
            np.float32
        )
    return (
        verts.astype(np.float32), tris.astype(np.int32), nrm_out, uv_out,
        mat_slot,
    )


def _material_from(mat_node: FbxNode) -> Material:
    dif = np.asarray(
        _prop70(mat_node, "DiffuseColor", (0.8, 0.8, 0.8)), np.float32
    )
    spec = np.asarray(
        _prop70(mat_node, "SpecularColor", (0.0, 0.0, 0.0)), np.float32
    )
    shin = float(_prop70(mat_node, "Shininess", 0.0) or 0.0)
    emis = np.asarray(
        _prop70(mat_node, "EmissiveColor", (0.0, 0.0, 0.0)), np.float32
    )
    emis_f = float(_prop70(mat_node, "EmissiveFactor", 1.0) or 1.0)
    name = mat_node.props[1] if len(mat_node.props) > 1 else ""
    if isinstance(name, str):
        name = name.split("\x00")[0]
    m = make_diffuse_specular_material(
        dif, spec, shininess=shin, emission=emis * emis_f
    )
    m.name = name or "fbx_material"
    return m


def load_fbx(parent: Node, path) -> Node:
    """Load a binary FBX under a new child node: one grandchild per Model
    carrying its local transform and one MeshPrimitive per material slot
    (matching load_obj/load_gltf wiring)."""
    root_rec, _version = parse_fbx(path)
    objects = root_rec.find("Objects")
    conns = root_rec.find("Connections")
    if objects is None:
        raise ValueError(f"{path}: no Objects section")

    geoms, models, mats = {}, {}, {}
    for o in objects.children:
        if not o.props:
            continue
        oid = o.props[0]
        if o.name == "Geometry":
            geoms[oid] = o
        elif o.name == "Model":
            models[oid] = o
        elif o.name == "Material":
            mats[oid] = o

    # OO connections: child id -> parent id
    geo_of_model = {}
    mats_of_model = {}
    parent_of_model = {}
    if conns is not None:
        for c in conns.find_all("C"):
            if len(c.props) < 3 or c.props[0] != "OO":
                continue
            child, par = c.props[1], c.props[2]
            if child in geoms and par in models:
                geo_of_model[par] = child
            elif child in mats and par in models:
                mats_of_model.setdefault(par, []).append(child)
            elif child in models and par in models:
                parent_of_model[child] = par

    root = parent.add_child(Path(path).stem)
    node_of_model = {}

    def model_node(mid):
        if mid in node_of_model:
            return node_of_model[mid]
        par = parent_of_model.get(mid)
        base = model_node(par) if par in models else root
        m = models[mid]
        name = m.props[1] if len(m.props) > 1 else "model"
        if isinstance(name, str):
            name = name.split("\x00")[0] or "model"
        n = base.add_child(name)
        n.make_component(TransformComponent(matrix=_model_transform(m)))
        node_of_model[mid] = n
        return n

    for mid, gid in geo_of_model.items():
        n = model_node(mid)
        pos, idx, nrm, uv, slot = _triangulate(geoms[gid])
        mat_ids = mats_of_model.get(mid, [])
        materials = [_material_from(mats[i]) for i in mat_ids] or [Material()]
        for s in np.unique(slot):
            sel = slot == s
            sub_idx = idx[sel]
            m = materials[int(s) % len(materials)]
            n.add_child(f"slot{int(s)}").make_component(
                MeshPrimitive(
                    positions=pos,
                    indices=sub_idx.astype(np.int32),
                    normals=nrm,
                    uvs=uv,
                    material=m,
                )
            )
    return root


# ---------------------------------------------------------------------------
# Minimal binary FBX writer (version 7400, 32-bit records, uncompressed
# arrays) — test fixture + interchange, like write_vol_grid/write_nvdb_grid.

def _emit_prop(p):
    if isinstance(p, bool):
        return b"C" + struct.pack("<b", int(p))
    if isinstance(p, int):
        return b"L" + struct.pack("<q", p)
    if isinstance(p, float):
        return b"D" + struct.pack("<d", p)
    if isinstance(p, str):
        b = p.encode()
        return b"S" + struct.pack("<I", len(b)) + b
    if isinstance(p, np.ndarray):
        code = {"f4": b"f", "f8": b"d", "i4": b"i", "i8": b"l"}[p.dtype.str[1:]]
        raw = p.tobytes()
        return code + struct.pack("<III", p.size, 0, len(raw)) + raw
    raise TypeError(type(p))


def _emit_node(name, props=(), children=(), base=0):
    nb = name.encode()
    pb = b"".join(_emit_prop(p) for p in props)
    head_len = 13 + len(nb)
    body = b""
    off = base + head_len + len(pb)
    for cname, cprops, cchildren in children:
        cb = _emit_node(cname, cprops, cchildren, off)
        body += cb
        off += len(cb)
    if children:
        body += bytes(13)  # NULL terminator record
        off += 13
    end = off
    return (
        struct.pack("<III", end, len(props), len(pb))
        + bytes([len(nb)]) + nb + pb + body
    )


def write_fbx(path, meshes, version: int = 7400):
    """meshes: list of dicts {name, positions [V,3], indices [T,3],
    normals [V,3]?, uvs [V,2]?, transform [3,4]?, diffuse [3]?,
    emissive [3]?}. One Model+Geometry+Material per entry."""
    objects = []
    connections = []
    next_id = 1000

    def p70(entries):
        return ("Properties70", (), [
            ("P", tuple(e), ()) for e in entries
        ])

    for mesh in meshes:
        gid, mid, matid = next_id, next_id + 1, next_id + 2
        next_id += 10
        pos = np.asarray(mesh["positions"], np.float64).reshape(-1)
        idx = np.asarray(mesh["indices"], np.int64).reshape(-1, 3).copy()
        pvi = idx.astype(np.int64)
        pvi[:, 2] = ~pvi[:, 2]  # negative-terminated triangles
        geo_children = [
            ("Vertices", (pos,), ()),
            ("PolygonVertexIndex", (pvi.reshape(-1).astype(np.int32),), ()),
        ]
        if mesh.get("normals") is not None:
            nrm = np.asarray(mesh["normals"], np.float64).reshape(-1)
            geo_children.append((
                "LayerElementNormal", (0,),
                [("MappingInformationType", ("ByVertice",), ()),
                 ("ReferenceInformationType", ("Direct",), ()),
                 ("Normals", (nrm,), ())],
            ))
        if mesh.get("uvs") is not None:
            uv = np.asarray(mesh["uvs"], np.float64).copy()
            uv[:, 1] = 1.0 - uv[:, 1]  # loader flips V back
            geo_children.append((
                "LayerElementUV", (0,),
                [("MappingInformationType", ("ByVertice",), ()),
                 ("ReferenceInformationType", ("Direct",), ()),
                 ("UV", (uv.reshape(-1),), ())],
            ))
        objects.append((
            "Geometry", (gid, f"{mesh['name']}\x00\x01Geometry", "Mesh"),
            geo_children,
        ))
        tr = mesh.get("translation", (0.0, 0.0, 0.0))
        rot = mesh.get("rotation_deg", (0.0, 0.0, 0.0))
        sc = mesh.get("scaling", (1.0, 1.0, 1.0))
        objects.append((
            "Model", (mid, f"{mesh['name']}\x00\x01Model", "Mesh"),
            [p70([
                ("Lcl Translation", "Lcl Translation", "", "A",
                 float(tr[0]), float(tr[1]), float(tr[2])),
                ("Lcl Rotation", "Lcl Rotation", "", "A",
                 float(rot[0]), float(rot[1]), float(rot[2])),
                ("Lcl Scaling", "Lcl Scaling", "", "A",
                 float(sc[0]), float(sc[1]), float(sc[2])),
            ])],
        ))
        dif = mesh.get("diffuse", (0.8, 0.8, 0.8))
        emi = mesh.get("emissive", (0.0, 0.0, 0.0))
        objects.append((
            "Material", (matid, f"{mesh['name']}_mat\x00\x01Material", ""),
            [p70([
                ("DiffuseColor", "Color", "", "A",
                 float(dif[0]), float(dif[1]), float(dif[2])),
                ("EmissiveColor", "Color", "", "A",
                 float(emi[0]), float(emi[1]), float(emi[2])),
                ("EmissiveFactor", "Number", "", "A", 1.0),
            ])],
        ))
        connections.append(("C", ("OO", gid, mid), ()))
        connections.append(("C", ("OO", matid, mid), ()))
        connections.append(("C", ("OO", mid, 0), ()))

    out = _MAGIC + b"\x1a\x00" + struct.pack("<I", version)
    off = len(out)
    for name, props, children in (
        ("FBXHeaderExtension", (), [("FBXVersion", (version,), ())]),
        ("Objects", (), objects),
        ("Connections", (), connections),
    ):
        b = _emit_node(name, props, children, off)
        out += b
        off += len(b)
    out += bytes(13)
    Path(path).write_bytes(out)
