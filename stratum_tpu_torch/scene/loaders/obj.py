"""Wavefront OBJ (+ MTL) loader (counterpart of
stratum_tpu/scene/loaders/obj.py, numpy only): the port's copy of the
reference's hand-rolled OBJ parser
(src/Node/loaders/load_obj.cpp: v/vt/vn/f parsing with quads split into two
triangles at 129-225, vertex dedup by (v,vt,vn) at 107-126, smooth-normal
generation at 52-86). Additionally parses MTL files into host Materials
(the reference routes materials through assimp for OBJ; a native MTL path
keeps the loader dependency-free).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from stratum_tpu_torch.io.image import load_image
from stratum_tpu_torch.scene.flatten import compute_smooth_normals
from stratum_tpu_torch.scene.graph import MeshPrimitive, Node
from stratum_tpu_torch.scene.material import Material


@dataclasses.dataclass
class ObjMesh:
    name: str
    positions: np.ndarray  # [V,3]
    normals: np.ndarray | None
    uvs: np.ndarray | None
    indices: np.ndarray  # [T,3]
    material: Material


def _parse_mtl(path: Path) -> dict[str, Material]:
    mats: dict[str, Material] = {}
    cur: Material | None = None
    if not path.exists():
        return mats
    for line in path.read_text(errors="replace").splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        cmd, args = parts[0], parts[1:]
        if cmd == "newmtl":
            cur = Material(name=args[0] if args else "")
            cur.base_color = np.zeros(3, np.float32)
            mats[cur.name] = cur
        elif cur is None:
            continue
        elif cmd == "Kd":
            cur.base_color = np.asarray([float(x) for x in args[:3]], np.float32)
        elif cmd == "Ke":
            cur.emission = np.asarray([float(x) for x in args[:3]], np.float32)
        elif cmd == "Ns":
            # shininess -> roughness (reference conversion
            # kernels/material_convert.hlsl: roughness = sqrt(2/(Ns+2)))
            cur.roughness = float(np.sqrt(2.0 / (float(args[0]) + 2.0)))
        elif cmd == "Ni":
            cur.eta = float(args[0])
        elif cmd == "d":
            pass  # dissolve handled via alpha textures when present
        elif cmd == "map_Kd" and args:
            p = path.parent / args[-1]
            if p.exists():
                img = load_image(p, srgb=True)
                cur.base_color_image = img[..., :4]
                if np.asarray(cur.base_color).max() <= 0.0:
                    cur.base_color = np.ones(3, np.float32)
        elif cmd in ("map_bump", "bump") and args:
            p = path.parent / args[-1]
            if p.exists():
                cur.normal_image = load_image(p, srgb=False)
    return mats


def load_obj_meshes(path) -> list[ObjMesh]:
    """Parse an OBJ file into per-material meshes."""
    path = Path(path)
    positions: list[list[float]] = []
    uvs: list[list[float]] = []
    normals: list[list[float]] = []
    materials: dict[str, Material] = {}
    default_mat = Material(name="default")
    groups: dict[str, list] = {}
    cur_mat = "default"

    def resolve(idx: str, n: int) -> int:
        i = int(idx)
        return i - 1 if i > 0 else n + i

    for line in path.read_text(errors="replace").splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        cmd, args = parts[0], parts[1:]
        if cmd == "v":
            positions.append([float(x) for x in args[:3]])
        elif cmd == "vt":
            uvs.append([float(args[0]), float(args[1]) if len(args) > 1 else 0.0])
        elif cmd == "vn":
            normals.append([float(x) for x in args[:3]])
        elif cmd == "mtllib" and args:
            materials.update(_parse_mtl(path.parent / " ".join(args)))
        elif cmd == "usemtl":
            cur_mat = args[0] if args else "default"
        elif cmd == "f":
            corners = []
            for spec in args:
                comp = spec.split("/")
                vi = resolve(comp[0], len(positions))
                ti = (
                    resolve(comp[1], len(uvs))
                    if len(comp) > 1 and comp[1]
                    else -1
                )
                ni = (
                    resolve(comp[2], len(normals))
                    if len(comp) > 2 and comp[2]
                    else -1
                )
                corners.append((vi, ti, ni))
            # fan-triangulate (quads -> 2 tris, load_obj.cpp:196-212)
            tris = groups.setdefault(cur_mat, [])
            for k in range(1, len(corners) - 1):
                tris.append((corners[0], corners[k], corners[k + 1]))

    pos_np = np.asarray(positions, np.float32)
    uv_np = np.asarray(uvs, np.float32) if uvs else None
    nrm_np = np.asarray(normals, np.float32) if normals else None

    meshes = []
    for mat_name, tris in groups.items():
        # dedup corners by (v, vt, vn) (load_obj.cpp:107-126)
        remap: dict[tuple, int] = {}
        out_idx = np.empty((len(tris), 3), np.int32)
        vp, vt, vn = [], [], []
        for t, tri in enumerate(tris):
            for c, corner in enumerate(tri):
                j = remap.get(corner)
                if j is None:
                    j = len(vp)
                    remap[corner] = j
                    vp.append(pos_np[corner[0]])
                    vt.append(
                        uv_np[corner[1]]
                        if uv_np is not None and corner[1] >= 0
                        else np.zeros(2, np.float32)
                    )
                    vn.append(
                        nrm_np[corner[2]]
                        if nrm_np is not None and corner[2] >= 0
                        else None
                    )
                out_idx[t, c] = j
        vpos = np.asarray(vp, np.float32)
        vuv = np.asarray(vt, np.float32)
        if any(n is None for n in vn):
            vnrm = compute_smooth_normals(vpos, out_idx)
        else:
            vnrm = np.asarray(vn, np.float32)
        meshes.append(
            ObjMesh(
                name=mat_name,
                positions=vpos,
                normals=vnrm,
                uvs=vuv,
                indices=out_idx,
                material=materials.get(mat_name, default_mat),
            )
        )
    return meshes


def load_obj(parent: Node, path) -> Node:
    """Load an OBJ under a new child node (one grandchild per material
    group), mirroring Scene::load_obj wiring."""
    root = parent.add_child(Path(path).stem)
    for mesh in load_obj_meshes(path):
        n = root.add_child(mesh.name)
        n.make_component(
            MeshPrimitive(
                positions=mesh.positions,
                indices=mesh.indices,
                normals=mesh.normals,
                uvs=mesh.uvs,
                material=mesh.material,
            )
        )
    return root
