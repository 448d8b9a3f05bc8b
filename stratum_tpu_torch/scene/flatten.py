"""Scene flattening: node graph -> the port's SceneData (counterpart of
stratum_tpu/scene/flatten.py:50-93, 184-609).

Walks the node graph (``scene/graph.py``), bakes meshes to
world space, dedups materials by value, builds the light table, the native
SAH fat BVH (K = 256), the fused per-slot hit payload and the dense
tracers' triangle features and per-triangle payload, all in numpy, then
moves the result onto ``device`` (the card unless the caller names
another). Scenes with textures, analytic spheres,
media or environment images are refused: their render paths are not ported
yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from stratum_tpu_torch.scene.graph import (
    CameraComponent,
    EnvironmentComponent,
    MediumComponent,
    MeshPrimitive,
    Node,
    SpherePrimitive,
)
from stratum_tpu_torch.scene.material import Material
from stratum_tpu_torch.ops.mxu import build_tri_features
from stratum_tpu_torch.ops.packet import build_fat_bvh_sah
from stratum_tpu_torch.scene import schema

LEAF_SIZE = 256
_TEXTURE_FIELDS = (
    "base_color_image", "emission_image", "rough_metal_image",
    "normal_image", "alpha_image",
)


@dataclasses.dataclass
class FlattenStats:
    num_instances: int = 0
    num_triangles: int = 0
    num_vertices: int = 0
    num_materials: int = 0
    num_lights: int = 0


def tessellate_sphere(radius: float, stacks: int = 32, slices: int = 64):
    """UV-sphere triangulation with outward winding (numpy)."""
    i = np.arange(stacks + 1, dtype=np.float32)
    j = np.arange(slices + 1, dtype=np.float32)
    theta = i / stacks * np.pi
    phi = j / slices * 2.0 * np.pi
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    sp, cp = np.sin(phi)[None, :], np.cos(phi)[None, :]
    x = st * cp
    y = ct * np.ones_like(sp)
    z = st * sp
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    uv = np.stack(
        [np.broadcast_to(j / slices, x.shape),
         np.broadcast_to((i / stacks)[:, None], x.shape)],
        axis=-1,
    ).reshape(-1, 2)
    idx = []
    for a in range(stacks):
        for b in range(slices):
            v00 = a * (slices + 1) + b
            v01 = v00 + 1
            v10 = v00 + (slices + 1)
            v11 = v10 + 1
            if a > 0:
                idx.append((v00, v10, v01))
            if a < stacks - 1:
                idx.append((v01, v10, v11))
    indices = np.asarray(idx, np.int32)
    p = pos.astype(np.float32)
    fn = np.cross(p[indices[:, 1]] - p[indices[:, 0]], p[indices[:, 2]] - p[indices[:, 0]])
    centroid = (p[indices[:, 0]] + p[indices[:, 1]] + p[indices[:, 2]]) / 3
    flip = np.einsum("ij,ij->i", fn, centroid) < 0
    indices[flip] = indices[flip][:, ::-1]
    return (pos * radius).astype(np.float32), p, uv.astype(np.float32), indices


def _transform_mesh(m, positions, normals):
    """Bake node-to-world into vertices; normals via inverse-transpose."""
    pw = positions @ m[:, :3].T + m[:, 3]
    lin = m[:, :3]
    nw = normals @ np.linalg.inv(lin)
    nw /= np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-20)
    if np.linalg.det(lin) < 0:
        nw = -nw
    return pw.astype(np.float32), nw.astype(np.float32)


def compute_smooth_normals(positions, indices):
    """Area-weighted smooth vertex normals."""
    n = np.zeros_like(positions)
    p0 = positions[indices[:, 0]]
    face_n = np.cross(positions[indices[:, 1]] - p0, positions[indices[:, 2]] - p0)
    for k in range(3):
        np.add.at(n, indices[:, k], face_n)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return np.where(
        ln > 1e-12, n / np.maximum(ln, 1e-20), [0.0, 0.0, 1.0]
    ).astype(np.float32)


def flatten(root: Node, env_probability: float = 0.5, device="cuda"):
    """Walk the subtree under ``root`` -> (SceneData on ``device``,
    FlattenStats). Without a CUDA device the default raises; CPU callers
    pass ``device="cpu"``."""
    stats = FlattenStats()
    all_pos, all_nrm, all_uv, all_idx, all_mat, all_inst = [], [], [], [], [], []
    materials: list[Material] = []
    mat_rows: dict = {}
    vert_base = 0
    default_mat = Material()

    def material_row(mat) -> int:
        m = mat if mat is not None else default_mat
        if any(getattr(m, f) is not None for f in _TEXTURE_FIELDS):
            raise NotImplementedError(
                "textured materials: ROADMAP Queue 1 item 2 (textures and the colonnade)"
            )
        k = m.key()
        if k not in mat_rows:
            mat_rows[k] = len(materials)
            materials.append(m)
        return mat_rows[k]

    def add_mesh(node, positions, indices, normals, uvs, material):
        nonlocal vert_base
        if normals is None:
            normals = compute_smooth_normals(positions, indices)
        if uvs is None:
            uvs = np.zeros((positions.shape[0], 2), np.float32)
        pw, nw = _transform_mesh(node.to_world(), positions, normals)
        row = material_row(material)
        all_pos.append(pw)
        all_nrm.append(nw)
        all_uv.append(np.asarray(uvs, np.float32))
        all_idx.append(np.asarray(indices, np.int32) + vert_base)
        all_mat.append(np.full(indices.shape[0], row, np.int32))
        all_inst.append(np.full(indices.shape[0], stats.num_instances, np.int32))
        vert_base += positions.shape[0]
        stats.num_instances += 1

    env_component = None
    for node in root.descendants():
        mp = node.find(MeshPrimitive)
        if mp is not None:
            add_mesh(node, mp.positions, mp.indices, mp.normals, mp.uvs, mp.material)
        sp = node.find(SpherePrimitive)
        if sp is not None:
            if sp.analytic:
                raise NotImplementedError(
                    "analytic spheres: ROADMAP Queue 1 item 4 (media and spheres)"
                )
            pos, nrm, uv, idx = tessellate_sphere(sp.radius, sp.stacks, sp.slices)
            add_mesh(node, pos, idx, nrm, uv, sp.material)
        ec = node.find(EnvironmentComponent)
        if ec is not None:
            env_component = ec
        if node.find(MediumComponent) is not None:
            raise NotImplementedError(
                "participating media: ROADMAP Queue 1 item 4 (media and spheres)"
            )
    if not all_pos:
        raise ValueError("scene contains no triangle geometry")

    arrs = schema.default_material_arrays(len(materials))
    for i, m in enumerate(materials):
        arrs["base_color"][i] = np.asarray(m.base_color, np.float32)
        arrs["emission"][i] = np.asarray(m.emission, np.float32)
        for f in schema.MATERIAL_FLOATS + ("alpha_cutoff",):
            arrs[f][i] = getattr(m, f)
    mats = schema.finalize_materials(arrs)

    has_env = env_component is not None and (
        np.any(np.asarray(env_component.color) > 0)
        or env_component.image is not None
    )
    if has_env and env_component.image is not None:
        raise NotImplementedError(
            "environment images: ROADMAP Queue 1 item 2 (textures and the colonnade)"
        )
    env = schema.constant_environment(env_component.color if has_env else (0.0, 0.0, 0.0))

    pos_p, nrm_p, uv_p, idx_p, mat_p, inst_p = schema.build_geometry(
        np.concatenate(all_pos), np.concatenate(all_nrm),
        np.concatenate(all_uv), np.concatenate(all_idx),
        np.concatenate(all_mat), np.concatenate(all_inst),
    )
    lights, tri_light = schema.build_lights(
        pos_p, idx_p, mat_p, mats.emission,
        env_probability=env_probability if has_env else 0.0,
    )
    packed_rows = schema.pack_tri_rows(
        pos_p, nrm_p, uv_p, idx_p, mat_p, tri_light, inst_p
    )
    geo = schema.GeometrySoA(
        positions=pos_p, normals=nrm_p, uvs=uv_p, indices=idx_p,
        tri_material=mat_p, tri_light=tri_light, tri_instance=inst_p,
        packed_tri=packed_rows,
    )
    fat = build_fat_bvh_sah(pos_p, idx_p, mat_p >= 0, leaf_size=LEAF_SIZE)
    scene = schema.SceneData(
        geo=geo, materials=mats, lights=lights, env=env, fat_bvh=fat,
        slot_payload=build_slot_payload(packed_rows, mats, fat),
        tri_features=build_tri_features(pos_p, idx_p, mat_p >= 0),
        tri_payload=schema.build_tri_payload(packed_rows, mats.packed),
    )
    stats.num_triangles = int(sum(i.shape[0] for i in all_idx))
    stats.num_vertices = int(vert_base)
    stats.num_materials = len(materials)
    stats.num_lights = lights.num_lights
    return schema.to_device(scene, device), stats


def build_slot_payload(packed_tri, mats, fat) -> np.ndarray:
    """Fused per-slot hit payload [L*K, 88] (numpy; see SceneData)."""
    slot_tri = np.asarray(fat.leaf_tri).reshape(-1)
    if packed_tri.shape[0] >= (1 << 24):
        raise ValueError("tri ids must stay f32-exact (< 2^24)")
    pk = np.asarray(packed_tri)[np.maximum(slot_tri, 0)]
    feat = np.asarray(fat.leaf_feat).reshape(slot_tri.shape[0], 10, 4)
    auv = feat[:, :, 0:3].reshape(-1, 30)
    mat_ids = np.maximum(pk[:, 24].astype(np.int32), 0)
    mrows = np.asarray(mats.packed)[mat_ids]
    ntex = np.asarray(mats.normal_tex)[mat_ids].astype(np.float32)
    return np.concatenate(
        [pk, auv, slot_tri.astype(np.float32)[:, None], ntex[:, None], mrows],
        axis=1,
    ).astype(np.float32)


def find_camera(root: Node):
    """First camera in the subtree -> (node, CameraComponent) or None."""
    for node, cam in root.find_in_descendants(CameraComponent):
        return node, cam
    return None
