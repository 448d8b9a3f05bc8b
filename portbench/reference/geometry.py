"""The raw scene as the reference sees it: world triangles, each triangle's
instance, area-weighted smooth vertex normals, materials, and the pinhole
camera (+z forward, +y up, +x right; ``fovy`` the vertical field of view).
Plain numpy and torch."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class World(NamedTuple):
    tri: torch.Tensor  # f32 [T, 3, 3] world positions
    normals: torch.Tensor  # f32 [T, 3, 3] unit vertex normals
    instance: torch.Tensor  # i64 [T] mesh index
    base_color: torch.Tensor  # f32 [M, 3] per mesh
    emissive: torch.Tensor  # bool [M] per mesh
    emission: torch.Tensor  # f32 [M, 3] per mesh
    metallic: torch.Tensor  # f32 [M] per mesh
    roughness: torch.Tensor  # f32 [M] per mesh


def _smooth_normals(pos: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Per vertex the normalized sum of its faces' (unnormalized) normals;
    (0, 0, 1) where that sum vanishes."""
    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    face = np.cross(p1 - p0, p2 - p0)
    acc = np.zeros_like(pos, dtype=np.float64)
    for k in range(3):
        np.add.at(acc, idx[:, k], face)
    ln = np.linalg.norm(acc, axis=-1, keepdims=True)
    out = np.where(ln > 1e-12, acc / np.maximum(ln, 1e-20), [0.0, 0.0, 1.0])
    return out.astype(np.float32)


def world(raw: dict, device, normals: bool = True) -> World:
    """The meshes of a scene module's ``build`` in world space (vertex
    normals only with ``normals``; else zeros)."""
    tris, norms, inst, colors, emissive, emission, metal, rough = ([] for _ in range(8))
    for i, m in enumerate(raw["meshes"]):
        pos = np.asarray(m["positions"], np.float32)
        idx = np.asarray(m["indices"], np.int64)
        nrm = _smooth_normals(pos, idx) if normals else np.zeros_like(pos)
        mat = m["matrix"]
        if mat is not None:
            mat = np.asarray(mat, np.float32)
            pos = (pos @ mat[:, :3].T + mat[:, 3]).astype(np.float32)
        if mat is not None and normals:
            lin = mat[:, :3].astype(np.float64)
            nrm = nrm @ np.linalg.inv(lin)
            nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
            if np.linalg.det(lin) < 0:
                nrm = -nrm
            nrm = nrm.astype(np.float32)
        tris.append(pos[idx])
        norms.append(nrm[idx])
        inst.append(np.full(len(idx), i, np.int64))
        colors.append(m["material"]["base_color"])
        emissive.append(float(np.mean(m["material"]["emission"])) > 0)
        emission.append(m["material"]["emission"])
        metal.append(float(m["material"].get("metallic", 0.0)))
        rough.append(float(m["material"].get("roughness", 1.0)))

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    return World(tri=t(np.concatenate(tris)), normals=t(np.concatenate(norms)),
                 instance=t(np.concatenate(inst), torch.int64),
                 base_color=t(np.asarray(colors, np.float32)),
                 emissive=t(np.asarray(emissive), torch.bool),
                 emission=t(np.asarray(emission, np.float32)),
                 metallic=t(np.asarray(metal, np.float32)),
                 roughness=t(np.asarray(rough, np.float32)))


class Camera(NamedTuple):
    eye: torch.Tensor  # [3]
    basis: torch.Tensor  # [3, 3] columns right, up, forward
    tan_y: float  # tan(fovy / 2)
    width: int
    height: int


def camera(camera_to_world, fovy: float, width: int, height: int, device) -> Camera:
    m = torch.as_tensor(np.asarray(camera_to_world, np.float32), device=device)
    return Camera(eye=m[:, 3], basis=m[:, :3], tan_y=float(np.tan(fovy / 2.0)),
                  width=width, height=height)


def pixel_rays(cam: Camera, px, py, jitter=0.5):
    """Rays through (px + jitter, py + jitter) -> (origin, unit direction)."""
    x = ((px.float() + jitter) / cam.width * 2.0 - 1.0) * cam.tan_y * cam.width / cam.height
    y = -((py.float() + jitter) / cam.height * 2.0 - 1.0) * cam.tan_y
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1) @ cam.basis.T
    d = d / d.norm(dim=-1, keepdim=True)
    return cam.eye.expand_as(d), d


def project(cam: Camera, p, dtype=torch.float32):
    """World points -> (sub-pixel position [N, 2] in pixels, in front and
    inside the image), computed in ``dtype``."""
    c = ((p.to(dtype) - cam.eye.to(dtype)) @ cam.basis.to(dtype)).float()
    z = c[:, 2]
    sz = torch.where(z.abs() > 1e-20, z, torch.full_like(z, 1e-20))
    nx = c[:, 0] / sz / (cam.tan_y * cam.width / cam.height)
    ny = c[:, 1] / sz / cam.tan_y
    inside = (z > 0) & (nx.abs() <= 1.0) & (ny.abs() <= 1.0)
    pix = torch.stack([(nx * 0.5 + 0.5) * cam.width, (-ny * 0.5 + 0.5) * cam.height], dim=-1)
    return pix, inside


def first_hit_rows(w: World, t, k, u, v, d):
    """Per ray the hit's face-forward shading and geometric normals (the
    vertex normals interpolated, turned to the geometric normal's side,
    then both to face the ray), whether the ray meets the triangle's front
    (its winding's side), its mesh, its base colour and whether it is an
    emitter."""
    hit = k >= 0
    kk = torch.clamp(k, min=0)
    tri, nv = w.tri[kk], w.normals[kk]
    ng = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    ng = ng / ng.norm(dim=-1, keepdim=True).clamp(min=1e-30)
    ns = (1.0 - u - v)[:, None] * nv[:, 0] + u[:, None] * nv[:, 1] + v[:, None] * nv[:, 2]
    ns = ns / ns.norm(dim=-1, keepdim=True).clamp(min=1e-30)
    ns = torch.where(((ns * ng).sum(-1) < 0)[:, None], -ns, ns)
    front = (d * ng).sum(-1) < 0
    ns = torch.where(front[:, None], ns, -ns)
    inst = w.instance[kk]
    return dict(hit=hit, normal=ns, geom_normal=torch.where(front[:, None], ng, -ng),
                front=front, mesh=inst, instance=torch.where(hit, inst, -1),
                base_color=w.base_color[inst], emissive=w.emissive[inst])
