"""The atrium, frozen: a Sponza-class procedural hall of 132,778 triangles
(floor and walls, two colonnades of stacked-sphere pillars, an arcade of
boxes, an emissive sky strip under the open roof, a constant environment).

A copy of the geometry the port's ``scene/builtin.py::atrium`` builds, in
numpy alone, so a later change to the program cannot move the yardstick.
:func:`build` returns plain arrays; the harness hands them to the program
as a scene graph and the reference takes the same arrays as triangles.
The geometry is fixed; ``seed`` is not used here (the traffic draws the
sample seeds and the camera path from it).
"""

from __future__ import annotations

import numpy as np


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world [3, 4] f32 with +z forward, +y up, +x right."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)

    def nrm(v):
        return v / np.sqrt(np.maximum(np.sum(v * v), np.float32(1e-20)))

    fwd = nrm(target - eye)
    right = nrm(np.cross(up, fwd))
    true_up = np.cross(fwd, right)
    lin = np.stack([right, true_up, fwd], axis=-1)
    return np.concatenate([lin, eye[:, None]], axis=-1).astype(np.float32)


def quad(p0, p1, p2, p3):
    pos = np.asarray([p0, p1, p2, p3], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return pos, idx


def box(pmin, pmax):
    """Axis-aligned box as 12 triangles with outward normals."""
    x0, y0, z0 = pmin
    x1, y1, z1 = pmax
    quads = [
        quad((x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0)),
        quad((x1, y0, z1), (x0, y0, z1), (x0, y1, z1), (x1, y1, z1)),
        quad((x0, y0, z1), (x0, y0, z0), (x0, y1, z0), (x0, y1, z1)),
        quad((x1, y0, z0), (x1, y0, z1), (x1, y1, z1), (x1, y1, z0)),
        quad((x0, y0, z1), (x1, y0, z1), (x1, y0, z0), (x0, y0, z0)),
        quad((x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1)),
    ]
    pos = np.concatenate([q[0] for q in quads])
    idx = np.concatenate([q[1] + 4 * i for i, q in enumerate(quads)])
    return pos, idx


def sphere(stacks: int, slices: int):
    """Unit UV sphere with outward winding and no degenerate pole
    triangles -> (positions [V, 3] f32, indices [T, 3] i32)."""
    i = np.arange(stacks + 1, dtype=np.float32)
    j = np.arange(slices + 1, dtype=np.float32)
    theta = i / stacks * np.pi
    phi = j / slices * 2.0 * np.pi
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    sp, cp = np.sin(phi)[None, :], np.cos(phi)[None, :]
    pos = np.stack([st * cp, ct * np.ones_like(sp), st * sp], axis=-1).reshape(-1, 3)
    idx = []
    for a in range(stacks):
        for b in range(slices):
            v00 = a * (slices + 1) + b
            v10 = v00 + (slices + 1)
            if a > 0:
                idx.append((v00, v10, v00 + 1))
            if a < stacks - 1:
                idx.append((v00 + 1, v10, v10 + 1))
    indices = np.asarray(idx, np.int32)
    p = pos.astype(np.float32)
    fn = np.cross(p[indices[:, 1]] - p[indices[:, 0]], p[indices[:, 2]] - p[indices[:, 0]])
    centroid = (p[indices[:, 0]] + p[indices[:, 1]] + p[indices[:, 2]]) / 3
    flip = np.einsum("ij,ij->i", fn, centroid) < 0
    indices[flip] = indices[flip][:, ::-1]
    return p, indices


def _material(base_color, emission=(0.0, 0.0, 0.0), metallic=0.0, roughness=1.0):
    return dict(base_color=[float(x) for x in np.float32(base_color)],
                emission=[float(x) for x in np.float32(emission)],
                metallic=float(metallic), roughness=float(roughness))


def build(params: dict, seed: int, workdir) -> dict:
    """The scene as plain arrays: ``meshes`` in instance order, each with
    object-space ``positions``, ``indices``, a 3x4 ``matrix`` (or None) and
    a ``material``; the ``environment`` colour; the ``camera``."""
    columns = int(params.get("columns", 6))
    stacks = int(params.get("stacks", 24))
    slices = int(params.get("slices", 48))
    stone = _material((0.55, 0.5, 0.45))
    red_cloth = _material((0.5, 0.1, 0.08))
    brass = _material((0.8, 0.6, 0.3), metallic=1.0, roughness=0.35)
    meshes = []

    def add(name, pos, idx, mat, matrix=None):
        meshes.append(dict(name=name, positions=pos, indices=idx, material=mat, matrix=matrix))

    hw, hh, hl = 12.0, 10.0, 40.0
    add("floor", *quad((-hw, 0, -hl), (-hw, 0, hl), (hw, 0, hl), (hw, 0, -hl)), stone)
    add("wall_l", *quad((-hw, 0, -hl), (-hw, hh, -hl), (-hw, hh, hl), (-hw, 0, hl)), stone)
    add("wall_r", *quad((hw, 0, -hl), (hw, 0, hl), (hw, hh, hl), (hw, hh, -hl)), stone)
    add("wall_far", *quad((-hw, 0, hl), (-hw, hh, hl), (hw, hh, hl), (hw, 0, hl)), stone)

    sph_pos, sph_idx = sphere(stacks, slices)
    k = 0
    for side in (-1.0, 1.0):
        for i in range(columns):
            z = -hl + (i + 0.5) * (2 * hl / columns)
            for level in range(5):
                m = np.eye(3, 4, dtype=np.float32)
                m[:, :3] *= 0.8 if level % 2 == 0 else 0.65
                m[:, 3] = (side * (hw - 2.0), 0.9 + level * 1.7, z)
                add(f"col_{side}_{i}_{level}", sph_pos, sph_idx,
                    [stone, red_cloth, brass][k % 3], matrix=m)
                k += 1

    for i in range(columns * 2):
        z = -hl + (i + 0.5) * (hl / columns)
        for side in (-1.0, 1.0):
            pos, idx = box((-1.2, 0, -1.2), (1.2, 0.8, 1.2))
            m = np.eye(3, 4, dtype=np.float32)
            m[:, 3] = (side * (hw - 2.0), hh - 1.2, z)
            add(f"arch_{side}_{i}", pos, idx, stone, matrix=m)

    y = hh - 1e-2
    add("sky_light", *quad((-3, y, -hl), (3, y, -hl), (3, y, hl), (-3, y, hl)),
        _material((0.0, 0.0, 0.0), emission=(6.0, 6.5, 7.0)))
    cam = params.get("camera", {})
    return dict(
        meshes=meshes,
        environment=[float(x) for x in np.full(3, 0.05, np.float32)],
        camera=dict(
            camera_to_world=look_at(cam.get("eye", (0.0, 4.0, -hl + 2.0)),
                                    cam.get("target", (0.0, 4.0, hl))),
            fovy=float(np.radians(cam.get("fovy_deg", 55.0))),
        ),
    )
