"""Built-in scenes (counterpart of stratum_tpu/scene/builtin.py:24-250,
286-313): the Cornell box, the material spheres, the procedural atrium and
the white furnace, built on the port's
node graph with its numpy sphere tessellation and look_at, so building them
pulls in nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from stratum_tpu_torch.scene.graph import (
    CameraComponent,
    EnvironmentComponent,
    MeshPrimitive,
    NodeGraph,
    SpherePrimitive,
    TransformComponent,
)
from stratum_tpu_torch.scene.material import Material
from stratum_tpu_torch.core.transform import look_at
from stratum_tpu_torch.scene.flatten import tessellate_sphere


def _quad(p0, p1, p2, p3):
    pos = np.asarray([p0, p1, p2, p3], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return pos, idx


def _box(pmin, pmax):
    """Axis-aligned box as 12 triangles with outward normals."""
    x0, y0, z0 = pmin
    x1, y1, z1 = pmax
    quads = [
        _quad((x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0)),
        _quad((x1, y0, z1), (x0, y0, z1), (x0, y1, z1), (x1, y1, z1)),
        _quad((x0, y0, z1), (x0, y0, z0), (x0, y1, z0), (x0, y1, z1)),
        _quad((x1, y0, z0), (x1, y0, z1), (x1, y1, z1), (x1, y1, z0)),
        _quad((x0, y0, z1), (x1, y0, z1), (x1, y0, z0), (x0, y0, z0)),
        _quad((x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1)),
    ]
    pos = np.concatenate([q[0] for q in quads])
    idx = np.concatenate([q[1] + 4 * i for i, q in enumerate(quads)])
    return pos, idx


def _rot_y(deg: float) -> np.ndarray:
    a = np.radians(deg)
    c, s = np.cos(a), np.sin(a)
    return np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def cornell_box(light_scale: float = 1.0, boxes: bool = True) -> NodeGraph:
    """The classic Cornell box in 0..555 coordinates, camera on -z."""
    g = NodeGraph()
    white = Material(base_color=np.asarray([0.73, 0.73, 0.73], np.float32))
    red = Material(base_color=np.asarray([0.65, 0.05, 0.05], np.float32))
    green = Material(base_color=np.asarray([0.12, 0.45, 0.15], np.float32))
    light = Material(
        base_color=np.zeros(3, np.float32),
        emission=np.asarray([15.0, 15.0, 15.0], np.float32) * light_scale,
    )

    def add(name, quads, mat):
        pos = np.concatenate([q[0] for q in quads])
        idx = np.concatenate([q[1] + 4 * i for i, q in enumerate(quads)])
        n = g.root.add_child(name)
        n.make_component(MeshPrimitive(positions=pos, indices=idx, material=mat))

    s = 555.0
    add("floor", [_quad((0, 0, 0), (s, 0, 0), (s, 0, s), (0, 0, s))], white)
    add("ceiling", [_quad((0, s, 0), (0, s, s), (s, s, s), (s, s, 0))], white)
    add("back", [_quad((0, 0, s), (s, 0, s), (s, s, s), (0, s, s))], white)
    add("right", [_quad((s, 0, 0), (s, s, 0), (s, s, s), (s, 0, s))], green)
    add("left", [_quad((0, 0, 0), (0, 0, s), (0, s, s), (0, s, 0))], red)
    y = s - 1e-2
    add("light", [_quad((213, y, 227), (343, y, 227), (343, y, 332), (213, y, 332))], light)
    if boxes:
        for name, size, rot, at in (
            ("tall_box", (165, 330, 165), 15.0, (265, 0, 296)),
            ("short_box", (165, 165, 165), -18.0, (130, 0, 65)),
        ):
            pos, idx = _box((0, 0, 0), size)
            node = g.root.add_child(name)
            m = np.eye(3, 4, dtype=np.float32)
            m[:, :3] = _rot_y(rot)
            m[:, 3] = at
            node.make_component(TransformComponent(matrix=m))
            node.make_component(MeshPrimitive(positions=pos, indices=idx, material=white))
    cam = g.root.add_child("camera")
    m = np.eye(3, 4, dtype=np.float32)
    m[:, 3] = (278.0, 273.0, -800.0)
    cam.make_component(TransformComponent(matrix=m))
    cam.make_component(CameraComponent(fovy=np.radians(38.0)))
    return g


def material_spheres(stacks: int = 24, slices: int = 48) -> NodeGraph:
    """Three tessellated spheres (diffuse, metal, glass) on a floor under an
    area light and a gray environment: the Disney BSDF showcase."""
    g = NodeGraph()
    floor = g.root.add_child("floor")
    s = 20.0
    pos, idx = _quad((-s, 0, -s), (-s, 0, s), (s, 0, s), (s, 0, -s))
    floor.make_component(MeshPrimitive(
        positions=pos, indices=idx,
        material=Material(base_color=np.full(3, 0.5, np.float32))))
    mats = [
        Material(base_color=np.asarray([0.7, 0.3, 0.3], np.float32)),
        Material(base_color=np.asarray([0.9, 0.7, 0.3], np.float32), metallic=1.0,
                 roughness=0.25),
        Material(base_color=np.ones(3, np.float32), transmission=1.0, roughness=0.05,
                 eta=1.5),
    ]
    for i, m in enumerate(mats):
        n = g.root.add_child(f"sphere_{i}")
        t = np.eye(3, 4, dtype=np.float32)
        t[:, 3] = ((i - 1) * 2.4, 1.0, 0.0)
        n.make_component(TransformComponent(matrix=t))
        n.make_component(SpherePrimitive(radius=1.0, material=m, stacks=stacks, slices=slices))
    light = g.root.add_child("light")
    y = 6.0
    lpos, lidx = _quad((-2, y, -2), (2, y, -2), (2, y, 2), (-2, y, 2))
    light.make_component(MeshPrimitive(
        positions=lpos, indices=lidx,
        material=Material(base_color=np.zeros(3, np.float32),
                          emission=np.full(3, 10.0, np.float32))))
    env = g.root.add_child("env")
    env.make_component(EnvironmentComponent(color=np.full(3, 0.2, np.float32)))
    cam = g.root.add_child("camera")
    cam.make_component(TransformComponent(matrix=look_at((0.0, 2.2, -7.0), (0.0, 1.0, 0.0))))
    cam.make_component(CameraComponent(fovy=np.radians(45.0)))
    return g


def atrium(columns: int = 6, stacks: int = 24, slices: int = 48) -> NodeGraph:
    """Sponza-class procedural scene (132,778 triangles with the defaults):
    floor and walls, two colonnades of stacked-sphere pillars, an arcade of
    boxes, an emissive sky strip and a constant environment."""
    g = NodeGraph()
    stone = Material(base_color=np.asarray([0.55, 0.5, 0.45], np.float32))
    red_cloth = Material(base_color=np.asarray([0.5, 0.1, 0.08], np.float32))
    brass = Material(
        base_color=np.asarray([0.8, 0.6, 0.3], np.float32), metallic=1.0,
        roughness=0.35,
    )

    def add_mesh(name, pos, idx, mat, matrix=None):
        n = g.root.add_child(name)
        if matrix is not None:
            n.make_component(TransformComponent(matrix=matrix))
        n.make_component(MeshPrimitive(positions=pos, indices=idx, material=mat))

    hw, hh, hl = 12.0, 10.0, 40.0
    add_mesh("floor", *_quad((-hw, 0, -hl), (-hw, 0, hl), (hw, 0, hl), (hw, 0, -hl)), stone)
    add_mesh("wall_l", *_quad((-hw, 0, -hl), (-hw, hh, -hl), (-hw, hh, hl), (-hw, 0, hl)), stone)
    add_mesh("wall_r", *_quad((hw, 0, -hl), (hw, 0, hl), (hw, hh, hl), (hw, hh, -hl)), stone)
    add_mesh("wall_far", *_quad((-hw, 0, hl), (-hw, hh, hl), (hw, hh, hl), (hw, 0, hl)), stone)

    sph_pos, _, _, sph_idx = tessellate_sphere(1.0, stacks, slices)
    k = 0
    for side in (-1.0, 1.0):
        for i in range(columns):
            z = -hl + (i + 0.5) * (2 * hl / columns)
            for level in range(5):
                m = np.eye(3, 4, dtype=np.float32)
                m[:, :3] *= 0.8 if level % 2 == 0 else 0.65
                m[:, 3] = (side * (hw - 2.0), 0.9 + level * 1.7, z)
                add_mesh(f"col_{side}_{i}_{level}", sph_pos, sph_idx,
                         [stone, red_cloth, brass][k % 3], matrix=m)
                k += 1

    for i in range(columns * 2):
        z = -hl + (i + 0.5) * (hl / columns)
        for side in (-1.0, 1.0):
            pos, idx = _box((-1.2, 0, -1.2), (1.2, 0.8, 1.2))
            m = np.eye(3, 4, dtype=np.float32)
            m[:, 3] = (side * (hw - 2.0), hh - 1.2, z)
            add_mesh(f"arch_{side}_{i}", pos, idx, stone, matrix=m)

    y = hh - 1e-2
    add_mesh(
        "sky_light",
        *_quad((-3, y, -hl), (3, y, -hl), (3, y, hl), (-3, y, hl)),
        Material(base_color=np.zeros(3, np.float32),
                 emission=np.asarray([6.0, 6.5, 7.0], np.float32)),
    )
    env = g.root.add_child("env")
    env.make_component(EnvironmentComponent(color=np.full(3, 0.05, np.float32)))
    cam = g.root.add_child("camera")
    cam.make_component(TransformComponent(
        matrix=look_at((0.0, 4.0, -hl + 2.0), (0.0, 4.0, hl))
    ))
    cam.make_component(CameraComponent(fovy=np.radians(55.0)))
    return g


def furnace(albedo: float = 0.8, radiance: float = 0.5, stacks: int = 16,
            slices: int = 32) -> NodeGraph:
    """White furnace: a diffuse tessellated sphere in a constant
    environment. Environment pixels see exactly ``radiance``; with one
    bounce the sphere shows ``albedo * radiance``, and the full path series
    approaches ``radiance``."""
    g = NodeGraph()
    sph = g.root.add_child("sphere")
    sph.make_component(SpherePrimitive(
        radius=1.0, material=Material(base_color=np.full(3, albedo, np.float32)),
        stacks=stacks, slices=slices))
    env = g.root.add_child("env")
    env.make_component(EnvironmentComponent(color=np.full(3, radiance, np.float32)))
    cam = g.root.add_child("camera")
    m = np.eye(3, 4, dtype=np.float32)
    m[:, 3] = (0.0, 0.0, -4.0)
    cam.make_component(TransformComponent(matrix=m))
    cam.make_component(CameraComponent(fovy=np.radians(45.0)))
    return g
