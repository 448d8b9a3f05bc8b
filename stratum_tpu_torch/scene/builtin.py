"""Built-in scenes (counterpart of stratum_tpu/scene/builtin.py:24-313):
the Cornell box, the material spheres, the procedural atrium, the smoky
Cornell box and the white furnace, built on the port's
node graph with its numpy sphere tessellation and look_at, so building them
pulls in nothing of the JAX package. The port adds the sphereflake of
Haines' Standard Procedural Databases (:func:`sphereflake`).
"""

from __future__ import annotations

import numpy as np

from stratum_tpu_torch.scene.graph import (
    CameraComponent,
    EnvironmentComponent,
    MediumComponent,
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


def smoky_cornell(res: int = 32, sigma: float = 0.02) -> NodeGraph:
    """The Cornell box without its boxes, filled by a heterogeneous smoke
    plume: a swirling column (radial falloff around an axis displaced
    sinusoidally with height, thinning upward) on a ``res``^3 grid."""
    g = cornell_box(boxes=False)
    z = np.linspace(0.0, 1.0, res, dtype=np.float32)
    zz, yy, xx = np.meshgrid(z, z, z, indexing="ij")  # [D, H, W] = (z, y, x)
    ax = 0.5 + 0.18 * np.sin(6.0 * yy)
    az = 0.5 + 0.18 * np.cos(5.0 * yy + 1.3)
    r2 = (xx - ax) ** 2 + (zz - az) ** 2
    radius = 0.10 + 0.22 * yy
    core = np.exp(-r2 / np.maximum(radius**2, 1e-6))
    ripple = 0.75 + 0.25 * np.sin(12.0 * xx + 9.0 * zz + 7.0 * yy)
    density = (sigma * core * ripple * (1.0 - 0.6 * yy)).astype(np.float32)
    smoke = g.root.add_child("smoke")
    smoke.make_component(MediumComponent(
        density=density,
        box_lo=np.asarray([80.0, 0.0, 80.0], np.float32),
        box_hi=np.asarray([475.0, 460.0, 475.0], np.float32),
        albedo=np.asarray([0.85, 0.85, 0.9], np.float32),
        g=0.3,
    ))
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


# -- the SPD sphereflake (Haines, "A Proposal for Standard Graphics
# Environments", IEEE CG&A 7(11), 1987: balls.c), as its NFF output gives it
SPD_EYE = (2.1, 1.3, 1.7)
SPD_AT = (0.0, 0.0, 0.0)
SPD_UP = (0.0, 0.0, 1.0)
SPD_FOV_DEG = 45.0
SPD_BACKGROUND = (0.078, 0.361, 0.753)
SPD_LIGHTS = ((4.0, 3.0, 2.0), (1.0, -4.0, 4.0), (-3.0, 1.0, 5.0))
SPD_GROUND = ((12.0, 12.0, -0.5), (-12.0, 12.0, -0.5), (-12.0, -12.0, -0.5),
              (12.0, -12.0, -0.5))
SPD_LIGHT_RADIUS = 0.1


def _axis_rotation(axis, angle: float) -> np.ndarray:
    """Rodrigues' rotation by ``angle`` about the unit ``axis`` (float64)."""
    a = np.asarray(axis, np.float64)
    k = np.asarray([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
    return np.eye(3) + np.sin(angle) * k + (1.0 - np.cos(angle)) * (k @ k)


def _flake_directions() -> np.ndarray:
    """The nine child directions about +z: three corners of a cuboctahedron
    (pairwise 60 degrees apart) turned so that the triangular face normal
    (1, 1, 1) becomes +z, then that trio at 0, 120 and 240 degrees about
    +z: six on the equator and three above at 54.7 degrees."""
    s = 1.0 / np.sqrt(2.0)
    trio = np.asarray([[s, s, 0.0], [s, 0.0, -s], [0.0, s, -s]])
    trio = trio @ _axis_rotation(np.asarray([1.0, -1.0, 0.0]) * s,
                                 np.arccos(1.0 / np.sqrt(3.0))).T
    return np.concatenate([trio @ _axis_rotation((0.0, 0.0, 1.0), k * 2.0 * np.pi / 3.0).T
                           for k in range(3)])


def sphereflake_spheres(size_factor: int = 4):
    """The sphereflake's spheres in balls.c's output order (each sphere,
    then each child's subtree) -> (centres [N, 3] f64, radii [N] f64),
    N = 1 + 9 + ... + 9^size_factor. The root is (0, 0, 0) of radius 0.5;
    each child has a third of its parent's radius r, touches it (centre
    distance r + r / 3), and its nine directions are turned so that +z
    points away from the parent."""
    dirs = _flake_directions()
    centres, radii = [], []

    def grow(depth, centre, direction, radius):
        centres.append(centre)
        radii.append(radius)
        if depth == 0:
            return
        if direction[2] >= 1.0:
            frame = np.eye(3)
        elif direction[2] <= -1.0:
            frame = _axis_rotation((0.0, 1.0, 0.0), np.pi)
        else:
            axis = np.asarray([-direction[1], direction[0], 0.0])
            frame = _axis_rotation(axis / np.linalg.norm(axis), np.arccos(direction[2]))
        for d in dirs @ frame.T:
            grow(depth - 1, centre + d * (radius * 4.0 / 3.0), d, radius / 3.0)

    grow(int(size_factor), np.zeros(3), np.asarray([0.0, 0.0, 1.0]), 0.5)
    return np.asarray(centres), np.asarray(radii)


def sphereflake(size_factor: int = 4, stacks: int = 12, slices: int = 24) -> NodeGraph:
    """SPD's ``balls`` database, the sphereflake: 7,381 spheres at the
    default size factor 4 (3,897,530 triangles at 12 x 24 a sphere, with
    the ground and the lights) on a 24 x 24 ground quad at z = -0.5, seen
    from (2.1, 1.3, 1.7) toward the origin, z up, 45 degrees vertically.

    One node a sphere, the unit UV sphere under a ``TransformComponent``.
    The child layout (:func:`sphereflake_spheres`), the view, the lights
    and the surfaces are recalled from balls.c's NFF output, not read from
    its source. NFF's surfaces become Disney materials: the spheres' ``f 1
    0.9 0.7 0.5 0.5 3.0827 0 0`` (half diffuse, half mirror) base colour (1,
    0.9, 0.7), metallic 0.5, roughness 0.1; the ground's ``f 1 0.75 0.33 0.8
    0 100 0 0`` base colour 0.8 x (1, 0.75, 0.33), roughness 1. Each point
    light becomes an emitting sphere of radius 0.1 (6 x 12) whose radiance
    L gives unit irradiance at the origin (pi r^2 L = d^2, d its distance).
    The background becomes a constant environment, which, unlike NFF's,
    lights the scene."""
    g = NodeGraph()
    sph_pos, _, _, sph_idx = tessellate_sphere(1.0, stacks, slices)
    flake = Material(base_color=np.asarray([1.0, 0.9, 0.7], np.float32), metallic=0.5,
                     roughness=0.1)
    centres, radii = sphereflake_spheres(size_factor)
    for i, (c, r) in enumerate(zip(centres, radii)):
        m = np.eye(3, 4, dtype=np.float32)
        m[:, :3] *= np.float32(r)
        m[:, 3] = c
        n = g.root.add_child(f"sphere_{i}")
        n.make_component(TransformComponent(matrix=m))
        n.make_component(MeshPrimitive(positions=sph_pos, indices=sph_idx, material=flake))
    ground = g.root.add_child("ground")
    pos, idx = _quad(*SPD_GROUND)
    ground.make_component(MeshPrimitive(
        positions=pos, indices=idx,
        material=Material(base_color=np.asarray([0.8, 0.6, 0.264], np.float32))))
    lpos, _, _, lidx = tessellate_sphere(1.0, 6, 12)
    for i, p in enumerate(SPD_LIGHTS):
        m = np.eye(3, 4, dtype=np.float32)
        m[:, :3] *= np.float32(SPD_LIGHT_RADIUS)
        m[:, 3] = p
        radiance = float(np.dot(p, p)) / (np.pi * SPD_LIGHT_RADIUS ** 2)
        n = g.root.add_child(f"light_{i}")
        n.make_component(TransformComponent(matrix=m))
        n.make_component(MeshPrimitive(
            positions=lpos, indices=lidx,
            material=Material(base_color=np.zeros(3, np.float32),
                              emission=np.full(3, radiance, np.float32))))
    env = g.root.add_child("env")
    env.make_component(EnvironmentComponent(color=np.asarray(SPD_BACKGROUND, np.float32)))
    cam = g.root.add_child("camera")
    cam.make_component(TransformComponent(matrix=look_at(SPD_EYE, SPD_AT, SPD_UP)))
    cam.make_component(CameraComponent(fovy=np.radians(SPD_FOV_DEG)))
    return g
