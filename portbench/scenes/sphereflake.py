"""SPD's sphereflake, frozen: Eric Haines' ``balls`` database of the
Standard Procedural Databases (IEEE CG&A 7(11), 1987) at size factor 4,
7,381 spheres on a ground quad under three point lights.

A copy, in numpy alone, of the scene the port's
``scene/builtin.py::sphereflake`` builds, so a later change to the program
cannot move the yardstick: the same sphere layout in the same order, each
sphere the unit UV sphere of :func:`portbench.scenes.atrium.sphere` under
its own 3x4 matrix. The layout, the view, the lights and the surfaces are
as recalled from balls.c's NFF output (the configuration file lists them
under ``assumed``). ``seed`` is not used here.
"""

from __future__ import annotations

import numpy as np

from portbench.scenes.atrium import _material, look_at, quad, sphere

GROUND = ((12.0, 12.0, -0.5), (-12.0, 12.0, -0.5), (-12.0, -12.0, -0.5), (12.0, -12.0, -0.5))
LIGHTS = ((4.0, 3.0, 2.0), (1.0, -4.0, 4.0), (-3.0, 1.0, 5.0))
LIGHT_RADIUS = 0.1
BACKGROUND = (0.078, 0.361, 0.753)


def _rotation(axis, angle: float) -> np.ndarray:
    a = np.asarray(axis, np.float64)
    k = np.asarray([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
    return np.eye(3) + np.sin(angle) * k + (1.0 - np.cos(angle)) * (k @ k)


def directions() -> np.ndarray:
    """The nine child directions about +z: six on the equator, three above
    at 54.7 degrees (three cuboctahedron corners, their face normal (1, 1,
    1) turned onto +z, at 0, 120 and 240 degrees about +z)."""
    s = 1.0 / np.sqrt(2.0)
    trio = np.asarray([[s, s, 0.0], [s, 0.0, -s], [0.0, s, -s]])
    trio = trio @ _rotation(np.asarray([1.0, -1.0, 0.0]) * s, np.arccos(1.0 / np.sqrt(3.0))).T
    return np.concatenate([trio @ _rotation((0.0, 0.0, 1.0), k * 2.0 * np.pi / 3.0).T
                           for k in range(3)])


def spheres(size_factor: int):
    """(centres [N, 3] f64, radii [N] f64) in balls.c's output order: a
    sphere, then each child's subtree; a child has a third of its parent's
    radius, touches it, and its own children turn to face away from it."""
    dirs = directions()
    centres, radii = [], []

    def grow(depth, centre, direction, radius):
        centres.append(centre)
        radii.append(radius)
        if depth == 0:
            return
        if direction[2] >= 1.0:
            frame = np.eye(3)
        elif direction[2] <= -1.0:
            frame = _rotation((0.0, 1.0, 0.0), np.pi)
        else:
            axis = np.asarray([-direction[1], direction[0], 0.0])
            frame = _rotation(axis / np.linalg.norm(axis), np.arccos(direction[2]))
        for d in dirs @ frame.T:
            grow(depth - 1, centre + d * (radius * 4.0 / 3.0), d, radius / 3.0)

    grow(int(size_factor), np.zeros(3), np.asarray([0.0, 0.0, 1.0]), 0.5)
    return np.asarray(centres), np.asarray(radii)


def _placed(centre, radius) -> np.ndarray:
    m = np.eye(3, 4, dtype=np.float32)
    m[:, :3] *= np.float32(radius)
    m[:, 3] = centre
    return m


def build(params: dict, seed: int, workdir) -> dict:
    """The scene as plain arrays (the atrium module's layout): the spheres
    in order, the ground, the three light spheres, the environment colour
    and the camera."""
    sph_pos, sph_idx = sphere(int(params.get("stacks", 12)), int(params.get("slices", 24)))
    flake = _material((1.0, 0.9, 0.7), metallic=0.5, roughness=0.1)
    meshes = []
    centres, radii = spheres(int(params.get("size_factor", 4)))
    for i, (c, r) in enumerate(zip(centres, radii)):
        meshes.append(dict(name=f"sphere_{i}", positions=sph_pos, indices=sph_idx,
                           material=flake, matrix=_placed(c, r)))
    pos, idx = quad(*GROUND)
    meshes.append(dict(name="ground", positions=pos, indices=idx,
                       material=_material((0.8, 0.6, 0.264)), matrix=None))
    lpos, lidx = sphere(6, 12)
    for i, p in enumerate(LIGHTS):
        radiance = float(np.dot(p, p)) / (np.pi * LIGHT_RADIUS ** 2)
        meshes.append(dict(name=f"light_{i}", positions=lpos, indices=lidx,
                           material=_material((0.0, 0.0, 0.0), emission=(radiance,) * 3),
                           matrix=_placed(p, LIGHT_RADIUS)))
    cam = params.get("camera", {})
    return dict(
        meshes=meshes,
        environment=[float(x) for x in np.float32(BACKGROUND)],
        camera=dict(
            camera_to_world=look_at(cam.get("eye", (2.1, 1.3, 1.7)),
                                    cam.get("target", (0.0, 0.0, 0.0)),
                                    cam.get("up", (0.0, 0.0, 1.0))),
            fovy=float(np.radians(cam.get("fovy_deg", 45.0))),
        ),
    )
