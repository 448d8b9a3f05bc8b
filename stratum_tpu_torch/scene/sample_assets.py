"""Authored sample assets written to disk as real interchange files
(counterpart of stratum_tpu/scene/sample_assets.py; the files it writes are
byte for byte the reference's).

Baseline config 4 of the reference benchmarks a Sponza-class textured hall
under an environment map loaded from files (BASELINE.md; reference loaders
src/Node/loaders/load_gltf.cpp + environment.h:48-93). With zero network
egress the original Sponza cannot be vendored, so this module AUTHORS a
comparable asset — a colonnaded hall with procedural stone/brick/marble
textures — and writes it as OBJ + MTL + PNG + HDR. Tests and bench.py then
load it through the real file loaders (scene/loaders/obj.py, io/image.py),
exercising exactly the path an external asset would: MTL texture
references, sRGB decode, mip stack build, env-map importance sampling.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


# ---------------------------------------------------------------------------
# procedural textures


def _marble(res: int, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:res, 0:res].astype(np.float32) / res
    v = np.zeros((res, res), np.float32)
    for octv in range(1, 5):
        f = 2.0**octv
        ph = rng.uniform(0, 2 * np.pi, 2)
        v += np.sin(2 * np.pi * f * x + ph[0]) * np.cos(
            2 * np.pi * f * y + ph[1]
        ) / f
    veins = 0.5 + 0.5 * np.sin(14.0 * (x + y) + 4.0 * v)
    base = 0.75 + 0.2 * veins
    rgb = np.stack([base, base * 0.98, base * 0.94], axis=-1)
    return np.clip(rgb, 0.0, 1.0)


def _brick(res: int) -> np.ndarray:
    y, x = np.mgrid[0:res, 0:res].astype(np.float32) / res
    rows = np.floor(y * 8.0)
    xx = x + np.where(rows % 2 == 0, 0.0, 0.5 / 4.0)
    fx = (xx * 4.0) % 1.0
    fy = (y * 8.0) % 1.0
    mortar = (fx < 0.06) | (fy < 0.12)
    tone = 0.55 + 0.12 * np.sin(40.0 * x) * np.sin(24.0 * y)
    brick = np.stack([tone, tone * 0.55, tone * 0.42], axis=-1)
    grey = np.full_like(brick, 0.62)
    return np.where(mortar[..., None], grey, brick)


def _stone(res: int, seed: int = 11) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:res, 0:res].astype(np.float32) / res
    bands = 0.6 + 0.12 * np.sin(2 * np.pi * 9.0 * y)
    n = rng.standard_normal((res // 8, res // 8)).astype(np.float32)
    n = np.kron(n, np.ones((8, 8), np.float32))[:res, :res]
    v = np.clip(bands + 0.05 * n, 0.0, 1.0)
    return np.stack([v, v * 0.96, v * 0.9], axis=-1)


def _sky_env(width: int = 256) -> np.ndarray:
    """Equirect HDR: blue gradient sky + a small hot sun disk — peaked
    enough that env importance sampling visibly matters."""
    h = width // 2
    y, x = np.mgrid[0:h, 0:width].astype(np.float32)
    theta = (y + 0.5) / h * np.pi  # 0 = up
    phi = (x + 0.5) / width * 2 * np.pi
    up = np.cos(theta)
    sky = np.stack(
        [
            0.20 + 0.1 * up,
            0.35 + 0.25 * np.clip(up, 0, 1),
            0.65 + 0.3 * np.clip(up, 0, 1),
        ],
        axis=-1,
    ) * 0.6
    ground = np.stack([0.18 + 0 * up, 0.15 + 0 * up, 0.12 + 0 * up], axis=-1)
    img = np.where(up[..., None] > 0.0, sky, ground)
    # sun at ~35 degrees elevation
    sun_dir = np.array([np.cos(0.6) * np.cos(1.1), np.sin(0.6),
                        np.cos(0.6) * np.sin(1.1)])
    d = np.stack(
        [np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi)],
        axis=-1,
    )
    cosang = d @ sun_dir
    sun = np.clip((cosang - 0.9995) / 0.0005, 0.0, 1.0)[..., None]
    img = img + sun * np.array([900.0, 800.0, 600.0])
    return img.astype(np.float32)


# ---------------------------------------------------------------------------
# geometry


def _cylinder(cx, cz, r, y0, y1, seg, rings):
    """Open cylinder wall: positions/normals/uvs/tris."""
    vs, ns, ts, tris = [], [], [], []
    for j in range(rings + 1):
        y = y0 + (y1 - y0) * j / rings
        for i in range(seg + 1):
            a = 2 * np.pi * i / seg
            nx, nz = np.cos(a), np.sin(a)
            vs.append((cx + r * nx, y, cz + r * nz))
            ns.append((nx, 0.0, nz))
            ts.append((3.0 * i / seg, 2.0 * j / rings))
    w = seg + 1
    for j in range(rings):
        for i in range(seg):
            a = j * w + i
            b = a + 1
            c = a + w
            d = c + 1
            tris.append((a, c, b))
            tris.append((b, c, d))
    return np.asarray(vs, np.float32), np.asarray(ns, np.float32), np.asarray(
        ts, np.float32
    ), np.asarray(tris, np.int64)


def _quad(p0, p1, p2, p3, uv_scale=(1.0, 1.0), subdiv=1):
    """Subdivided quad patch (p0..p3 CCW)."""
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    vs, ts, tris = [], [], []
    for j in range(subdiv + 1):
        for i in range(subdiv + 1):
            u, v = i / subdiv, j / subdiv
            p = (1 - v) * ((1 - u) * p0 + u * p1) + v * ((1 - u) * p3 + u * p2)
            vs.append(p)
            ts.append((u * uv_scale[0], v * uv_scale[1]))
    w = subdiv + 1
    for j in range(subdiv):
        for i in range(subdiv):
            a = j * w + i
            tris.append((a, a + 1, a + w + 1))
            tris.append((a, a + w + 1, a + w))
    vs = np.asarray(vs, np.float32)
    n = np.cross(p1 - p0, p3 - p0)
    n = n / max(np.linalg.norm(n), 1e-9)
    ns = np.tile(n[None, :], (len(vs), 1)).astype(np.float32)
    return vs, ns, np.asarray(ts, np.float32), np.asarray(tris, np.int64)


def write_colonnade(
    out_dir, columns: int = 14, seg: int = 48, rings: int = 40,
    tex_res: int = 256, env_res: int = 256,
) -> dict:
    """Write the colonnade asset. Returns paths + a suggested camera.

    Default tessellation: 2 rows x ``columns`` columns x (seg*rings*2) tris
    ~ 107K triangles + walls/floor — a Sponza-class count through the OBJ
    loader. The hall is open to the sky between the side walls, so the sun
    env drives direct light and the columns cast real shadows.
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    from stratum_tpu_torch.io.image import save_image

    save_image(out / "floor.png", _marble(tex_res))
    save_image(out / "wall.png", _brick(tex_res))
    save_image(out / "column.png", _stone(tex_res))
    save_image(out / "sky.hdr", _sky_env(env_res))

    hall_l, hall_w, wall_h = 40.0, 12.0, 8.0
    col_h, col_r = 6.0, 0.45

    parts = []  # (material, vs, ns, ts, tris)
    # floor (tiled marble)
    parts.append(("floor",) + _quad(
        (-hall_l / 2, 0, -hall_w / 2), (hall_l / 2, 0, -hall_w / 2),
        (hall_l / 2, 0, hall_w / 2), (-hall_l / 2, 0, hall_w / 2),
        uv_scale=(16.0, 5.0), subdiv=8,
    ))
    # side walls (brick), facing inward
    parts.append(("wall",) + _quad(
        (-hall_l / 2, 0, -hall_w / 2), (-hall_l / 2, wall_h, -hall_w / 2),
        (hall_l / 2, wall_h, -hall_w / 2), (hall_l / 2, 0, -hall_w / 2),
        uv_scale=(12.0, 3.0), subdiv=4,
    ))
    parts.append(("wall",) + _quad(
        (hall_l / 2, 0, hall_w / 2), (hall_l / 2, wall_h, hall_w / 2),
        (-hall_l / 2, wall_h, hall_w / 2), (-hall_l / 2, 0, hall_w / 2),
        uv_scale=(12.0, 3.0), subdiv=4,
    ))
    # end wall
    parts.append(("wall",) + _quad(
        (hall_l / 2, 0, -hall_w / 2), (hall_l / 2, wall_h, -hall_w / 2),
        (hall_l / 2, wall_h, hall_w / 2), (hall_l / 2, 0, hall_w / 2),
        uv_scale=(4.0, 3.0), subdiv=2,
    ))
    # two rows of columns
    xs = np.linspace(-hall_l / 2 + 2.5, hall_l / 2 - 2.5, columns)
    for cx in xs:
        for cz in (-hall_w / 2 + 1.5, hall_w / 2 - 1.5):
            parts.append(("column",) + _cylinder(
                cx, cz, col_r, 0.0, col_h, seg, rings
            ))
            # capital: wider short cylinder
            parts.append(("column",) + _cylinder(
                cx, cz, col_r * 1.5, col_h, col_h + 0.4, seg // 2, 2
            ))

    mtl = out / "colonnade.mtl"
    mtl.write_text(
        "newmtl floor\nKd 1 1 1\nmap_Kd floor.png\n\n"
        "newmtl wall\nKd 1 1 1\nmap_Kd wall.png\n\n"
        "newmtl column\nKd 1 1 1\nmap_Kd column.png\n"
    )
    lines = ["mtllib colonnade.mtl"]
    base = 1
    ntris = 0
    for mat, vs, ns, ts, tris in parts:
        lines.append(f"o part{base}")
        lines.append(f"usemtl {mat}")
        for p in vs:
            lines.append(f"v {p[0]:.5g} {p[1]:.5g} {p[2]:.5g}")
        for t in ts:
            lines.append(f"vt {t[0]:.5g} {t[1]:.5g}")
        for nrm in ns:
            lines.append(f"vn {nrm[0]:.4g} {nrm[1]:.4g} {nrm[2]:.4g}")
        for a, b, c in tris:
            lines.append(
                f"f {base+a}/{base+a}/{base+a} {base+b}/{base+b}/{base+b} "
                f"{base+c}/{base+c}/{base+c}"
            )
        base += len(vs)
        ntris += len(tris)
    (out / "colonnade.obj").write_text("\n".join(lines) + "\n")

    eye = np.asarray([-hall_l / 2 + 1.0, 2.6, 0.0], np.float32)
    target = np.asarray([hall_l / 2, 2.0, 0.0], np.float32)
    return dict(
        obj=out / "colonnade.obj",
        env=out / "sky.hdr",
        eye=eye,
        target=target,
        fovy=np.radians(55.0),
        num_triangles=ntris,
    )


def load_colonnade(out_dir, **kw):
    """Write + load the asset through the REAL file loaders.
    Returns (NodeGraph, info dict)."""
    info = write_colonnade(out_dir, **kw)
    return colonnade_graph(info), info


def colonnade_graph(info: dict):
    """The node graph of a written colonnade (``write_colonnade``'s info):
    the OBJ through its loader, the HDR sky as the environment, the
    suggested camera."""
    from stratum_tpu_torch.core import transform as xform
    from stratum_tpu_torch.io.image import load_image
    from stratum_tpu_torch.scene.graph import (
        CameraComponent,
        EnvironmentComponent,
        NodeGraph,
        TransformComponent,
    )
    from stratum_tpu_torch.scene.loaders.obj import load_obj

    g = NodeGraph()
    load_obj(g.root, info["obj"])
    env = g.root.add_child("sky")
    env.make_component(
        EnvironmentComponent(
            color=np.ones(3, np.float32),
            image=load_image(info["env"], srgb=False)[..., :3],
            source_path=str(info["env"]),
        )
    )
    cam = g.root.add_child("camera")
    c2w = np.asarray(xform.look_at(info["eye"], info["target"]))
    cam.make_component(TransformComponent(matrix=c2w.astype(np.float32)))
    cam.make_component(CameraComponent(fovy=float(info["fovy"])))
    return g
