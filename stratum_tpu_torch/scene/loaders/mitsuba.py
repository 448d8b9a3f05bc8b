"""Mitsuba XML scene loader, 0.x and 3.x dialects (counterpart of
stratum_tpu/scene/loaders/mitsuba.py, numpy only;
src/Node/loaders/load_mitsuba.cpp): transform parsing
(lookat/matrix/translate/rotate/scale, load_mitsuba.cpp:81-138), spectra ->
RGB via CIE integration (140-195), checkerboard/bitmap textures (197-292),
bsdf mapping onto Disney parameters incl. alpha->roughness and
shininess->roughness conversions (317-433), shapes obj/ply/serialized/
sphere/rectangle/cube with area emitters (434-589) and recursive scene
parsing with named-id references (592-651).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from stratum_tpu_torch.core.math import integrate_spectrum_to_rgb
from stratum_tpu_torch.scene.graph import (
    CameraComponent,
    EnvironmentComponent,
    MeshPrimitive,
    Node,
    SpherePrimitive,
    TransformComponent,
)
from stratum_tpu_torch.scene.material import Material


# ---------------------------------------------------------------------------
# value parsing
# ---------------------------------------------------------------------------

def parse_spectrum(text: str) -> np.ndarray:
    """'0.5' | '0.2 0.3 0.4' | '400:0.2, 500:0.8' -> linear rgb
    (load_mitsuba.cpp:140-195)."""
    text = text.strip()
    if ":" in text:
        pairs = [p.split(":") for p in text.replace(",", " ").split()]
        wl = np.asarray([float(a) for a, _ in pairs], np.float32)
        vals = np.asarray([float(b) for _, b in pairs], np.float32)
        return integrate_spectrum_to_rgb(wl, vals)
    vals = [float(x) for x in text.replace(",", " ").split()]
    if len(vals) == 1:
        return np.full(3, vals[0], np.float32)
    return np.asarray(vals[:3], np.float32)


def _parse_transform(elem) -> np.ndarray:
    """<transform> children applied in document order
    (load_mitsuba.cpp:81-138)."""
    from stratum_tpu_torch.scene.graph import _compose_np

    m = np.eye(3, 4, dtype=np.float32)
    for child in elem:
        tag = child.tag
        t = np.eye(3, 4, dtype=np.float32)
        if tag in ("lookat", "lookAt", "look_at"):
            origin = np.asarray(
                [float(x) for x in child.get("origin").replace(",", " ").split()],
                np.float32,
            )
            target = np.asarray(
                [float(x) for x in child.get("target").replace(",", " ").split()],
                np.float32,
            )
            up = np.asarray(
                [
                    float(x)
                    for x in (child.get("up") or "0 1 0").replace(",", " ").split()
                ],
                np.float32,
            )
            fwd = target - origin
            fwd /= max(np.linalg.norm(fwd), 1e-12)
            right = np.cross(up, fwd)
            right /= max(np.linalg.norm(right), 1e-12)
            true_up = np.cross(fwd, right)
            t[:, 0] = right
            t[:, 1] = true_up
            t[:, 2] = fwd
            t[:, 3] = origin
        elif tag == "matrix":
            vals = [float(x) for x in child.get("value").replace(",", " ").split()]
            if len(vals) == 16:
                t = np.asarray(vals, np.float32).reshape(4, 4)[:3, :4]
            else:
                t[:, :3] = np.asarray(vals, np.float32).reshape(3, 3)
        elif tag == "translate":
            t[:, 3] = _xyz(child, 0.0)
        elif tag == "scale":
            if child.get("value") is not None:
                t[:, :3] = np.eye(3) * float(child.get("value"))
            else:
                t[:, :3] = np.diag(_xyz(child, 1.0))
        elif tag == "rotate":
            axis = _xyz(child, 0.0)
            axis /= max(np.linalg.norm(axis), 1e-12)
            ang = np.radians(float(child.get("angle", 0.0)))
            c, s = np.cos(ang), np.sin(ang)
            x, y, z = axis
            t[:, :3] = np.asarray(
                [
                    [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
                    [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
                    [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
                ],
                np.float32,
            )
        else:
            continue
        m = _compose_np(t, m)
    return m


def _xyz(elem, default: float) -> np.ndarray:
    if elem.get("value") is not None:
        vals = [float(v) for v in elem.get("value").replace(",", " ").split()]
        if len(vals) == 3:
            return np.asarray(vals, np.float32)
        return np.full(3, vals[0], np.float32)
    return np.asarray(
        [float(elem.get(k, default)) for k in ("x", "y", "z")], np.float32
    )


def _props(elem) -> dict:
    """Collect child <float/integer/string/boolean/rgb/spectrum/srgb> props."""
    out = {}
    for c in elem:
        name = c.get("name")
        if name is None:
            continue
        if c.tag == "float":
            out[name] = float(c.get("value"))
        elif c.tag == "integer":
            out[name] = int(c.get("value"))
        elif c.tag in ("string", "boolean"):
            out[name] = c.get("value")
        elif c.tag in ("rgb", "srgb", "color"):
            out[name] = parse_spectrum(c.get("value"))
        elif c.tag == "spectrum":
            out[name] = parse_spectrum(c.get("value"))
    return out


# ---------------------------------------------------------------------------
# textures & bsdfs
# ---------------------------------------------------------------------------

def _checkerboard(c0, c1, res: int = 256) -> np.ndarray:
    img = np.empty((res, res, 3), np.float32)
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    mask = ((xx * 2 // res) + (yy * 2 // res)) % 2 == 0
    img[mask] = c0
    img[~mask] = c1
    return img


def _texture_image(elem, base: Path) -> np.ndarray | None:
    """<texture type="bitmap|checkerboard"> (load_mitsuba.cpp:197-292)."""
    ttype = elem.get("type")
    p = _props(elem)
    if ttype == "bitmap":
        fn = p.get("filename")
        if fn and (base / fn).exists():
            from stratum_tpu_torch.io.image import load_image

            return load_image(base / fn)
        return None
    if ttype == "checkerboard":
        c0 = p.get("color0", np.full(3, 0.4, np.float32))
        c1 = p.get("color1", np.full(3, 0.2, np.float32))
        return _checkerboard(np.asarray(c0), np.asarray(c1))
    return None


def _build_bsdf(elem, base: Path, named: dict) -> Material:
    """Map mitsuba bsdfs onto Disney parameters
    (load_mitsuba.cpp:317-433)."""
    btype = elem.get("type")
    if btype in ("twosided", "mask", "bumpmap", "normalmap"):
        inner = elem.find("bsdf")
        if inner is not None:
            return _build_bsdf(inner, base, named)
        ref = elem.find("ref")
        if ref is not None:
            return named[ref.get("id")]
        return Material()
    p = _props(elem)
    m = Material(name=elem.get("id", btype or ""))

    def tex_or_rgb(key, default):
        val = p.get(key, default)
        for t in elem.findall("texture"):
            if t.get("name") == key:
                img = _texture_image(t, base)
                if img is not None:
                    m.base_color_image = img
                    return np.ones(3, np.float32)
        return np.asarray(val, np.float32)

    alpha = float(p.get("alpha", 0.1))
    if btype == "diffuse":
        m.base_color = tex_or_rgb("reflectance", np.full(3, 0.5, np.float32))
        m.roughness = 1.0
    elif btype in ("plastic", "roughplastic"):
        m.base_color = tex_or_rgb(
            "diffuseReflectance",
            p.get("diffuse_reflectance", np.full(3, 0.5, np.float32)),
        )
        # alpha -> roughness = sqrt(alpha) (material_convert.hlsl:29-50)
        m.roughness = float(np.sqrt(alpha)) if btype == "roughplastic" else 0.1
        m.clearcoat = 1.0
        m.clearcoat_gloss = 1.0 - m.roughness
        m.eta = float(p.get("intIOR", 1.49)) / float(p.get("extIOR", 1.0))
    elif btype in ("dielectric", "roughdielectric", "thindielectric"):
        m.base_color = np.ones(3, np.float32)
        m.transmission = 1.0
        m.roughness = float(np.sqrt(alpha)) if btype == "roughdielectric" else 0.02
        int_ior = p.get("intIOR", 1.5046)
        ext_ior = p.get("extIOR", 1.000277)
        m.eta = float(int_ior) / float(ext_ior)
    elif btype in ("conductor", "roughconductor"):
        m.base_color = np.asarray(
            p.get("specularReflectance", p.get("specular_reflectance", np.ones(3))),
            np.float32,
        )
        m.metallic = 1.0
        m.roughness = float(np.sqrt(alpha)) if btype == "roughconductor" else 0.02
    else:
        m.base_color = tex_or_rgb("reflectance", np.full(3, 0.5, np.float32))
    return m


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

def _unit_rectangle():
    pos = np.asarray(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32
    )
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return pos, idx


def _unit_cube():
    from stratum_tpu_torch.scene.builtin import _box

    return _box((-1, -1, -1), (1, 1, 1))


def load_mitsuba(parent: Node, path) -> Node:
    path = Path(path)
    base = path.parent
    tree = ET.parse(path)
    scene_elem = tree.getroot()
    root = parent.add_child(path.stem)
    named: dict[str, Material] = {}

    for elem in scene_elem:
        if elem.tag == "bsdf" and elem.get("id"):
            named[elem.get("id")] = _build_bsdf(elem, base, named)

    def shape_material(elem) -> Material:
        ref = elem.find("ref")
        if ref is not None and ref.get("id") in named:
            return named[ref.get("id")]
        b = elem.find("bsdf")
        if b is not None:
            return _build_bsdf(b, base, named)
        return Material()

    shape_count = 0
    for elem in scene_elem:
        if elem.tag == "sensor" or elem.tag == "camera":
            p = _props(elem)
            fov = float(p.get("fov", 45.0))
            node = root.add_child("sensor")
            tf = elem.find("transform")
            if tf is not None:
                node.make_component(TransformComponent(matrix=_parse_transform(tf)))
            # mitsuba fov defaults to the x axis; treat as yfov for parity
            node.make_component(CameraComponent(fovy=np.radians(fov)))
        elif elem.tag == "emitter":
            etype = elem.get("type")
            p = _props(elem)
            if etype in ("envmap", "constant"):
                node = root.add_child("environment")
                img = None
                if etype == "envmap" and p.get("filename"):
                    fn = base / p["filename"]
                    if fn.exists():
                        from stratum_tpu_torch.io.image import load_image

                        img = load_image(fn)[..., :3]
                color = np.asarray(
                    p.get("radiance", np.ones(3, np.float32)), np.float32
                ) * float(p.get("scale", 1.0))
                node.make_component(
                    EnvironmentComponent(
                        color=color, image=img,
                        source_path=(
                            str(base / p["filename"])
                            if img is not None else None
                        ),
                    )
                )
        elif elem.tag == "shape":
            stype = elem.get("type")
            mat = shape_material(elem)
            # area emitter attached to the shape (load_mitsuba.cpp:434-589)
            em = elem.find("emitter")
            if em is not None and em.get("type") == "area":
                ep = _props(em)
                import dataclasses as _dc

                mat = _dc.replace(
                    mat,
                    emission=np.asarray(
                        ep.get("radiance", np.ones(3)), np.float32
                    ),
                )
            p = _props(elem)
            node = root.add_child(f"shape_{shape_count}")
            shape_count += 1
            tf = elem.find("transform")
            if tf is not None:
                node.make_component(
                    TransformComponent(matrix=_parse_transform(tf))
                )
            if stype == "obj" and p.get("filename"):
                from stratum_tpu_torch.scene.loaders.obj import load_obj_meshes

                for mesh in load_obj_meshes(base / p["filename"]):
                    c = node.add_child(mesh.name)
                    c.make_component(
                        MeshPrimitive(
                            positions=mesh.positions,
                            indices=mesh.indices,
                            normals=mesh.normals,
                            uvs=mesh.uvs,
                            material=mat,
                        )
                    )
            elif stype == "ply" and p.get("filename"):
                from stratum_tpu_torch.scene.loaders.ply import load_ply_mesh

                pos, nrm, uv, idx = load_ply_mesh(base / p["filename"])
                node.make_component(
                    MeshPrimitive(
                        positions=pos, indices=idx, normals=nrm, uvs=uv,
                        material=mat,
                    )
                )
            elif stype == "serialized" and p.get("filename"):
                from stratum_tpu_torch.scene.loaders.serialized import (
                    load_serialized_mesh,
                )

                pos, nrm, uv, idx = load_serialized_mesh(
                    base / p["filename"], int(p.get("shapeIndex", 0))
                )
                node.make_component(
                    MeshPrimitive(
                        positions=pos, indices=idx, normals=nrm, uvs=uv,
                        material=mat,
                    )
                )
            elif stype == "sphere":
                radius = float(p.get("radius", 1.0))
                center = elem.find("point")
                if center is not None:
                    t = np.eye(3, 4, dtype=np.float32)
                    t[:, 3] = _xyz(center, 0.0)
                    if node.find(TransformComponent) is None:
                        node.make_component(TransformComponent(matrix=t))
                node.make_component(
                    SpherePrimitive(radius=radius, material=mat)
                )
            elif stype == "rectangle":
                pos, idx = _unit_rectangle()
                node.make_component(
                    MeshPrimitive(positions=pos, indices=idx, material=mat)
                )
            elif stype == "cube":
                pos, idx = _unit_cube()
                node.make_component(
                    MeshPrimitive(positions=pos, indices=idx, material=mat)
                )
    return root
