"""glTF 2.0 loader (.gltf / .glb), numpy + json + struct only (counterpart
of stratum_tpu/scene/loaders/gltf.py; src/Node/loaders/load_gltf.cpp):
buffers/accessors -> numpy (load_gltf.cpp:74-82), sRGB-aware images
(31-65), materials via the metallic-roughness conversion incl.
KHR_materials_ior / transmission / clearcoat / emissive_strength extras
(86-100+), node transform hierarchy and cameras; ``flatten`` bakes the
host MeshPrimitives into the device scene.

Images, embedded (a buffer view or a data URI) or by file URI, decode
through ``io.image.decode_ldr``: PNG with the package's own decoder,
another format with PIL where it imports. An image that cannot be decoded
raises; the reference returns None for it, which renders the material
untextured.
"""

from __future__ import annotations

import base64
import json
import struct
from pathlib import Path

import numpy as np

from stratum_tpu_torch.scene.graph import (
    CameraComponent,
    MeshPrimitive,
    Node,
    TransformComponent,
)
from stratum_tpu_torch.scene.material import Material

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT4": 16,
}


class _Gltf:
    def __init__(self, path: Path):
        self.path = path
        data = path.read_bytes()
        self.glb_bin = None
        if data[:4] == b"glTF":  # GLB container
            _, _, length = struct.unpack_from("<4sII", data, 0)
            off = 12
            doc = None
            while off < length:
                clen, ctype = struct.unpack_from("<II", data, off)
                chunk = data[off + 8 : off + 8 + clen]
                if ctype == 0x4E4F534A:  # JSON
                    doc = json.loads(chunk)
                elif ctype == 0x004E4942:  # BIN
                    self.glb_bin = chunk
                off += 8 + clen
            self.doc = doc
        else:
            self.doc = json.loads(data)
        self._buffers: dict[int, bytes] = {}

    def buffer(self, i: int) -> bytes:
        if i not in self._buffers:
            b = self.doc["buffers"][i]
            uri = b.get("uri")
            if uri is None:
                self._buffers[i] = self.glb_bin
            elif uri.startswith("data:"):
                self._buffers[i] = base64.b64decode(uri.split(",", 1)[1])
            else:
                from urllib.parse import unquote

                self._buffers[i] = (self.path.parent / unquote(uri)).read_bytes()
        return self._buffers[i]

    def accessor(self, i: int) -> np.ndarray:
        a = self.doc["accessors"][i]
        dtype = _COMPONENT_DTYPES[a["componentType"]]
        ncomp = _TYPE_COUNTS[a["type"]]
        count = a["count"]
        if "bufferView" not in a:
            return np.zeros((count, ncomp), dtype)
        bv = self.doc["bufferViews"][a["bufferView"]]
        raw = self.buffer(bv["buffer"])
        start = bv.get("byteOffset", 0) + a.get("byteOffset", 0)
        itemsize = np.dtype(dtype).itemsize * ncomp
        stride = bv.get("byteStride", itemsize)
        if stride == itemsize:
            arr = np.frombuffer(
                raw, dtype, count=count * ncomp, offset=start
            ).reshape(count, ncomp)
        else:
            out = np.empty((count, ncomp), dtype)
            for k in range(count):
                out[k] = np.frombuffer(
                    raw, dtype, count=ncomp, offset=start + k * stride
                )
            arr = out
        if a.get("normalized") and dtype != np.float32:
            info = np.iinfo(dtype)
            arr = arr.astype(np.float32) / info.max
        return arr

    def image(self, i: int) -> np.ndarray:
        """Image ``i`` as float32 linear RGBA [H, W, 4] (sRGB decoded)."""
        from urllib.parse import unquote

        from stratum_tpu_torch.io.image import decode_ldr, load_image

        img = self.doc["images"][i]
        name = f"{self.path.name}: image {i}"
        if "uri" in img and not img["uri"].startswith("data:"):
            return np.asarray(load_image(self.path.parent / unquote(img["uri"])))
        if "uri" in img:
            raw = base64.b64decode(img["uri"].split(",", 1)[1])
        else:
            bv = self.doc["bufferViews"][img["bufferView"]]
            raw = self.buffer(bv["buffer"])[
                bv.get("byteOffset", 0) : bv.get("byteOffset", 0)
                + bv["byteLength"]
            ]
        return decode_ldr(raw, f"{name} ({img.get('mimeType', 'embedded')})")


def _build_material(g: _Gltf, mi, linear_cache) -> Material:
    """glTF pbrMetallicRoughness -> Disney
    (reference: make_metallic_roughness_material, Node/Scene.cpp:156-256,
    extension handling load_gltf.cpp:86-100)."""
    if mi is None:
        return Material(name="gltf_default")
    m = g.doc["materials"][mi]
    pbr = m.get("pbrMetallicRoughness", {})
    base = np.asarray(
        pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32
    )
    mat = Material(
        name=m.get("name", f"material_{mi}"),
        base_color=base[:3],
        metallic=float(pbr.get("metallicFactor", 1.0)),
        roughness=float(pbr.get("roughnessFactor", 1.0)),
    )
    emissive = np.asarray(m.get("emissiveFactor", [0, 0, 0]), np.float32)
    strength = (
        m.get("extensions", {})
        .get("KHR_materials_emissive_strength", {})
        .get("emissiveStrength", 1.0)
    )
    # legacy "emissionIntensity" extra handled like the reference
    # (load_gltf.cpp:88-89)
    strength = m.get("extras", {}).get("emissionIntensity", strength)
    mat.emission = emissive * float(strength)
    ext = m.get("extensions", {})
    if "KHR_materials_ior" in ext:
        mat.eta = float(ext["KHR_materials_ior"].get("ior", 1.5))
    if "KHR_materials_transmission" in ext:
        mat.transmission = float(
            ext["KHR_materials_transmission"].get("transmissionFactor", 0.0)
        )
    if "KHR_materials_clearcoat" in ext:
        cc = ext["KHR_materials_clearcoat"]
        mat.clearcoat = float(cc.get("clearcoatFactor", 0.0))
        mat.clearcoat_gloss = 1.0 - float(cc.get("clearcoatRoughnessFactor", 0.0))

    def tex_image(tex_info, srgb):
        if tex_info is None:
            return None
        ti = g.doc["textures"][tex_info["index"]]
        src = ti.get("source")
        if src is None:
            return None
        key = (src, srgb)
        if key not in linear_cache:
            img = g.image(src)
            if not srgb:
                # image() decodes as sRGB; undo for data textures (the
                # reference's approximate inverse)
                rgb = np.clip(img[..., :3], 0, 1) ** (1 / 2.4) * 1.055 - 0.055
                rgb = np.where(img[..., :3] <= 0.0031308, img[..., :3] * 12.92, rgb)
                img = np.concatenate([rgb, img[..., 3:]], axis=-1)
            linear_cache[key] = img
        return linear_cache[key]

    mat.base_color_image = tex_image(pbr.get("baseColorTexture"), True)
    mat.rough_metal_image = tex_image(pbr.get("metallicRoughnessTexture"), False)
    mat.emission_image = tex_image(m.get("emissiveTexture"), True)
    mat.normal_image = tex_image(m.get("normalTexture"), False)
    if m.get("alphaMode") == "MASK":
        mat.alpha_cutoff = float(m.get("alphaCutoff", 0.5))
        if mat.base_color_image is not None:
            mat.alpha_image = mat.base_color_image
    return mat


def _node_transform(n: dict) -> np.ndarray:
    if "matrix" in n:
        m = np.asarray(n["matrix"], np.float32).reshape(4, 4).T  # column-major
        return m[:3, :4]
    t = np.asarray(n.get("translation", [0, 0, 0]), np.float32)
    q = np.asarray(n.get("rotation", [0, 0, 0, 1]), np.float32)  # xyzw
    s = np.asarray(n.get("scale", [1, 1, 1]), np.float32)
    x, y, z, w = q
    rot = np.asarray(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )
    m = np.empty((3, 4), np.float32)
    m[:, :3] = rot * s[None, :]
    m[:, 3] = t
    return m


def load_gltf(parent: Node, path) -> Node:
    """Load a glTF scene under a new child node."""
    path = Path(path)
    g = _Gltf(path)
    doc = g.doc
    materials: dict = {}
    linear_cache: dict = {}

    def material(mi):
        if mi not in materials:
            materials[mi] = _build_material(g, mi, linear_cache)
        return materials[mi]

    root = parent.add_child(path.stem)

    def add_node(ni: int, parent_node: Node):
        n = doc["nodes"][ni]
        node = parent_node.add_child(n.get("name", f"node_{ni}"))
        node.make_component(TransformComponent(matrix=_node_transform(n)))
        if "mesh" in n:
            mesh = doc["meshes"][n["mesh"]]
            for pi, prim in enumerate(mesh.get("primitives", [])):
                if prim.get("mode", 4) != 4:  # triangles only
                    continue
                attrs = prim["attributes"]
                pos = g.accessor(attrs["POSITION"]).astype(np.float32)
                nrm = (
                    g.accessor(attrs["NORMAL"]).astype(np.float32)
                    if "NORMAL" in attrs
                    else None
                )
                uv = (
                    g.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                    if "TEXCOORD_0" in attrs
                    else None
                )
                if "indices" in prim:
                    idx = g.accessor(prim["indices"]).reshape(-1, 3).astype(np.int32)
                else:
                    idx = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
                child = node.add_child(f"prim_{pi}")
                child.make_component(
                    MeshPrimitive(
                        positions=pos,
                        indices=idx,
                        normals=nrm,
                        uvs=uv,
                        material=material(prim.get("material")),
                    )
                )
        if "camera" in n:
            cam = doc["cameras"][n["camera"]]
            if cam.get("type") == "perspective":
                # glTF cameras look down -Z; ours look down +Z — insert a
                # 180-degree Y flip child
                flip = node.add_child("camera_flip")
                m = np.diag([-1.0, 1.0, -1.0]).astype(np.float32)
                fm = np.concatenate(
                    [m, np.zeros((3, 1), np.float32)], axis=-1
                )
                flip.make_component(TransformComponent(matrix=fm))
                flip.make_component(
                    CameraComponent(
                        fovy=float(cam["perspective"].get("yfov", 1.0))
                    )
                )
        for ci in n.get("children", []):
            add_node(ci, node)

    scene_idx = doc.get("scene", 0)
    for ni in doc["scenes"][scene_idx]["nodes"]:
        add_node(ni, root)
    return root
