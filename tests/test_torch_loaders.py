"""The port's scene loaders (stratum_tpu_torch/scene/loaders: PLY, STL,
serialized, volumes, Mitsuba, glTF, FBX; core/math.py's spectra; the CLI's
scene dispatch) against the JAX package's on the same files, written in
place by the reference's writers and its tests' helpers
(tests/test_loaders.py, tests/test_gltf.py:15).

Bounds: none. Node trees, transforms, mesh arrays, volumes and spectra
are equal bit for bit (values and dtypes), materials field by field, and
a Mitsuba scene and a textured GLB flattened by both packages give equal
arrays. The glTF images go through the port's PNG decoder; the
reference's through PIL, which this machine has.
"""

import base64
import dataclasses
import json
import struct
import sys
import zlib

import numpy as np
import pytest

from stratum_tpu.core import math as jmath
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu.scene import graph as jgraph
from stratum_tpu.scene.loaders import fbx as jfbx
from stratum_tpu.scene.loaders import gltf as jgltf
from stratum_tpu.scene.loaders import mitsuba as jmitsuba
from stratum_tpu.scene.loaders import ply as jply
from stratum_tpu.scene.loaders import serialized as jser
from stratum_tpu.scene.loaders import stl as jstl
from stratum_tpu.scene.loaders import volumes as jvol
from stratum_tpu_torch import cli
from stratum_tpu_torch.core import math as pmath
from stratum_tpu_torch.io import image as pimage
from stratum_tpu_torch.scene import flatten as pflatten
from stratum_tpu_torch.scene import graph as pgraph
from stratum_tpu_torch.scene.loaders import fbx as pfbx
from stratum_tpu_torch.scene.loaders import gltf as pgltf
from stratum_tpu_torch.scene.loaders import mitsuba as pmitsuba
from stratum_tpu_torch.scene.loaders import ply as pply
from stratum_tpu_torch.scene.loaders import serialized as pser
from stratum_tpu_torch.scene.loaders import stl as pstl
from stratum_tpu_torch.scene.loaders import volumes as pvol
from stratum_tpu_torch.utils.flags import Options


def _equal(a, b, where):
    """Bit-for-bit equality of loader outputs: arrays (values and dtype),
    Materials field by field, tuples, scalars."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape,
                                                           b.shape)
        assert a.tobytes() == b.tobytes(), where
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            if f.name != "node":
                _equal(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        assert a == b and type(a) is type(b), (where, a, b)


def _same_tree(a, b, where="root"):
    """Node names, child order and every component field equal."""
    assert a.name == b.name, (where, a.name, b.name)
    assert [type(c).__name__ for c in a.components.values()] == [
        type(c).__name__ for c in b.components.values()], where
    for ca, cb in zip(a.components.values(), b.components.values()):
        _equal(ca, cb, f"{where}/{a.name}:{type(ca).__name__}")
    assert len(a.children) == len(b.children), (where, a.name)
    for x, y in zip(a.children, b.children):
        _same_tree(x, y, f"{where}/{a.name}")


def _both(load_j, load_p, path):
    """Each package's loader on the same file under a fresh graph."""
    jg, pg = jgraph.NodeGraph(), pgraph.NodeGraph()
    load_j(jg.root, path)
    load_p(pg.root, path)
    return jg, pg


# ---------------------------------------------------------------------------
# spectra
# ---------------------------------------------------------------------------

def test_spectra_bit_for_bit():
    grid = np.linspace(350.0, 800.0, 4501, dtype=np.float32)
    for name in ("cie_x_fit", "cie_y_fit", "cie_z_fit"):
        _equal(np.asarray(getattr(jmath, name)(grid)), getattr(pmath, name)(grid), name)
    rng = np.random.default_rng(7)
    for i in range(40):
        k = int(rng.integers(2, 12))
        wl = np.sort(rng.uniform(380, 720, k)).astype(np.float32)
        v = rng.uniform(0, 2, k).astype(np.float32)
        _equal(jmath.integrate_spectrum_to_rgb(wl, v), pmath.integrate_spectrum_to_rgb(wl, v),
               f"spectrum {i}")
    for text in ("0.5", "0.1 0.2 0.3", "0.1, 0.2, 0.3", "400:1.0, 700:1.0",
                 "400:0.2 500:0.8 650:0.1"):
        _equal(jmitsuba.parse_spectrum(text), pmitsuba.parse_spectrum(text), text)


# ---------------------------------------------------------------------------
# PLY, STL, serialized
# ---------------------------------------------------------------------------

def _ply(path, fmt, pos, faces, extra=()):
    """A PLY with float x y z (+ ``extra`` float columns) and ``uchar int``
    face lists; ``fmt`` ascii / binary_little_endian / binary_big_endian."""
    cols = ["x", "y", "z"] + [name for name, _ in extra]
    data = np.concatenate([pos] + [v for _, v in extra], axis=1).astype(np.float32)
    head = (f"ply\nformat {fmt} 1.0\nelement vertex {len(pos)}\n"
            + "".join(f"property float {c}\n" for c in cols)
            + f"element face {len(faces)}\nproperty list uchar int vertex_indices\n"
              "end_header\n")
    if fmt == "ascii":
        body = "".join(" ".join(f"{x:.9g}" for x in row) + "\n" for row in data)
        body += "".join(f"{len(f)} " + " ".join(map(str, f)) + "\n" for f in faces)
        path.write_bytes(head.encode() + body.encode())
        return
    e = "<" if fmt == "binary_little_endian" else ">"
    body = data.astype(e + "f4").tobytes()
    for f in faces:
        body += bytes([len(f)]) + np.asarray(f, e + "i4").tobytes()
    path.write_bytes(head.encode() + body)


def _grid_faces(n, quads):
    """Faces of an n x n vertex grid: quads, or two triangles a cell."""
    faces = []
    for y in range(n - 1):
        for x in range(n - 1):
            a, b, c, d = y * n + x, y * n + x + 1, (y + 1) * n + x + 1, (y + 1) * n + x
            faces += [[a, b, c, d]] if quads else [[a, b, c], [a, c, d]]
    return faces


@pytest.mark.parametrize("case", ["triangles", "quads", "mixed", "big_endian", "ascii",
                                  "normals_uvs"])
def test_ply_matches_reference(tmp_path, case):
    """The binary triangle and quad files take the port's one-read face
    path, the mixed file (triangles, quads and a pentagon) the loop; all
    equal the reference's loader bit for bit."""
    rng = np.random.default_rng(3)
    n = 9
    pos = rng.normal(size=(n * n, 3)).astype(np.float32)
    faces = _grid_faces(n, quads=case == "quads")
    extra = ()
    fmt = {"big_endian": "binary_big_endian", "ascii": "ascii"}.get(case,
                                                                    "binary_little_endian")
    if case == "mixed":
        faces = _grid_faces(n, True)[:20] + _grid_faces(n, False)[40:] + [[0, 1, 2, 11, 10]]
    if case == "normals_uvs":
        extra = (("nx", rng.normal(size=(n * n, 1))), ("ny", rng.normal(size=(n * n, 1))),
                 ("nz", rng.normal(size=(n * n, 1))), ("u", rng.random((n * n, 1))),
                 ("v", rng.random((n * n, 1))))
    p = tmp_path / f"{case}.ply"
    _ply(p, fmt, pos, faces, extra)
    want = jply.load_ply_mesh(p)
    got = pply.load_ply_mesh(p)
    _equal(want, got, case)
    assert got[3].shape == (sum(len(f) - 2 for f in faces), 3)


@pytest.mark.parametrize("kind", ["binary", "ascii"])
def test_stl_matches_reference(tmp_path, kind):
    rng = np.random.default_rng(4)
    tris = rng.normal(size=(24, 3, 3)).astype(np.float32)
    tris[1::2, 0] = tris[0::2, 0]  # shared corners: the dedup path
    normals = rng.normal(size=(24, 3)).astype(np.float32)
    p = tmp_path / f"m_{kind}.stl"
    if kind == "binary":
        buf = b"\x00" * 80 + struct.pack("<I", len(tris))
        for nrm, t in zip(normals, tris):
            buf += nrm.tobytes() + t.tobytes() + b"\x00\x00"
        p.write_bytes(buf)
    else:
        lines = ["solid m"]
        for nrm, t in zip(normals, tris):
            lines += [f"facet normal {nrm[0]:.9g} {nrm[1]:.9g} {nrm[2]:.9g}", "outer loop"]
            lines += [f"vertex {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}" for v in t]
            lines += ["endloop", "endfacet"]
        p.write_text("\n".join(lines + ["endsolid m"]))
    _equal(jstl.load_stl_mesh(p), pstl.load_stl_mesh(p), kind)
    jg, pg = _both(jstl.load_stl, pstl.load_stl, p)
    _same_tree(jg.root, pg.root)


@pytest.mark.parametrize("attrs", ["plain", "normals_uvs"])
def test_serialized_matches_reference(tmp_path, attrs):
    rng = np.random.default_rng(5)
    pos = rng.random((30, 3)).astype(np.float32)
    idx = rng.integers(0, 30, (40, 3)).astype(np.int32)
    kw = {}
    if attrs == "normals_uvs":
        kw = dict(normals=rng.random((30, 3)).astype(np.float32),
                  uvs=rng.random((30, 2)).astype(np.float32))
    jp, pp = tmp_path / "j.serialized", tmp_path / "p.serialized"
    jser.write_serialized(jp, pos, idx, **kw)
    pser.write_serialized(pp, pos, idx, **kw)
    assert jp.read_bytes() == pp.read_bytes()
    _equal(jser.load_serialized_mesh(jp), pser.load_serialized_mesh(jp), attrs)


# ---------------------------------------------------------------------------
# volumes
# ---------------------------------------------------------------------------

def _zip_nvdb(none_bytes: bytes) -> bytes:
    """A one-grid NONE-codec .nvdb recoded as ZIP: the grid buffer in two
    u64-size-prefixed zlib frames (NanoVDB io::Internal::write)."""
    magic, version, count, _ = struct.unpack_from("<QIHH", none_bytes, 0)
    (name_size,) = struct.unpack_from("<I", none_bytes, 16 + 136)
    meta_end = 16 + 176 + name_size
    buf = none_bytes[meta_end:]
    frames = b""
    for part in (buf[:len(buf) // 2], buf[len(buf) // 2:]):
        z = zlib.compress(part)
        frames += struct.pack("<Q", len(z)) + z
    return (struct.pack("<QIHH", magic, version, count, 1) + none_bytes[16:meta_end]
            + frames)


@pytest.mark.parametrize("fmt", ["vol", "nvdb", "nvdb_zip", "nvdb_empty", "npy"])
def test_volumes_match_reference(tmp_path, fmt):
    """Writers byte for byte, readers and ``load_volume``'s
    MediumComponent bit for bit (both .nvdb codecs, the empty grid)."""
    rng = np.random.default_rng(6)
    d = np.zeros((20, 17, 33), np.float32)
    d[3:12, 2:15, 5:30] = rng.random((9, 13, 25)).astype(np.float32) + 0.1
    if fmt == "nvdb_empty":
        d = np.zeros((8, 8, 8), np.float32)
    lo, hi = (-1.0, -2.0, -3.0), (4.0, 5.0, 6.0)
    jp, pp = tmp_path / f"j.{fmt[:4].rstrip('_')}", tmp_path / f"p.{fmt[:4].rstrip('_')}"
    if fmt == "vol":
        jvol.write_vol_grid(jp, d, lo, hi)
        pvol.write_vol_grid(pp, d, lo, hi)
    elif fmt == "npy":
        np.save(jp, d)
        np.save(pp, d)
    else:
        jvol.write_nvdb_grid(jp, d, lo, hi)
        pvol.write_nvdb_grid(pp, d, lo, hi)
    assert jp.read_bytes() == pp.read_bytes()
    if fmt == "nvdb_zip":
        jp.write_bytes(_zip_nvdb(jp.read_bytes()))
    if fmt == "vol":
        _equal(jvol.load_vol_grid(jp), pvol.load_vol_grid(jp), fmt)
    elif fmt != "npy":
        _equal(jvol.load_nvdb_grid(jp), pvol.load_nvdb_grid(jp), fmt)
    jg, pg = jgraph.NodeGraph(), pgraph.NodeGraph()
    kw = dict(albedo=(0.85, 0.85, 0.9), g=0.3, density_scale=2.5)
    jvol.load_volume(jg.root, jp, **kw)
    pvol.load_volume(pg.root, jp, **kw)
    _same_tree(jg.root, pg.root)


def test_volume_and_blend_refusals(tmp_path):
    """.vdb and an unknown volume extension raise as the reference's do;
    the CLI refuses .blend and an unknown scene extension."""
    vdb = tmp_path / "cloud.vdb"
    vdb.write_bytes(b" BDV\x00\x00\x00\x00" + b"\x00" * 64)
    with pytest.raises(ValueError, match="nanovdb_convert"):
        pvol.load_volume(pgraph.NodeGraph().root, vdb)
    with pytest.raises(ValueError, match="unsupported volume"):
        pvol.load_volume(pgraph.NodeGraph().root, tmp_path / "x.raw")
    blend = tmp_path / "scene.blend"
    blend.write_bytes(b"BLENDER-v404" + b"\x00" * 32)
    with pytest.raises(ValueError, match="glTF"):
        cli.build_scene(Options([f"--scene={blend}"]))
    other = tmp_path / "scene.dae"
    other.write_text("x")
    with pytest.raises(ValueError, match="unsupported scene extension"):
        cli.build_scene(Options([f"--scene={other}"]))


# ---------------------------------------------------------------------------
# Mitsuba
# ---------------------------------------------------------------------------

MITSUBA = """<scene version="0.6.0">
  <sensor type="perspective">
    <float name="fov" value="40"/>
    <transform name="toWorld">
      <lookat origin="0 1 -5" target="0 1 0" up="0 1 0"/>
    </transform>
  </sensor>
  <bsdf type="diffuse" id="white">
    <rgb name="reflectance" value="0.7 0.7 0.7"/>
  </bsdf>
  <bsdf type="roughconductor" id="metal">
    <float name="alpha" value="0.04"/>
  </bsdf>
  <bsdf type="twosided" id="checker">
    <bsdf type="diffuse">
      <texture type="checkerboard" name="reflectance">
        <rgb name="color0" value="0.8 0.1 0.1"/>
        <rgb name="color1" value="0.1 0.1 0.8"/>
      </texture>
    </bsdf>
  </bsdf>
  <bsdf type="roughplastic" id="plastic">
    <spectrum name="diffuseReflectance" value="400:0.2, 500:0.8, 650:0.1"/>
    <float name="alpha" value="0.09"/>
  </bsdf>
  <shape type="rectangle">
    <ref id="checker"/>
    <transform name="toWorld">
      <scale value="3"/>
      <rotate x="1" angle="-90"/>
    </transform>
  </shape>
  <shape type="sphere">
    <float name="radius" value="0.5"/>
    <point name="center" x="0.5" y="0.5" z="0"/>
    <ref id="metal"/>
  </shape>
  <shape type="ply">
    <string name="filename" value="mesh.ply"/>
    <ref id="plastic"/>
    <transform name="toWorld">
      <matrix value="1 0 0 0.2  0 1 0 0.1  0 0 1 0.3  0 0 0 1"/>
    </transform>
  </shape>
  <shape type="serialized">
    <string name="filename" value="mesh.serialized"/>
    <bsdf type="dielectric">
      <float name="intIOR" value="1.33"/>
      <float name="extIOR" value="1.0"/>
    </bsdf>
    <transform name="toWorld"><translate x="-1" y="0.5"/></transform>
  </shape>
  <shape type="obj">
    <string name="filename" value="tri.obj"/>
    <ref id="white"/>
  </shape>
  <shape type="cube">
    <ref id="white"/>
    <transform name="toWorld"><scale x="0.2" y="0.3" z="0.2"/><translate x="1"/></transform>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld">
      <translate y="3"/>
      <rotate x="1" angle="90"/>
    </transform>
    <emitter type="area">
      <rgb name="radiance" value="10 10 10"/>
    </emitter>
  </shape>
  <emitter type="constant">
    <rgb name="radiance" value="0.1 0.1 0.1"/>
  </emitter>
</scene>"""


def _mitsuba_dir(root):
    """The XML above with its PLY, serialized and OBJ files."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(8)
    pos = (rng.random((16, 3)) - 0.5).astype(np.float32)
    _ply(root / "mesh.ply", "binary_little_endian", pos, _grid_faces(4, False))
    jser.write_serialized(root / "mesh.serialized", pos * 0.5, np.asarray(
        _grid_faces(4, False), np.int32))
    (root / "tri.obj").write_text("v 0 0 1\nv 1 0 1\nv 0 1 1\nvn 0 0 -1\nf 1//1 2//1 3//1\n")
    (root / "scene.xml").write_text(MITSUBA)
    return root / "scene.xml"


def _flat_equal(jscene, pscene):
    """The flattened arrays both packages build from the same graph."""
    for field in ("positions", "normals", "uvs", "indices", "tri_material", "tri_light",
                  "tri_instance", "packed_tri"):
        _equal(np.asarray(getattr(jscene.geo, field)),
               getattr(pscene.geo, field).numpy(), f"geo.{field}")
    _equal(np.asarray(jscene.materials.packed), pscene.materials.packed.numpy(), "materials")
    _equal(np.asarray(jscene.textures.flat), pscene.textures.flat.numpy(), "textures")
    _equal(np.asarray(jscene.env.emission), pscene.env.emission.numpy(), "env")
    _equal(np.asarray(jscene.fat_bvh.leaf_tri), pscene.fat_bvh.leaf_tri.numpy(), "leaves")


def test_mitsuba_matches_reference(tmp_path):
    """Every shape type, named and nested bsdfs, a spectrum, a checkerboard
    and an area emitter: the node trees, transforms, meshes and materials
    equal; both packages' flatten of it gives equal arrays."""
    xml = _mitsuba_dir(tmp_path / "scene")
    jg, pg = _both(jmitsuba.load_mitsuba, pmitsuba.load_mitsuba, xml)
    _same_tree(jg.root, pg.root)
    jscene, jstats = jflatten.flatten(jg.root)
    pscene, pstats = pflatten.flatten(pg.root, device="cpu")
    assert (jstats.num_triangles, jstats.num_lights, jstats.num_instances) == (
        pstats.num_triangles, pstats.num_lights, pstats.num_instances)
    _flat_equal(jscene, pscene)


# ---------------------------------------------------------------------------
# glTF
# ---------------------------------------------------------------------------

def _png(rng, h=8, w=8, channels=4):
    img = (rng.random((h, w, channels)) * 255).astype(np.uint8)
    return img


def _png_bytes(img, tmp_path, name):
    p = tmp_path / name
    pimage.write_png(p, img)
    return p.read_bytes()


def _gltf_doc(tmp_path, textured, image_bytes=None):
    """The reference test's quad (tests/test_gltf.py:15) with UVs, normals,
    a camera and, if ``textured``, base-color, metal-rough and normal
    textures from one embedded image -> (doc, binary buffer)."""
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    nrm = np.tile(np.asarray([[0, 0, 1]], np.float32), (4, 1))
    uv = np.asarray([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32)
    idx = np.asarray([0, 1, 2, 2, 1, 3], np.uint16)
    raw = pos.tobytes() + nrm.tobytes() + uv.tobytes() + idx.tobytes()
    views = [
        {"buffer": 0, "byteOffset": 0, "byteLength": 48},
        {"buffer": 0, "byteOffset": 48, "byteLength": 48},
        {"buffer": 0, "byteOffset": 96, "byteLength": 32},
        {"buffer": 0, "byteOffset": 128, "byteLength": 12},
    ]
    material = {
        "name": "redish",
        "pbrMetallicRoughness": {"baseColorFactor": [0.8, 0.1, 0.1, 1.0],
                                 "metallicFactor": 0.0, "roughnessFactor": 0.4},
        "emissiveFactor": [1.0, 1.0, 1.0],
        "alphaMode": "MASK", "alphaCutoff": 0.3,
        "extensions": {"KHR_materials_emissive_strength": {"emissiveStrength": 5.0},
                       "KHR_materials_ior": {"ior": 1.33},
                       "KHR_materials_clearcoat": {"clearcoatFactor": 0.5,
                                                   "clearcoatRoughnessFactor": 0.2}},
    }
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0, 1]}],
        "nodes": [
            {"mesh": 0, "translation": [2.0, 0.0, 0.0], "rotation": [0, 0.3826834, 0, 0.9238795],
             "scale": [1, 2, 1], "name": "quad", "children": [2]},
            {"camera": 0, "matrix": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0.5, 0.5, 3, 1]},
            {"mesh": 0, "translation": [0, 0, 1], "name": "child"},
        ],
        "cameras": [{"type": "perspective", "perspective": {"yfov": 0.7, "znear": 0.01}}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1,
                                                   "TEXCOORD_0": 2},
                                    "indices": 3, "material": 0}]}],
        "materials": [material],
        "buffers": [{"byteLength": len(raw)}],
        "bufferViews": views,
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 4, "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
    }
    if textured:
        raw += b"\0" * (-len(raw) % 4)
        views.append({"buffer": 0, "byteOffset": len(raw), "byteLength": len(image_bytes)})
        raw += image_bytes
        doc["images"] = [{"bufferView": 4, "mimeType": "image/png"}]
        doc["textures"] = [{"source": 0}]
        material["pbrMetallicRoughness"]["baseColorTexture"] = {"index": 0}
        material["pbrMetallicRoughness"]["metallicRoughnessTexture"] = {"index": 0}
        material["normalTexture"] = {"index": 0}
    doc["buffers"][0]["byteLength"] = len(raw)
    return doc, raw


def _glb(path, doc, raw):
    payload = json.dumps(doc).encode()
    payload += b" " * (-len(payload) % 4)
    binc = raw + b"\0" * (-len(raw) % 4)
    body = (struct.pack("<II", len(payload), 0x4E4F534A) + payload
            + struct.pack("<II", len(binc), 0x004E4942) + binc)
    path.write_bytes(struct.pack("<4sII", b"glTF", 2, 12 + len(body)) + body)
    return path


@pytest.mark.parametrize("form", ["gltf_data_uri", "glb", "glb_textured", "gltf_png_uri"])
def test_gltf_matches_reference(tmp_path, form):
    """Node trees (TRS and matrix transforms, the camera flip), meshes and
    materials equal; the textured forms' images, decoded by the port's PNG
    decoder, equal the reference's PIL-decoded ones bit for bit."""
    rng = np.random.default_rng(9)
    png = _png_bytes(_png(rng), tmp_path, "tex.png")
    textured = form in ("glb_textured", "gltf_png_uri")
    doc, raw = _gltf_doc(tmp_path, textured, png)
    if form.startswith("glb"):
        p = _glb(tmp_path / "t.glb", doc, raw)
    else:
        doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                    + base64.b64encode(raw).decode())
        if form == "gltf_png_uri":
            doc["images"] = [{"uri": "tex.png"}]
        p = tmp_path / "t.gltf"
        p.write_text(json.dumps(doc))
    jg, pg = _both(jgltf.load_gltf, pgltf.load_gltf, p)
    _same_tree(jg.root, pg.root)
    mats = [n.find(pgraph.MeshPrimitive).material for n in pg.root.descendants()
            if n.find(pgraph.MeshPrimitive)]
    assert (mats[0].base_color_image is not None) == textured


def test_glb_flattens_as_reference(tmp_path):
    """A textured GLB flattened by both packages: equal arrays, texture
    stack included."""
    rng = np.random.default_rng(10)
    doc, raw = _gltf_doc(tmp_path, True, _png_bytes(_png(rng, 16, 16), tmp_path, "t.png"))
    jg, pg = _both(jgltf.load_gltf, pgltf.load_gltf, _glb(tmp_path / "t.glb", doc, raw))
    jscene, _ = jflatten.flatten(jg.root)
    pscene, _ = pflatten.flatten(pg.root, device="cpu")
    _flat_equal(jscene, pscene)
    assert pscene.textures.resolution > 1


def test_gltf_images_without_pil(tmp_path, monkeypatch):
    """With PIL hidden, an embedded PNG still loads (the port's decoder),
    equal to the reference's PIL route; a JPEG raises naming the image and
    the decoder, as does a corrupt PNG; an unreferenced image stays out."""
    rng = np.random.default_rng(11)
    img = _png(rng, 6, 10, 3)
    doc, raw = _gltf_doc(tmp_path, True, _png_bytes(img, tmp_path, "rgb.png"))
    p = _glb(tmp_path / "t.glb", doc, raw)
    jg = jgraph.NodeGraph()
    jgltf.load_gltf(jg.root, p)  # PIL importable: the reference's route
    monkeypatch.setitem(sys.modules, "PIL", None)
    pg = pgraph.NodeGraph()
    pgltf.load_gltf(pg.root, p)
    _same_tree(jg.root, pg.root)

    jpeg = b"\xff\xd8\xff\xe0" + b"\x00" * 64
    doc, raw = _gltf_doc(tmp_path, True, jpeg)
    doc["images"][0]["mimeType"] = "image/jpeg"
    p = _glb(tmp_path / "j.glb", doc, raw)
    with pytest.raises(RuntimeError, match=r"image 0 \(image/jpeg\).*PIL"):
        pgltf.load_gltf(pgraph.NodeGraph().root, p)
    bad = _png_bytes(img, tmp_path, "bad.png")
    bad = bad[:40] + bytes(b ^ 0x5A for b in bad[40:60]) + bad[60:]
    doc, raw = _gltf_doc(tmp_path, True, bad)
    with pytest.raises(Exception):
        pgltf.load_gltf(pgraph.NodeGraph().root, _glb(tmp_path / "b.glb", doc, raw))
    doc, raw = _gltf_doc(tmp_path, False)
    doc["images"] = [{"uri": "missing.jpg"}]  # referenced by no texture
    pgltf.load_gltf(pgraph.NodeGraph().root, _glb(tmp_path / "u.glb", doc, raw))


# ---------------------------------------------------------------------------
# FBX
# ---------------------------------------------------------------------------

def _fbx_meshes(rng):
    quad = dict(name="quad", positions=np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]],
                                                  np.float32),
                indices=np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
                normals=np.tile([[0.0, 0.0, 1.0]], (4, 1)).astype(np.float32),
                uvs=np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                translation=(2.0, 3.0, 4.0), rotation_deg=(10.0, 90.0, -30.0),
                scaling=(1.0, 2.0, 0.5), diffuse=(0.2, 0.4, 0.6), emissive=(1.0, 2.0, 3.0))
    blob = dict(name="blob", positions=rng.normal(size=(12, 3)).astype(np.float32),
                indices=rng.integers(0, 12, (10, 3)).astype(np.int32))
    return [quad, blob]


def test_fbx_matches_reference(tmp_path):
    """``write_fbx`` byte for byte, the parsed record trees and the loaded
    node trees equal; a hand-built quad polygon fans and slots as the
    reference's ``_triangulate`` does."""
    rng = np.random.default_rng(12)
    jp, pp = tmp_path / "j.fbx", tmp_path / "p.fbx"
    jfbx.write_fbx(jp, _fbx_meshes(rng))
    pfbx.write_fbx(pp, _fbx_meshes(np.random.default_rng(12)))
    assert jp.read_bytes() == pp.read_bytes()

    def records(n):
        return (n.name, [p for p in n.props], [records(c) for c in n.children])

    jr, jv = jfbx.parse_fbx(jp)
    pr, pv = pfbx.parse_fbx(jp)
    assert jv == pv
    _equal(records(jr), records(pr), "records")
    jg, pg = _both(jfbx.load_fbx, pfbx.load_fbx, jp)
    _same_tree(jg.root, pg.root)

    verts = np.arange(15, dtype=np.float64)
    pvi = np.array([0, 1, 2, ~np.int64(3), 1, 2, ~np.int64(4)], np.int64)
    mats = pfbx.FbxNode("LayerElementMaterial", [0], [
        pfbx.FbxNode("MappingInformationType", ["ByPolygon"], []),
        pfbx.FbxNode("Materials", [np.asarray([1, 0], np.int32)], [])])
    geo = pfbx.FbxNode("Geometry", [1, "g", "Mesh"], [
        pfbx.FbxNode("Vertices", [verts], []),
        pfbx.FbxNode("PolygonVertexIndex", [pvi], []), mats])
    jgeo = jfbx.FbxNode("Geometry", [1, "g", "Mesh"], [
        jfbx.FbxNode("Vertices", [verts], []),
        jfbx.FbxNode("PolygonVertexIndex", [pvi], []),
        jfbx.FbxNode("LayerElementMaterial", [0], [
            jfbx.FbxNode("MappingInformationType", ["ByPolygon"], []),
            jfbx.FbxNode("Materials", [np.asarray([1, 0], np.int32)], [])])])
    _equal(jfbx._triangulate(jgeo), pfbx._triangulate(geo), "fan")
    assert pfbx._triangulate(geo)[1].tolist() == [[0, 1, 2], [0, 2, 3], [1, 2, 4]]


# ---------------------------------------------------------------------------
# the CLI's dispatch
# ---------------------------------------------------------------------------

def test_cli_build_scene_matches_reference(tmp_path):
    """``cli.build_scene`` for each file extension gives the reference
    CLI's node tree."""
    from stratum_tpu import cli as jcli
    from stratum_tpu.utils.flags import Options as JOptions

    rng = np.random.default_rng(13)
    files = [_mitsuba_dir(tmp_path / "m")]
    pos = rng.normal(size=(16, 3)).astype(np.float32)
    _ply(tmp_path / "s.ply", "binary_little_endian", pos, _grid_faces(4, True))
    files.append(tmp_path / "s.ply")
    stl = tmp_path / "s.stl"
    buf = b"\x00" * 80 + struct.pack("<I", 2)
    for t in rng.normal(size=(2, 4, 3)).astype(np.float32):
        buf += t.tobytes() + b"\x00\x00"
    stl.write_bytes(buf)
    files.append(stl)
    jfbx.write_fbx(tmp_path / "s.fbx", _fbx_meshes(rng))
    files.append(tmp_path / "s.fbx")
    doc, raw = _gltf_doc(tmp_path, False)
    files.append(_glb(tmp_path / "s.glb", doc, raw))
    for f in files:
        jg = jcli.build_scene(JOptions([f"--scene={f}"]))
        pg = cli.build_scene(Options([f"--scene={f}"]))
        _same_tree(jg.root, pg.root, f.suffix)
