"""Volume grid loaders and writers: Mitsuba ``.vol``, NanoVDB ``.nvdb``,
raw numpy (counterpart of stratum_tpu/scene/loaders/volumes.py, numpy +
zlib only; src/Node/loaders/load_volumes.cpp).

Grids become dense density bricks on a MediumComponent (render/medium.py
resamples them and computes majorants). A ``.nvdb`` file is read directly:
the reader walks the serialized leaf array (8^3 float nodes) and splats it
into a dense grid over the index bounding box. Layout follows the public
NanoVDB 32.3 spec (io::Header/MetaData 16B/176B, GridData 672B, TreeData
64B, float LeafData 2144B; NONE and ZIP codecs). OpenVDB ``.vdb`` files are
refused with the conversion to use.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from stratum_tpu_torch.scene.graph import MediumComponent, Node


def load_vol_grid(path):
    """Parse a Mitsuba ``.vol`` grid file. Returns (data [Z,Y,X,C] float32,
    box_lo [3], box_hi [3])."""
    raw = Path(path).read_bytes()
    if raw[:3] != b"VOL":
        raise ValueError(f"{path}: not a mitsuba volume file")
    version = raw[3]
    if version != 3:
        raise ValueError(f"{path}: unsupported .vol version {version}")
    encoding, xres, yres, zres, channels = struct.unpack_from("<iiiii", raw, 4)
    if encoding != 1:
        raise ValueError(f"{path}: only float32 encoding supported")
    box = struct.unpack_from("<6f", raw, 24)
    count = xres * yres * zres * channels
    data = np.frombuffer(raw, "<f4", count=count, offset=48)
    data = data.reshape(zres, yres, xres, channels).astype(np.float32)
    return data, np.asarray(box[:3], np.float32), np.asarray(box[3:], np.float32)


def write_vol_grid(path, data, box_lo, box_hi):
    """Writer (tests + interchange): [Z,Y,X] or [Z,Y,X,C] float32."""
    data = np.asarray(data, np.float32)
    if data.ndim == 3:
        data = data[..., None]
    z, y, x, c = data.shape
    hdr = b"VOL" + bytes([3]) + struct.pack(
        "<iiiii6f", 1, x, y, z, c, *np.asarray(box_lo, np.float32),
        *np.asarray(box_hi, np.float32)
    )
    Path(path).write_bytes(hdr + data.tobytes())


# ---------------------------------------------------------------------------
# NanoVDB (.nvdb) — read-only ingestion + a minimal writer for tests and
# dense-grid interchange. Spec constants (NanoVDB 32.3, public Apache-2
# format; the reference links the same headers, load_volumes.cpp:17-52):
_NVDB_MAGIC = 0x304244566F6E614E  # "NanoVDB0" little-endian
_NVDB_GRIDDATA_SIZE = 672
_NVDB_TREEDATA_SIZE = 64
_NVDB_METADATA_SIZE = 176
_NVDB_LEAF_SIZE = 2144  # float leaf: 16B header + 64B mask + 16B stats
                        # + 512 * 4B values (32B-aligned)
_NVDB_LEAF_DIM = 8
_NVDB_GRID_TYPE_FLOAT = 1
_NVDB_CODEC_NONE = 0
_NVDB_CODEC_ZIP = 1


def _nvdb_decompress(raw, off, codec, grid_size):
    """Grid buffer bytes at ``off`` -> (bytes, new offset). ZIP frames are
    u64-size-prefixed zlib streams (io::Internal::write, IO.h:262-301)."""
    if codec == _NVDB_CODEC_NONE:
        return raw[off : off + grid_size], off + grid_size
    if codec == _NVDB_CODEC_ZIP:
        import zlib

        out = b""
        while len(out) < grid_size:
            (n,) = struct.unpack_from("<Q", raw, off)
            off += 8
            out += zlib.decompress(raw[off : off + n])
            off += n
        return out, off
    raise ValueError(f"unsupported .nvdb codec {codec} (NONE/ZIP only)")


def load_nvdb_grid(path, grid_index: int = 0):
    """Parse a NanoVDB ``.nvdb`` file. Returns (density [Z,Y,X] float32,
    box_lo [3], box_hi [3]) of the ``grid_index``-th float grid.

    Walks segments (Header + MetaData* + grid buffers), then the chosen
    grid's serialized leaf array: TreeData.mNodeOffset[0] points at
    mNodeCount[0] contiguous 8^3 float leaves whose mBBoxMin anchors them
    in index space. Values in inactive voxels read as stored (zeros from
    the grid writers we care about); internal-node tile values are not
    expanded (uniform-tile interiors of clouds are rare and read as 0)."""
    raw = Path(path).read_bytes()
    off = 0
    seen = 0
    while off + 16 <= len(raw):
        magic, _version, grid_count, codec = struct.unpack_from(
            "<QIHH", raw, off
        )
        if magic != _NVDB_MAGIC:
            raise ValueError(f"{path}: bad NanoVDB magic at {off:#x}")
        off += 16
        metas = []
        for _ in range(grid_count):
            (grid_size,) = struct.unpack_from("<Q", raw, off)
            grid_type, grid_class = struct.unpack_from("<II", raw, off + 32)
            wbb = struct.unpack_from("<6d", raw, off + 40)
            ibb = struct.unpack_from("<6i", raw, off + 88)
            vox = struct.unpack_from("<3d", raw, off + 112)
            (name_size,) = struct.unpack_from("<I", raw, off + 136)
            metas.append((grid_size, grid_type, wbb, ibb, vox))
            off += _NVDB_METADATA_SIZE + name_size
        for grid_size, grid_type, wbb, ibb, vox in metas:
            buf, off = _nvdb_decompress(raw, off, codec, grid_size)
            if grid_type != _NVDB_GRID_TYPE_FLOAT:
                continue
            if seen != grid_index:
                seen += 1
                continue
            return _parse_nvdb_float_grid(buf, wbb, ibb, vox)
        if grid_count == 0:
            break
    raise ValueError(f"{path}: float grid {grid_index} not found")


def _parse_nvdb_float_grid(buf, wbb, ibb, vox):
    """Dense-splat one serialized float grid buffer (GridData + TreeData +
    node arrays) into [Z,Y,X] over the leaf index bbox. The returned world
    box maps that leaf extent through the grid's index->world transform
    (world = wbb_min + (index - ibb_min) * voxelSize)."""
    magic = struct.unpack_from("<Q", buf, 0)[0]
    if magic != _NVDB_MAGIC:
        raise ValueError("bad GridData magic")
    tree = _NVDB_GRIDDATA_SIZE
    leaf_off, _lower, _upper, _root = struct.unpack_from("<4Q", buf, tree)
    n_leaf = struct.unpack_from("<3I", buf, tree + 32)[0]
    ld = _NVDB_LEAF_DIM
    base = tree + leaf_off
    mins = np.zeros((max(n_leaf, 1), 3), np.int64)
    vals = np.zeros((max(n_leaf, 1), ld, ld, ld), np.float32)
    for i in range(n_leaf):
        o = base + i * _NVDB_LEAF_SIZE
        mins[i] = struct.unpack_from("<3i", buf, o)
        v = np.frombuffer(buf, "<f4", count=ld * ld * ld, offset=o + 96)
        vals[i] = v.reshape(ld, ld, ld)  # [x-major? -> see below]
    if n_leaf == 0:
        return (
            np.zeros((1, 1, 1), np.float32),
            np.asarray(wbb[:3], np.float32),
            np.asarray(wbb[3:], np.float32),
        )
    # leaf-local value order is x*64 + y*8 + z (NanoVDB CoordToOffset:
    # x in the high bits), i.e. [X,Y,Z] arrays
    lo = mins.min(axis=0)
    hi = (mins + ld).max(axis=0)
    dim = hi - lo  # [3] xyz
    dense = np.zeros((dim[2], dim[1], dim[0]), np.float32)  # [Z,Y,X]
    for i in range(n_leaf):
        x, y, z = mins[i] - lo
        dense[z : z + ld, y : y + ld, x : x + ld] = np.transpose(
            vals[i], (2, 1, 0)
        )
    wbb_min = np.asarray(wbb[:3], np.float64)
    ibb_min = np.asarray(ibb[:3], np.float64)
    voxel = np.asarray(vox, np.float64)
    box_lo = (wbb_min + (lo - ibb_min) * voxel).astype(np.float32)
    box_hi = (wbb_min + (hi - ibb_min) * voxel).astype(np.float32)
    return dense, box_lo, box_hi


def write_nvdb_grid(path, data, box_lo, box_hi, name: str = "density"):
    """Minimal NanoVDB writer: one uncompressed float grid, leaves only
    (no internal-node tiles; inactive voxels stored as 0). Produces files
    this module's reader — and NanoVDB's own io::readGrid — accept."""
    data = np.asarray(data, np.float32)
    if data.ndim != 3:
        raise ValueError("expected [Z,Y,X] density")
    ld = _NVDB_LEAF_DIM
    z, y, x = data.shape
    orig_shape = (z, y, x)  # world box + voxel size map the UNPADDED grid
    pad = [(0, -s % ld) for s in (z, y, x)]
    data = np.pad(data, pad)
    nz, ny, nx = (s // ld for s in data.shape)
    leaves = []
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                blk = data[
                    iz * ld : (iz + 1) * ld,
                    iy * ld : (iy + 1) * ld,
                    ix * ld : (ix + 1) * ld,
                ]
                if not blk.any():
                    continue
                leaves.append((ix * ld, iy * ld, iz * ld, blk))
    n_leaf = max(len(leaves), 1)
    if not leaves:
        leaves = [(0, 0, 0, np.zeros((ld, ld, ld), np.float32))]
    leaf_bytes = bytearray()
    for lx, ly, lz, blk in leaves:
        b = bytearray(_NVDB_LEAF_SIZE)
        struct.pack_into("<3i", b, 0, lx, ly, lz)
        struct.pack_into("<3B", b, 12, ld - 1, ld - 1, ld - 1)  # mBBoxDif
        b[16:80] = b"\xff" * 64  # value mask: all active
        struct.pack_into(
            "<4f", b, 80, float(blk.min()), float(blk.max()),
            float(blk.mean()), float(blk.std()),
        )
        # value order x*64 + y*8 + z -> [X,Y,Z] C-order
        b[96 : 96 + ld**3 * 4] = (
            np.ascontiguousarray(np.transpose(blk, (2, 1, 0)))
            .astype("<f4")
            .tobytes()
        )
        leaf_bytes += b
    tree = bytearray(_NVDB_TREEDATA_SIZE)
    # root directly after tree; leaves after root (no internal nodes is a
    # lie structurally, so park an empty root stub of 32B and point
    # lower/upper at it too — our reader and dense splatting never walk it)
    root_off = _NVDB_TREEDATA_SIZE
    leaf_off = root_off + 64
    struct.pack_into(
        "<4Q", tree, 0, leaf_off, leaf_off, leaf_off, root_off
    )
    struct.pack_into("<3I", tree, 32, len(leaves), 0, 0)
    struct.pack_into("<3I", tree, 44, 0, 0, 0)
    struct.pack_into("<Q", tree, 56, int(sum(l[3].size for l in leaves)))
    grid_size = (
        _NVDB_GRIDDATA_SIZE + _NVDB_TREEDATA_SIZE + 64
        + n_leaf * _NVDB_LEAF_SIZE
    )
    gd = bytearray(_NVDB_GRIDDATA_SIZE)
    struct.pack_into("<Q", gd, 0, _NVDB_MAGIC)
    struct.pack_into("<I", gd, 16, (32 << 21) | (3 << 10))  # version 32.3.0
    struct.pack_into("<II", gd, 24, 0, 1)  # gridIndex, gridCount
    struct.pack_into("<Q", gd, 32, grid_size)
    gd[40 : 40 + min(len(name), 255)] = name.encode()[:255]
    struct.pack_into(
        "<6d", gd, 560, *np.asarray(box_lo, np.float64),
        *np.asarray(box_hi, np.float64),
    )
    vox = (np.asarray(box_hi, np.float64) - np.asarray(box_lo, np.float64)
           ) / np.asarray(orig_shape[::-1], np.float64)
    struct.pack_into("<3d", gd, 608, *vox)
    struct.pack_into("<II", gd, 632, 3, _NVDB_GRID_TYPE_FLOAT)  # FogVolume
    body = bytes(gd) + bytes(tree) + bytes(64) + bytes(leaf_bytes)
    assert len(body) == grid_size
    meta = bytearray(_NVDB_METADATA_SIZE)
    struct.pack_into(
        "<4Q", meta, 0, grid_size, grid_size, 0,
        int(sum(l[3].size for l in leaves)),
    )
    struct.pack_into("<II", meta, 32, _NVDB_GRID_TYPE_FLOAT, 3)
    struct.pack_into(
        "<6d", meta, 40, *np.asarray(box_lo, np.float64),
        *np.asarray(box_hi, np.float64),
    )
    struct.pack_into(
        "<6i", meta, 88, 0, 0, 0, orig_shape[2] - 1, orig_shape[1] - 1,
        orig_shape[0] - 1,
    )
    struct.pack_into("<3d", meta, 112, *vox)
    struct.pack_into("<I", meta, 136, len(name))
    struct.pack_into("<4I", meta, 140, n_leaf, 0, 0, 1)
    header = struct.pack(
        "<QIHH", _NVDB_MAGIC, (32 << 21) | (3 << 10), 1, _NVDB_CODEC_NONE
    )
    Path(path).write_bytes(
        header + bytes(meta) + name.encode() + body
    )


def load_volume(
    parent: Node, path, albedo=(0.9, 0.9, 0.9), g: float = 0.0,
    density_scale: float = 1.0,
) -> Node:
    """Load a volume file as a MediumComponent child node (dispatch by
    extension like the reference's Scene::load_vol/load_nvdb)."""
    path = Path(path)
    ext = path.suffix.lower()
    if ext == ".vol":
        data, lo, hi = load_vol_grid(path)
        density = data[..., 0] * density_scale
    elif ext == ".nvdb":
        density, lo, hi = load_nvdb_grid(path)
        density = density * density_scale
    elif ext == ".npy":
        density = np.load(path).astype(np.float32) * density_scale
        lo = np.zeros(3, np.float32)
        hi = np.ones(3, np.float32)
    elif ext == ".vdb":
        # OpenVDB containers need blosc + the full 5-4-3 tree reader;
        # convert offline (e.g. `nanovdb_convert in.vdb out.nvdb`) and
        # load the .nvdb (reference converts the same way at load time,
        # load_volumes.cpp:17-52)
        raise ValueError(
            f"{path}: .vdb is unsupported — convert to .nvdb "
            "(nanovdb_convert) and load that instead"
        )
    else:
        raise ValueError(f"unsupported volume extension {ext!r}")
    node = parent.add_child(path.stem)
    node.make_component(
        MediumComponent(
            density=density,
            box_lo=lo,
            box_hi=hi,
            albedo=np.asarray(albedo, np.float32),
            g=g,
        )
    )
    return node
