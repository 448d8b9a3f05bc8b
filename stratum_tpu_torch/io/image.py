"""Dependency-free image I/O: PNG, Radiance HDR, PFM, EXR, NPY
(counterpart of stratum_tpu/io/image.py, numpy + zlib + struct only).

The readers and writers are the reference's. Two functions differ in how,
not in what, they compute:

- :func:`linear_to_srgb` is numpy (the reference takes its torch-free twin
  from its JAX ``core.math``): the power runs in float64 and is rounded to
  float32, which gives the bytes the reference's PNGs hold for the sample
  assets (tests/test_torch_colonnade.py);
- :func:`load_image` decodes PNG with :func:`read_png` and widens it to
  RGBA as the reference's PIL path (``convert("RGBA")``) does, without
  PIL.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np



def linear_to_srgb(c) -> np.ndarray:
    """Linear -> sRGB-encoded float32 (negative inputs clamp to 0)."""
    c = np.maximum(np.asarray(c, np.float32), np.float32(0.0))
    p = (c.astype(np.float64) ** (1.0 / 2.4)).astype(np.float32)
    return np.where(
        c <= np.float32(0.0031308), c * np.float32(12.92),
        np.float32(1.055) * p - np.float32(0.055),
    ).astype(np.float32)


# ---------------------------------------------------------------------------
# PNG (8-bit, for tonemapped output)
# ---------------------------------------------------------------------------

def write_png(path, image: np.ndarray):
    """Write uint8 [H,W,3|4] or float [H,W,3] (assumed already in [0,1],
    display-encoded) as PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        out = struct.pack(">I", len(data)) + tag + data
        return out + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    payload = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    Path(path).write_bytes(payload)


def read_png(path) -> np.ndarray:
    """Minimal PNG reader (8-bit, non-interlaced, filters 0-4) -> uint8 array."""
    data = Path(path).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a png"
    pos = 8
    idat = b""
    w = h = c = 0
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", body
            )
            assert depth == 8 and interlace == 0, "unsupported png"
            c = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    stride = w * c
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw[pos + 1 : pos + 1 + stride], np.uint8).copy()
        pos += 1 + stride
        if ftype == 1:  # sub
            for i in range(c, stride):
                line[i] = (line[i] + line[i - c]) & 0xFF
        elif ftype == 2:  # up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ftype == 3:  # average
            for i in range(stride):
                a = int(line[i - c]) if i >= c else 0
                line[i] = (int(line[i]) + ((a + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:  # paeth
            for i in range(stride):
                a = int(line[i - c]) if i >= c else 0
                b = int(prev[i])
                cc = int(prev[i - c]) if i >= c else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                line[i] = (int(line[i]) + pred) & 0xFF
        out[y] = line
        prev = out[y]
    return out.reshape(h, w, c)


# ---------------------------------------------------------------------------
# Radiance HDR (RGBE), linear radiance
# ---------------------------------------------------------------------------

def _float_to_rgbe(img: np.ndarray) -> np.ndarray:
    maxc = img.max(axis=-1)
    valid = maxc >= 1e-32
    mant, exp = np.frexp(np.where(valid, maxc, 1.0))
    scale = mant * 256.0 / np.where(valid, maxc, 1.0)
    rgbe = np.zeros(img.shape[:-1] + (4,), np.uint8)
    rgbe[..., :3] = np.clip(
        np.round(img * scale[..., None]), 0, 255
    ).astype(np.uint8)
    rgbe[..., 3] = np.where(valid, exp + 128, 0).astype(np.uint8)
    rgbe[~valid] = 0
    return rgbe


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 136), 0.0)
    return rgbe[..., :3].astype(np.float32) * scale[..., None].astype(np.float32)


def write_hdr(path, image: np.ndarray):
    """Write linear float [H,W,3] as Radiance .hdr (flat RGBE scanlines,
    matching the reference's stbi_write_hdr export, BDPT.cpp:313-338)."""
    img = np.asarray(image, np.float32)
    h, w, _ = img.shape
    header = (
        b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
        + f"-Y {h} +X {w}\n".encode()
    )
    Path(path).write_bytes(header + _float_to_rgbe(img).tobytes())


def read_hdr(path) -> np.ndarray:
    data = Path(path).read_bytes()
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    dims = data[pos:eol].split()
    h, w = int(dims[1]), int(dims[3])
    body = data[eol + 1 :]
    out = np.empty((h, w, 4), np.uint8)
    bpos = 0
    for y in range(h):
        if len(body) - bpos >= 4 and body[bpos] == 2 and body[bpos + 1] == 2:
            # RLE scanline
            bpos += 4
            scan = np.empty((4, w), np.uint8)
            for ch in range(4):
                x = 0
                while x < w:
                    n = body[bpos]
                    bpos += 1
                    if n > 128:
                        scan[ch, x : x + n - 128] = body[bpos]
                        bpos += 1
                        x += n - 128
                    else:
                        scan[ch, x : x + n] = np.frombuffer(
                            body[bpos : bpos + n], np.uint8
                        )
                        bpos += n
                        x += n
            out[y] = scan.T
        else:
            out[y] = np.frombuffer(
                body[bpos : bpos + 4 * w], np.uint8
            ).reshape(w, 4)
            bpos += 4 * w
    return _rgbe_to_float(out)


# ---------------------------------------------------------------------------
# PFM (portable float map) + NPY
# ---------------------------------------------------------------------------

def write_pfm(path, image: np.ndarray):
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    hdr = (b"PF\n" if img.ndim == 3 else b"Pf\n") + f"{w} {h}\n-1.0\n".encode()
    Path(path).write_bytes(hdr + img[::-1].tobytes())


def read_pfm(path) -> np.ndarray:
    data = Path(path).read_bytes()
    parts = data.split(b"\n", 3)
    color = parts[0] == b"PF"
    w, h = map(int, parts[1].split())
    scale = float(parts[2])
    arr = np.frombuffer(parts[3], "<f4" if scale < 0 else ">f4")
    arr = arr.reshape((h, w, 3) if color else (h, w))
    return arr[::-1].astype(np.float32)


# ---------------------------------------------------------------------------
# OpenEXR (scanline, FLOAT/HALF, uncompressed + ZIP) — reference uses
# tinyexr (Core/Image.cpp:60); this is a dependency-free subset covering
# what renderers exchange: RGB(A) scanline images.
# ---------------------------------------------------------------------------

_EXR_MAGIC = 20000630


def _exr_attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\x00" + typ + b"\x00" + struct.pack("<I", len(data)) + data


def write_exr(path, image: np.ndarray):
    """Write float32 [H,W,3] as an uncompressed FLOAT scanline EXR."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w, c = img.shape
    assert c >= 3, "write_exr expects RGB"
    chan = b""
    for name in (b"B", b"G", b"R"):  # alphabetical per spec
        chan += name + b"\x00" + struct.pack("<IIII", 2, 0, 1, 1)  # FLOAT
    chan += b"\x00"
    header = b""
    header += _exr_attr(b"channels", b"chlist", chan)
    header += _exr_attr(b"compression", b"compression", b"\x00")  # NONE
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _exr_attr(b"dataWindow", b"box2i", box)
    header += _exr_attr(b"displayWindow", b"box2i", box)
    header += _exr_attr(b"lineOrder", b"lineOrder", b"\x00")
    header += _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _exr_attr(
        b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0)
    )
    header += _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"
    preamble = struct.pack("<II", _EXR_MAGIC, 2) + header
    # scanline offset table then chunks: y, size, B row, G row, R row
    row_bytes = 8 + 3 * 4 * w
    offset0 = len(preamble) + 8 * h
    offsets = struct.pack("<" + "Q" * h, *(offset0 + row_bytes * y for y in range(h)))
    chunks = []
    for y in range(h):
        data = (
            img[y, :, 2].tobytes()
            + img[y, :, 1].tobytes()
            + img[y, :, 0].tobytes()
        )
        chunks.append(struct.pack("<ii", y, len(data)) + data)
    Path(path).write_bytes(preamble + offsets + b"".join(chunks))


def read_exr(path) -> np.ndarray:
    """Read a scanline EXR (FLOAT/HALF channels, NONE/ZIP/ZIPS compression)
    to float32 [H,W,C] with channels ordered RGB(A) when present."""
    data = Path(path).read_bytes()
    magic, version = struct.unpack_from("<II", data, 0)
    assert magic == _EXR_MAGIC, "not an EXR file"
    assert version & 0x200 == 0, "tiled EXR not supported"
    pos = 8
    channels = []  # (name, pixel_type)
    compression = 0
    xmin = ymin = xmax = ymax = 0
    while data[pos] != 0:
        e = data.index(b"\x00", pos)
        name = data[pos:e].decode()
        pos = e + 1
        e = data.index(b"\x00", pos)
        typ = data[pos:e].decode()
        pos = e + 1
        (size,) = struct.unpack_from("<I", data, pos)
        pos += 4
        body = data[pos : pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while body[cp] != 0:
                ce = body.index(b"\x00", cp)
                cname = body[cp:ce].decode()
                ptype = struct.unpack_from("<I", body, ce + 1)[0]
                channels.append((cname, ptype))
                cp = ce + 1 + 16
        elif name == "compression":
            compression = body[0]
        elif name == "dataWindow":
            xmin, ymin, xmax, ymax = struct.unpack("<iiii", body)
    pos += 1  # header terminator
    w = xmax - xmin + 1
    h = ymax - ymin + 1
    assert compression in (0, 2, 3), (
        f"EXR compression {compression} unsupported (NONE/ZIPS/ZIP only)"
    )
    lines_per_chunk = {0: 1, 2: 1, 3: 16}[compression]
    nchunks = -(-h // lines_per_chunk)
    offsets = struct.unpack_from("<" + "Q" * nchunks, data, pos)
    dtypes = {0: np.uint32, 1: np.float16, 2: np.float32}
    sizes = {0: 4, 1: 2, 2: 4}
    out = {name: np.zeros((h, w), np.float32) for name, _ in channels}
    for off in offsets:
        y0, size = struct.unpack_from("<ii", data, off)
        raw = data[off + 8 : off + 8 + size]
        ny = min(lines_per_chunk, ymax - y0 + 1)
        expect = ny * sum(w * sizes[pt] for _, pt in channels)
        if compression != 0 and size < expect:
            raw = zlib.decompress(raw)
            # OpenEXR ZIP post-filter: undo delta-encoding, de-interleave
            arr = np.frombuffer(raw, np.uint8).astype(np.int16)
            deltas = np.cumsum(
                np.concatenate([arr[:1], (arr[1:] - 128) % 256])
            ) % 256
            half = (len(deltas) + 1) // 2
            inter = np.zeros(len(deltas), np.uint8)
            inter[0::2] = deltas[:half].astype(np.uint8)
            inter[1::2] = deltas[half : half + len(deltas) // 2].astype(
                np.uint8
            )
            raw = inter.tobytes()
        cp = 0
        for yy in range(ny):
            for cname, ptype in channels:
                nb = w * sizes[ptype]
                row = np.frombuffer(raw, dtypes[ptype], w, cp)
                out[cname][y0 - ymin + yy] = row.astype(np.float32)
                cp += nb
    order = [c for c in ("R", "G", "B", "A") if c in out]
    if not order:
        order = sorted(out)
    return np.stack([out[c] for c in order], axis=-1)


def load_image(path, srgb: bool | None = None) -> np.ndarray:
    """Load any common image format to float32 linear [H,W,C]
    (reference: Image::load_image_data via stb/tinyexr, Core/Image.cpp:60).
    8-bit LDR inputs (PNG, as RGBA) are assumed sRGB-encoded unless
    ``srgb=False``; HDR formats (.hdr/.pfm/.npy/.exr) are linear."""
    p = str(path)
    low = p.lower()
    if low.endswith(".hdr"):
        return read_hdr(p)
    if low.endswith(".pfm"):
        return read_pfm(p)
    if low.endswith(".npy"):
        return np.load(p).astype(np.float32)
    if low.endswith(".exr"):
        return read_exr(p)
    if not low.endswith(".png"):
        raise ValueError(f"unsupported image format: {p}")
    img = _rgba(read_png(p)).astype(np.float32) / 255.0
    if srgb is None:
        srgb = True
    if srgb:
        rgb = np.asarray(srgb_to_linear_np(img[..., :3]))
        img = np.concatenate([rgb, img[..., 3:]], axis=-1)
    return img


def _rgba(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 1|2|3|4] -> [H, W, 4]: grey replicated to RGB, alpha 255
    where there is none (what PIL's ``convert("RGBA")`` gives)."""
    c = img.shape[-1]
    rgb = np.repeat(img[..., :1], 3, axis=-1) if c <= 2 else img[..., :3]
    alpha = img[..., -1:] if c in (2, 4) else np.full_like(img[..., :1], 255)
    return np.concatenate([rgb, alpha], axis=-1)


def srgb_to_linear_np(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(
        np.float32
    )


def save_image(path, image: np.ndarray, tonemapped: bool = False):
    """Dispatch by extension (reference dispatches loaders by extension,
    Node/Scene.hpp:116-137). ``.png`` gets sRGB-encoded unless the input is
    already display-referred (``tonemapped=True``)."""
    p = str(path)
    img = np.asarray(image)
    if p.endswith(".png"):
        write_png(p, img if tonemapped else linear_to_srgb(img))
    elif p.endswith(".hdr"):
        write_hdr(p, img)
    elif p.endswith(".pfm"):
        write_pfm(p, img)
    elif p.endswith(".npy"):
        np.save(p, img)
    elif p.endswith(".exr"):
        write_exr(p, img)
    else:
        raise ValueError(f"unknown image extension: {p}")
