"""Texture stack and its samplers (counterpart of
stratum_tpu/render/texture.py).

Every referenced image is resampled at flatten time into one ``R x R``
RGBA stack with a full mip pyramid, and all levels live in ONE flat
[rows, 4] float16 atlas; a sample finds its row by index arithmetic (level
offset table + the lane's level resolution), so a tap costs a fixed number
of row gathers whatever the pyramid depth. The quad atlas [rows, 16] holds
each texel's 2x2 block with the neighbours pre-wrapped, so a bilinear tap is
one row gather. Both atlases are built in numpy exactly as the reference
builds them; samples gather f16 rows and convert to f32 after the gather.

The level choice follows the dtype of ``lod``: a float lod is trilinear
(the two adjacent levels blended, or with ``u_lod`` one of them picked with
the blend weight as probability), an integer lod selects one level exactly.
Texture id -1 means "no texture" and samples 1.0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DEFAULT_RES = 512

# slot_mask bits: which material texture slots some material binds; a tap
# of a slot no material binds returns 1.0 everywhere and is skipped
SLOT_BASE_COLOR = 1
SLOT_EMISSION = 2
SLOT_ROUGH_METAL = 4
SLOT_NORMAL = 8
SLOT_ALPHA = 16
SLOT_ALL = 31


class TextureStack(NamedTuple):
    """Flat mip atlas: level l's block starts at ``level_offsets()[l]`` and
    holds ``num_tex`` images of resolution ``base_res >> l`` in [K, r, r]
    row-major order. ``base_res == 1`` is the "no textures" sentinel."""

    flat: torch.Tensor  # f16 [rows, 4]
    quad: torch.Tensor  # f16 [rows, 16] 2x2 blocks, wrapped
    base_res: int
    num_levels: int
    num_tex: int
    slot_mask: int = SLOT_ALL

    def uses(self, slot_bit: int) -> bool:
        return bool(self.slot_mask & slot_bit)

    @property
    def resolution(self) -> int:
        return self.base_res

    def level_offsets(self) -> list:
        """Start row of each level."""
        offs, row, r = [], 0, self.base_res
        for _ in range(self.num_levels):
            offs.append(row)
            row += self.num_tex * r * r
            r = max(r // 2, 1)
        return offs


def _area_resample(img: np.ndarray, res: int) -> np.ndarray:
    """[H, W, C] -> [res, res, 4] float32, as the reference resamples: each
    channel by PIL's LANCZOS in mode ``F`` where PIL imports, else by
    nearest rows and columns. PIL is optional and imported here only."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
    try:
        from PIL import Image

        chans = [
            np.asarray(Image.fromarray(img[..., c]).resize((res, res), Image.LANCZOS),
                       np.float32)
            for c in range(4)
        ]
        return np.stack(chans, axis=-1)
    except Exception:
        ys = np.linspace(0, img.shape[0] - 1, res).astype(np.int32)
        xs = np.linspace(0, img.shape[1] - 1, res).astype(np.int32)
        return img[ys][:, xs]


def _downsample2(level: np.ndarray) -> np.ndarray:
    """2x2 box filter of one mip level [K, R, R, 4] -> [K, R/2, R/2, 4]."""
    k, r, _, c = level.shape
    return level.reshape(k, r // 2, 2, r // 2, 2, c).mean(axis=(2, 4))


def build_texture_stack(images: list, res: int = DEFAULT_RES) -> TextureStack:
    """Linear float images [H, W, C] -> TextureStack of numpy arrays (see
    ``schema.to_device``). No images: the 1x1 white sentinel."""
    if not images:
        return TextureStack(
            np.ones((1, 4), np.float16), np.ones((1, 16), np.float16),
            base_res=1, num_levels=1, num_tex=1,
        )
    base = np.stack([_area_resample(im, res) for im in images])
    levels = [base]
    while levels[-1].shape[1] > 1:
        levels.append(_downsample2(levels[-1]))
    flat = np.concatenate([lv.reshape(-1, 4) for lv in levels], axis=0)

    def quad_of(lv):
        # each texel row also carries its +x / +y / +x+y wrapped neighbours
        qx = np.roll(lv, -1, axis=2)
        qy = np.roll(lv, -1, axis=1)
        qxy = np.roll(qy, -1, axis=2)
        return np.concatenate([lv, qx, qy, qxy], axis=-1)

    quad = np.concatenate([quad_of(lv).reshape(-1, 16) for lv in levels])
    return TextureStack(
        flat.astype(np.float16), quad.astype(np.float16),
        base_res=res, num_levels=len(levels), num_tex=base.shape[0],
    )


def _level_sample(stack, offs, tid, uv, lvl, bilinear):
    """One level's nearest or bilinear sample, the level chosen per lane:
    r = R >> lvl, row = off[lvl] + (tid * r + y) * r + x, x and y wrapped
    by a floor-mod with the lane's r."""
    r = torch.clamp(torch.bitwise_right_shift(torch.full_like(lvl, stack.base_res), lvl), min=1)
    off = offs[lvl]
    rf = r.to(torch.float32)
    x = uv[..., 0] * rf - 0.5
    y = uv[..., 1] * rf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi0 = torch.remainder(x0.to(torch.int64), r)
    yi0 = torch.remainder(y0.to(torch.int64), r)
    idx = off + (tid * r + yi0) * r + xi0
    if not bilinear:
        return stack.flat[idx].to(torch.float32)
    q = stack.quad[idx].to(torch.float32)  # [N, 16]: the 2x2 block
    c00, c10, c01, c11 = q[..., 0:4], q[..., 4:8], q[..., 8:12], q[..., 12:16]
    return (
        c00 * (1 - fx) * (1 - fy)
        + c10 * fx * (1 - fy)
        + c01 * (1 - fx) * fy
        + c11 * fx * fy
    )


def _sample(stack, tex_id, uv, lod, bilinear, u_lod=None):
    n_levels = stack.num_levels
    valid = tex_id >= 0
    tid = torch.clamp(tex_id, min=0).to(torch.int64)
    if lod is None:
        lod = torch.zeros(uv.shape[:-1], dtype=torch.int64, device=uv.device)
    offs = torch.tensor(stack.level_offsets(), dtype=torch.int64, device=uv.device)
    if lod.is_floating_point():
        lod = torch.clamp(lod, 0.0, n_levels - 1)
        l0 = torch.floor(lod).to(torch.int64)
        f1 = lod - l0.to(torch.float32)
        if u_lod is not None:
            lvl = torch.clamp(l0 + (u_lod < f1).to(torch.int64), max=n_levels - 1)
            out = _level_sample(stack, offs, tid, uv, lvl, bilinear)
        else:
            l1 = torch.clamp(l0 + 1, max=n_levels - 1)
            f = f1[..., None]
            v0 = _level_sample(stack, offs, tid, uv, l0, bilinear)
            v1 = _level_sample(stack, offs, tid, uv, l1, bilinear)
            out = v0 * (1.0 - f) + v1 * f
    else:
        lvl = torch.clamp(lod.to(torch.int64), 0, n_levels - 1)
        out = _level_sample(stack, offs, tid, uv, lvl, bilinear)
    return torch.where(valid[..., None], out, 1.0)


def sample_nearest(stack: TextureStack, tex_id, uv, lod=None):
    """Nearest-texel fetch at an integer LOD (default 0) -> [N, 4] f32."""
    return _sample(stack, tex_id, uv, lod, bilinear=False)


def sample_bilinear(stack: TextureStack, tex_id, uv, lod=None, u_lod=None):
    """Bi- or trilinear fetch -> [N, 4] f32. ``tex_id`` [N] int, ``uv``
    [N, 2] (wrapped), ``lod`` integer (one level) or float (trilinear);
    ``u_lod`` [N] in [0, 1): stochastic trilinear, one bilinear tap whose
    expectation is the trilinear value."""
    return _sample(stack, tex_id, uv, lod, bilinear=True, u_lod=u_lod)


def ray_cone_lod(stack: TextureStack, uv_screen_size, fractional: bool = True):
    """Mip level whose texel footprint matches the ray-cone uv footprint:
    fractional for the trilinear blend, else the next integer level."""
    texels = uv_screen_size * stack.resolution
    lod = torch.clamp(torch.log2(torch.clamp(texels, min=1.0)), min=0.0)
    lod = torch.clamp(lod, 0.0, stack.num_levels - 1)
    if fractional:
        return lod
    return torch.ceil(lod).to(torch.int32)
