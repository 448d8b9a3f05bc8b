"""Device scene schema (counterpart of stratum_tpu/scene/schema.py:43-503):
struct-of-arrays NamedTuples and the host-side builders. Builders take and
return numpy; :func:`to_device` moves a finished record onto a torch device.
Padding and the ``-1`` "no entry" sentinel follow the reference exactly, so
the packed rows match it column for column.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stratum_tpu_torch.core.distribution import Dist1D, Dist2D, build_dist1d, build_dist2d
from stratum_tpu_torch.ops.bvh import BVHData
from stratum_tpu_torch.ops.packet import FatBVH
from stratum_tpu_torch.render.medium import MediumData
from stratum_tpu_torch.render.texture import TextureStack

TRI_PAD = 128
VERT_PAD = 8

MATERIAL_FLOATS = (
    "metallic", "roughness", "anisotropic", "subsurface", "clearcoat",
    "clearcoat_gloss", "transmission", "eta",
)
MATERIAL_TEXTURES = (
    "base_color_tex", "emission_tex", "rough_metal_tex", "normal_tex",
    "alpha_tex",
)


class GeometrySoA(NamedTuple):
    """Merged world-space triangle soup."""

    positions: torch.Tensor  # f32 [V, 3]
    normals: torch.Tensor  # f32 [V, 3]
    uvs: torch.Tensor  # f32 [V, 2]
    indices: torch.Tensor  # i32 [T, 3]
    tri_material: torch.Tensor  # i32 [T] (-1 on padding)
    tri_light: torch.Tensor  # i32 [T] light row or -1
    tri_instance: torch.Tensor  # i32 [T]
    packed_tri: torch.Tensor  # f32 [T, 32] one-gather shading row

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]


class DisneyMaterials(NamedTuple):
    """SoA Disney parameters, one row per unique material."""

    base_color: torch.Tensor  # f32 [M, 3]
    emission: torch.Tensor  # f32 [M, 3]
    metallic: torch.Tensor  # f32 [M]
    roughness: torch.Tensor
    anisotropic: torch.Tensor
    subsurface: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    transmission: torch.Tensor
    eta: torch.Tensor
    base_color_tex: torch.Tensor  # i32 [M] (-1: no texture)
    emission_tex: torch.Tensor
    rough_metal_tex: torch.Tensor
    normal_tex: torch.Tensor
    alpha_tex: torch.Tensor
    alpha_cutoff: torch.Tensor  # f32 [M]
    packed: torch.Tensor  # f32 [M, 24] one-gather row


class SphereSoA(NamedTuple):
    """Analytic sphere primitives; radius <= 0 marks padding. A sphere's
    shading row follows the padded triangles' rows in ``packed_tri`` and
    ``tri_payload`` (row T + sid, the sphere flag at slot 27)."""

    center: torch.Tensor  # f32 [S, 3] world space
    radius: torch.Tensor  # f32 [S]
    material: torch.Tensor  # i32 [S]
    light: torch.Tensor  # i32 [S] light row or -1
    instance: torch.Tensor  # i32 [S]

    @property
    def num_spheres(self) -> int:
        return self.radius.shape[0]


def empty_spheres() -> SphereSoA:
    return SphereSoA(
        center=np.zeros((0, 3), np.float32), radius=np.zeros((0,), np.float32),
        material=np.zeros((0,), np.int32), light=np.full((0,), -1, np.int32),
        instance=np.zeros((0,), np.int32),
    )


def pack_sphere_rows(center, radius, material, light, instance) -> np.ndarray:
    """[S, 32] shading rows of analytic spheres: [0:3] center, [3] radius,
    [24] material, [25] light, [26] instance, [27] 1.0 (the sphere flag)."""
    rows = np.zeros((radius.shape[0], 32), np.float32)
    rows[:, 0:3] = center
    rows[:, 3] = radius
    rows[:, 24] = material
    rows[:, 25] = light
    rows[:, 26] = instance
    rows[:, 27] = 1.0
    return rows


class LightData(NamedTuple):
    """Emissive-triangle and sphere-light table and its power distribution
    (row slot 15: 0 triangle, 1 sphere)."""

    tri_index: torch.Tensor  # i32 [L]
    area: torch.Tensor  # f32 [L]
    power: torch.Tensor  # f32 [L]
    power_dist: Dist1D  # over L
    num_lights: int  # triangle and sphere lights; 0 => none
    env_probability: float  # P(sample env | sampling a light)
    packed: torch.Tensor  # f32 [L, 16] p0|e1|e2|Le|area|sel_pdf|tri|type


class Environment(NamedTuple):
    """Equirect environment; a 1x1 image is a constant environment. Two
    samplers read it (``render.lights.ENV_SAMPLER``): the 2D CDF tables
    ``dist`` and the hierarchical descent over ``lum_mips``."""

    emission: torch.Tensor  # f32 [He, We, 3]
    dist: Dist2D  # luminance * sin(theta) importance tables
    lum_mips: torch.Tensor  # f32 [rows] flat sum pyramid (pow2 dims, finest first)
    emission_pdf: torch.Tensor  # f32 [He, We, 4] rgb | joint uv pdf


class SceneData(NamedTuple):
    """Everything the path tracer reads."""

    geo: GeometrySoA
    materials: DisneyMaterials
    lights: LightData
    env: Environment
    fat_bvh: FatBVH
    # fused per-slot hit payload [L*K, 88] (slot = leaf*K + row): cols 0-31
    # the slot triangle's packed shading row, 32-61 its a/u/v Plucker
    # coefficients (col 32 + f*3 + q), 62 the tri id as f32 (-1 padding),
    # 63 the material's normal-texture id, 64-87 its material row
    slot_payload: torch.Tensor
    tri_features: torch.Tensor  # f32 [T, 10, 4] Plucker blocks (ops/mxu.py)
    # fused per-triangle hit payload [T, 56] for the dense tracers (their
    # hits carry triangle ids, not slots): cols 0-31 the packed shading
    # row, 32-55 the triangle's material row
    tri_payload: torch.Tensor
    bvh: BVHData  # the LBVH (ops/bvh.py, tracer="bvh")
    textures: TextureStack  # render/texture.py; base_res 1 = untextured
    spheres: SphereSoA  # analytic spheres (ops/spheres.py)
    media: MediumData  # volumes (render/medium.py); a 1^3 brick = none
    # per-instance motion transform f32 [I, 3, 4]: current world -> the
    # previous frame's world (the G-buffer's motion vectors); identity rows
    # when the scene was flattened without a prev_time
    instance_motion: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.geo.positions.device


def to_device(tree, device):
    """numpy leaves of a (nested) NamedTuple -> torch tensors on ``device``;
    Python scalars stay as they are."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(x, device) for x in tree))
    if isinstance(tree, np.ndarray):
        return torch.tensor(tree, device=device)
    return tree


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def default_material_arrays(n: int) -> dict:
    return dict(
        base_color=np.full((n, 3), 0.8, np.float32),
        emission=np.zeros((n, 3), np.float32),
        metallic=np.zeros((n,), np.float32),
        roughness=np.ones((n,), np.float32),
        anisotropic=np.zeros((n,), np.float32),
        subsurface=np.zeros((n,), np.float32),
        clearcoat=np.zeros((n,), np.float32),
        clearcoat_gloss=np.ones((n,), np.float32),
        transmission=np.zeros((n,), np.float32),
        eta=np.full((n,), 1.5, np.float32),
        base_color_tex=np.full((n,), -1, np.int32),
        emission_tex=np.full((n,), -1, np.int32),
        rough_metal_tex=np.full((n,), -1, np.int32),
        normal_tex=np.full((n,), -1, np.int32),
        alpha_tex=np.full((n,), -1, np.int32),
        alpha_cutoff=np.full((n,), 0.5, np.float32),
    )


def finalize_materials(arrs: dict) -> DisneyMaterials:
    """Field dict (numpy) -> DisneyMaterials (numpy) with the packed row."""
    n = arrs["base_color"].shape[0]
    packed = np.zeros((n, 24), np.float32)
    packed[:, 0:3] = arrs["base_color"]
    packed[:, 3:6] = arrs["emission"]
    for i, f in enumerate(MATERIAL_FLOATS):
        packed[:, 6 + i] = arrs[f]
    for i, f in enumerate(MATERIAL_TEXTURES):
        packed[:, 14 + i] = arrs[f]
    packed[:, 19] = arrs["alpha_cutoff"]
    return DisneyMaterials(packed=packed, **arrs)


def env_mip_dims(he: int, we: int):
    """Level dims of the env luminance pyramid, finest first:
    [(H2, W2), (H2/2, W2/2), ..., (1, 1)] with H2, W2 the next powers of 2."""
    h2 = 1
    while h2 < he:
        h2 *= 2
    w2 = 1
    while w2 < we:
        w2 *= 2
    dims = [(h2, w2)]
    while dims[-1] != (1, 1):
        h, w = dims[-1]
        dims.append((max(h // 2, 1), max(w // 2, 1)))
    return dims


def build_env_mips(lum: np.ndarray) -> np.ndarray:
    """luminance [He, We] -> flat SUM pyramid (numpy f32): nearest-resampled
    into the pow2 canvas, weighted by each row's sin(theta) at the finest
    level, then 2x2 sums, so a child's weight at any level is the energy it
    contains (what the hierarchical descent splits on)."""
    he, we = lum.shape
    dims = env_mip_dims(he, we)
    h2, w2 = dims[0]
    ys = (np.arange(h2) * he) // h2
    xs = (np.arange(w2) * we) // w2
    base = np.zeros((h2, w2), np.float32)
    base[:, :] = lum[ys][:, xs]
    base *= np.sin(np.pi * (np.arange(h2) + 0.5) / h2)[:, None]
    levels = [base]
    for h, w in dims[1:]:
        prev = levels[-1]
        ph, pw = prev.shape
        levels.append(prev.reshape(h, ph // h, w, pw // w).sum(axis=(1, 3)))
    return np.concatenate([lv.reshape(-1) for lv in levels])


def pack_emission_pdf(emission, dist: Dist2D) -> np.ndarray:
    """[He, We, 4] rgb radiance | the dist2d joint uv pdf: the escape path's
    one-gather row."""
    joint = np.asarray(dist.marginal.pdf)[:, None] * np.asarray(dist.cond_pdf)
    return np.concatenate([np.asarray(emission), joint[..., None]], axis=-1)


def make_environment(emission, dist: Dist2D, lum_mips) -> Environment:
    """Environment (numpy) with the fused emission+pdf rows."""
    emission = np.asarray(emission, np.float32)
    return Environment(emission=emission, dist=dist,
                       lum_mips=np.asarray(lum_mips, np.float32),
                       emission_pdf=pack_emission_pdf(emission, dist))


def constant_environment(rgb=(0.0, 0.0, 0.0)) -> Environment:
    img = np.broadcast_to(np.asarray(rgb, np.float32), (1, 1, 3)).copy()
    return make_environment(img, build_dist2d(np.ones((1, 1), np.float32)),
                            build_env_mips(np.ones((1, 1), np.float32)))


def build_geometry(positions, normals, uvs, indices, tri_material,
                   tri_instance=None):
    """Pad host geometry to the reference's multiples (numpy)."""
    v = positions.shape[0]
    t = indices.shape[0]
    vp = max(_pad_to(v, VERT_PAD), VERT_PAD)
    tp = max(_pad_to(t, TRI_PAD), TRI_PAD)
    pos = np.zeros((vp, 3), np.float32)
    pos[:v] = positions
    nrm = np.zeros((vp, 3), np.float32)
    nrm[:v] = normals
    nrm[v:, 2] = 1.0
    uv = np.zeros((vp, 2), np.float32)
    uv[:v] = uvs
    idx = np.zeros((tp, 3), np.int32)
    idx[:t] = indices
    mat = np.full((tp,), -1, np.int32)
    mat[:t] = tri_material
    inst = np.zeros((tp,), np.int32)
    if tri_instance is not None:
        inst[:t] = tri_instance
    return pos, nrm, uv, idx, mat, inst


def pack_tri_rows(positions, normals, uvs, indices, tri_material, tri_light,
                  tri_instance):
    """[T, 32] one-gather shading rows (host numpy)."""
    p0 = positions[indices[:, 0]]
    rows = np.zeros((indices.shape[0], 32), np.float32)
    rows[:, 0:3] = p0
    rows[:, 3:6] = positions[indices[:, 1]] - p0
    rows[:, 6:9] = positions[indices[:, 2]] - p0
    rows[:, 9:12] = normals[indices[:, 0]]
    rows[:, 12:15] = normals[indices[:, 1]]
    rows[:, 15:18] = normals[indices[:, 2]]
    rows[:, 18:20] = uvs[indices[:, 0]]
    rows[:, 20:22] = uvs[indices[:, 1]]
    rows[:, 22:24] = uvs[indices[:, 2]]
    rows[:, 24] = tri_material
    rows[:, 25] = tri_light
    rows[:, 26] = tri_instance
    return rows


def build_tri_payload(packed_tri, materials_packed) -> np.ndarray:
    """[T, 56] dense-tracer payload (numpy): each packed shading row beside
    its material row (material -1, the padding, takes row 0)."""
    rows = np.asarray(packed_tri, np.float32)
    mat_ids = np.maximum(rows[:, 24].astype(np.int64), 0)
    return np.concatenate([rows, np.asarray(materials_packed)[mat_ids]], axis=1)


def triangle_areas(positions, indices):
    p0 = positions[indices[:, 0]]
    e1 = positions[indices[:, 1]] - p0
    e2 = positions[indices[:, 2]] - p0
    return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)


def build_lights(positions, indices, tri_material, emission,
                 env_probability: float = 0.0, sphere_center=None,
                 sphere_radius=None, sphere_material=None):
    """Emissive triangles and emissive analytic spheres, and their power
    distribution (numpy). Sphere rows: [0:3] center, [3] radius, [12]
    4 pi r^2, [14] -2 - sid, [15] 1.0. Returns (LightData, tri_light[T],
    sphere_light[S])."""
    t = indices.shape[0]
    tri_light = np.full((t,), -1, np.int32)
    valid = tri_material >= 0
    lum = np.zeros((t,), np.float32)
    lum[valid] = emission[tri_material[valid]].mean(axis=-1)
    light_tris = np.nonzero(lum > 0.0)[0].astype(np.int32)
    nl = len(light_tris)
    s = 0 if sphere_radius is None else sphere_radius.shape[0]
    sphere_light = np.full((s,), -1, np.int32)
    light_sph = np.zeros((0,), np.int32)
    if s:
        light_sph = np.nonzero(
            (emission[np.maximum(sphere_material, 0)].mean(axis=-1) > 0) & (sphere_radius > 0)
        )[0].astype(np.int32)
    ns = len(light_sph)
    ntot = nl + ns
    npad = max(_pad_to(max(ntot, 1), 8), 8)
    tri_light[light_tris] = np.arange(nl, dtype=np.int32)
    sphere_light[light_sph] = nl + np.arange(ns, dtype=np.int32)
    areas = np.zeros((npad,), np.float32)
    powers = np.zeros((npad,), np.float32)
    tri_idx = np.zeros((npad,), np.int32)
    packed = np.zeros((npad, 16), np.float32)
    if nl:
        a = triangle_areas(positions, indices[light_tris])
        areas[:nl] = a
        powers[:nl] = lum[light_tris] * a * np.pi
        tri_idx[:nl] = light_tris
        p0 = positions[indices[light_tris, 0]]
        packed[:nl, 0:3] = p0
        packed[:nl, 3:6] = positions[indices[light_tris, 1]] - p0
        packed[:nl, 6:9] = positions[indices[light_tris, 2]] - p0
        packed[:nl, 9:12] = emission[tri_material[light_tris]]
    if ns:
        r = sphere_radius[light_sph]
        a = 4.0 * np.pi * r * r
        le = emission[sphere_material[light_sph]]
        areas[nl:ntot] = a
        powers[nl:ntot] = le.mean(axis=-1) * a * np.pi
        tri_idx[nl:ntot] = -2 - light_sph
        packed[nl:ntot, 0:3] = sphere_center[light_sph]
        packed[nl:ntot, 3] = r
        packed[nl:ntot, 9:12] = le
        packed[nl:ntot, 15] = 1.0
    weights = powers if powers.sum() > 0 else np.ones((npad,), np.float32)
    power_dist = build_dist1d(weights)
    packed[:, 12] = areas
    packed[:, 13] = power_dist.pdf / npad
    packed[:, 14] = tri_idx
    return (
        LightData(
            tri_index=tri_idx, area=areas, power=powers, power_dist=power_dist,
            num_lights=ntot, env_probability=float(np.float32(env_probability)),
            packed=packed,
        ),
        tri_light,
        sphere_light,
    )
