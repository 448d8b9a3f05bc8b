"""Shading points and material rows from fused hit payloads, and the
texture terms (counterpart of stratum_tpu/render/shading.py:21-268),
analytic-sphere rows included.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.render import texture as stex


class ShadingPoint(NamedTuple):
    position: torch.Tensor  # f32 [N, 3]
    geom_normal: torch.Tensor  # f32 [N, 3] oriented toward the incoming ray
    shading_normal: torch.Tensor  # f32 [N, 3] same orientation
    light: torch.Tensor  # i32 [N] light row (-1 if none or a miss)
    front_face: torch.Tensor  # bool [N]
    # texture inputs, filled only when asked for (``textured=True``)
    uv: torch.Tensor | None = None  # f32 [N, 2]
    material: torch.Tensor | None = None  # i32 [N] material row (-1 on a miss)
    tangent: torch.Tensor | None = None  # f32 [N, 3] uv-aligned (normal maps)
    uv_area: torch.Tensor | None = None  # f32 [N] uv area per world area


def shading_point_from_row(row, tri, bary, direction, textured: bool = False,
                           spheres: bool = False) -> ShadingPoint:
    """ShadingPoint from a gathered [N, 32] packed shading row
    (p0|e1|e2|n0|n1|n2|uv0|uv1|uv2|material|light|instance|pad); ``tri``
    only masks misses (-1). ``textured`` adds what the texture terms read:
    the interpolated uv, the material row, the dP/du tangent and the uv
    area per world area (the ray-cone LOD's input). ``spheres`` (a scene
    with analytic spheres) reads rows whose slot 27 is set as spheres:
    center p0, radius at slot 3, and ``bary`` the hit's (phi / 2pi,
    theta / pi), from which position, normal, uv, tangent and uv area
    follow."""
    p0, e1, e2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    u = bary[..., 0:1]
    v = bary[..., 1:2]
    w = 1.0 - u - v
    ng_raw = smath.cross(e1, e2)
    ng = smath.normalize(ng_raw)
    ns = smath.normalize(w * row[..., 9:12] + u * row[..., 12:15] + v * row[..., 15:18])
    ns = torch.where(smath.dot(ns, ng)[..., None] < 0.0, -ns, ns)
    position = p0 + u * e1 + v * e2
    if spheres:
        is_sphere = row[..., 27] > 0.5
        sph_n = smath.spherical_uv_to_cartesian(bary)
        radius = row[..., 3]
        sph3 = is_sphere[..., None]
        position = torch.where(sph3, p0 + sph_n * radius[..., None], position)
        ng = torch.where(sph3, sph_n, ng)
        ns = torch.where(sph3, sph_n, ns)
    front = smath.dot(direction, ng) < 0.0
    sign = torch.where(front, 1.0, -1.0)[..., None]
    tex = {}
    if textured:
        t0, t1, t2 = row[..., 18:20], row[..., 20:22], row[..., 22:24]
        duv1, duv2 = t1 - t0, t2 - t0
        det = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
        inv_det = smath.safe_div(1.0, det)
        tangent = (e1 * (duv2[..., 1] * inv_det)[..., None]
                   - e2 * (duv1[..., 1] * inv_det)[..., None])
        t_fallback, _ = smath.make_orthonormal(ns)  # degenerate uvs: any frame
        area = 0.5 * smath.length(ng_raw)
        tex = dict(
            uv=w * t0 + u * t1 + v * t2,
            material=torch.where(tri >= 0, row[..., 24].to(torch.int32), -1),
            tangent=torch.where((torch.abs(det) > 1e-12)[..., None],
                                smath.normalize(tangent), t_fallback),
            uv_area=smath.safe_div(torch.abs(det) * 0.5, torch.clamp(area, min=1e-20)),
        )
        if spheres:
            sph_area = 4.0 * np.pi * radius * radius
            tex.update(
                uv=torch.where(sph3, bary, tex["uv"]),
                tangent=torch.where(sph3, smath.make_orthonormal(sph_n)[0], tex["tangent"]),
                uv_area=torch.where(is_sphere, smath.safe_div(
                    torch.ones_like(sph_area), torch.clamp(sph_area, min=1e-20)), tex["uv_area"]),
            )
    return ShadingPoint(
        position=position,
        geom_normal=ng * sign,
        shading_normal=ns * sign,
        light=torch.where(tri >= 0, row[..., 25].to(torch.int32), -1),
        front_face=front,
        **tex,
    )


def apply_normal_map(sp: ShadingPoint, materials, textures, lod=None, tex_id=None):
    """The shading normal perturbed by the material's tangent-space normal
    map, the tangent re-orthonormalised against it (unchanged where the
    material has none). ``tex_id``: normal-texture ids already gathered (the
    slot payload's col 63), else gathered here by material row."""
    if not textures.uses(stex.SLOT_NORMAL):
        return sp.shading_normal
    if tex_id is None:
        tex_id = materials.normal_tex[torch.clamp(sp.material, min=0).long()]
    tex_id = tex_id.to(torch.int64)
    nm = stex.sample_bilinear(textures, tex_id, sp.uv, lod)
    n_ts = smath.normalize(nm[..., :3] * 2.0 - 1.0)
    n = sp.shading_normal
    t = smath.normalize(sp.tangent - n * smath.dotk(sp.tangent, n))
    b = smath.cross(n, t)
    n_new = smath.normalize(t * n_ts[..., 0:1] + b * n_ts[..., 1:2] + n * n_ts[..., 2:3])
    return torch.where((tex_id >= 0)[..., None], n_new, n)


class MaterialSample(NamedTuple):
    """Per-hit Disney parameters."""

    base_color: torch.Tensor  # [N, 3]
    emission: torch.Tensor  # [N, 3]
    metallic: torch.Tensor  # [N]
    roughness: torch.Tensor  # [N]
    anisotropic: torch.Tensor  # [N]
    subsurface: torch.Tensor  # [N]
    clearcoat: torch.Tensor  # [N]
    clearcoat_gloss: torch.Tensor  # [N]
    transmission: torch.Tensor  # [N]
    eta: torch.Tensor  # [N]


def apply_textures(mat: MaterialSample, materials, textures, material_row, uv,
                   lod=None, u_lod=None, mat_row=None) -> MaterialSample:
    """Constant material parameters times their textures (base color and
    emission rgb; roughness x G and metallic x B of the ORM map). A slot no
    material of the scene binds is not sampled. ``mat_row``: packed
    material rows already gathered (the fused payloads), else gathered here."""
    if mat_row is None:
        mat_row = materials.packed[torch.clamp(material_row, min=0).long()]

    def tap(col):
        return stex.sample_bilinear(textures, mat_row[..., col].to(torch.int64), uv, lod, u_lod)

    if textures.uses(stex.SLOT_BASE_COLOR):
        mat = mat._replace(base_color=mat.base_color * tap(14)[..., :3])
    if textures.uses(stex.SLOT_EMISSION):
        mat = mat._replace(emission=mat.emission * tap(15)[..., :3])
    if textures.uses(stex.SLOT_ROUGH_METAL):
        rm = tap(16)
        mat = mat._replace(
            roughness=torch.clamp(mat.roughness * rm[..., 1], 1e-3, 1.0),
            metallic=torch.clamp(mat.metallic * rm[..., 2], 0.0, 1.0),
        )
    return mat


def load_material(materials, material_row) -> MaterialSample:
    """Material constants of rows ``material_row`` (row -1 reads row 0; the
    caller masks it) through one packed-row gather (shading.py:228-234)."""
    return material_from_row(materials.packed[torch.clamp(material_row, min=0).long()])


def material_from_row(row) -> MaterialSample:
    """MaterialSample from a gathered packed [N, 24] material row."""
    return MaterialSample(
        base_color=row[..., 0:3],
        emission=row[..., 3:6],
        metallic=row[..., 6],
        roughness=row[..., 7],
        anisotropic=row[..., 8],
        subsurface=row[..., 9],
        clearcoat=row[..., 10],
        clearcoat_gloss=row[..., 11],
        transmission=row[..., 12],
        eta=row[..., 13],
    )


def shadow_terminator_factor(ng, ns, wi):
    """Shading-normal shadow-terminator softening (Chiang, Li, Burley 2019):
    G = g + g^2 - g^3 of g = |ng.wi| / (|ns.wi| |ng.ns|); 1 where ns == ng."""
    num = torch.abs(smath.dot(ng, wi))
    den = torch.abs(smath.dot(ns, wi)) * torch.abs(smath.dot(ng, ns))
    g = torch.clamp(smath.safe_div(num, den), 0.0, 1.0)
    return g * (1.0 + g - g * g)


def adjoint_ns_factor(ng, ns, wo, wi):
    """Shading-normal correction of importance transport (Veach 1997 eq.
    5.17): |ns.wo| |ng.wi| / (|ng.wo| |ns.wi|), clamped to [0, 4]
    (shading.py:269-280)."""
    num = torch.abs(smath.dot(ns, wo)) * torch.abs(smath.dot(ng, wi))
    den = torch.abs(smath.dot(ng, wo)) * torch.abs(smath.dot(ns, wi))
    return torch.clamp(smath.safe_div(num, den), 0.0, 4.0)
