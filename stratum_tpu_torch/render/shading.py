"""Shading points and material rows from fused hit payloads (counterpart of
stratum_tpu/render/shading.py:21-33, 49-134, 166-180, 237-268). Texture,
normal-map and analytic-sphere terms are not on the port's path: scenes
that need them are refused at build time (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stratum_tpu_torch.core import math as smath


class ShadingPoint(NamedTuple):
    position: torch.Tensor  # f32 [N, 3]
    geom_normal: torch.Tensor  # f32 [N, 3] oriented toward the incoming ray
    shading_normal: torch.Tensor  # f32 [N, 3] same orientation
    light: torch.Tensor  # i32 [N] light row (-1 if none or a miss)
    front_face: torch.Tensor  # bool [N]


def shading_point_from_row(row, tri, bary, direction) -> ShadingPoint:
    """ShadingPoint from a gathered [N, 32] packed shading row
    (p0|e1|e2|n0|n1|n2|uv0|uv1|uv2|material|light|instance|pad); ``tri``
    only masks misses (-1)."""
    p0, e1, e2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    u = bary[..., 0:1]
    v = bary[..., 1:2]
    w = 1.0 - u - v
    ng = smath.normalize(smath.cross(e1, e2))
    ns = smath.normalize(w * row[..., 9:12] + u * row[..., 12:15] + v * row[..., 15:18])
    ns = torch.where(smath.dot(ns, ng)[..., None] < 0.0, -ns, ns)
    front = smath.dot(direction, ng) < 0.0
    sign = torch.where(front, 1.0, -1.0)[..., None]
    return ShadingPoint(
        position=p0 + u * e1 + v * e2,
        geom_normal=ng * sign,
        shading_normal=ns * sign,
        light=torch.where(tri >= 0, row[..., 25].to(torch.int32), -1),
        front_face=front,
    )


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
