"""Next-event-estimation light sampling (counterpart of
stratum_tpu/render/lights.py:26-36, 174-343): power-weighted emissive
triangles, the environment through its 2D CDF tables (the reference's
``ENV_SAMPLER = "dist2d"``), the env/area split and the MIS pdfs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.core.distribution import sample_dist1d, sample_dist2d

_TWO_PI2 = 2.0 * math.pi * math.pi


class LightSampleRecord(NamedTuple):
    """One NEE candidate per ray; env samples hold a unit direction in
    ``position`` and a solid-angle pdf in ``pdf_area``."""

    position: torch.Tensor  # [N, 3]
    normal: torch.Tensor  # [N, 3]
    radiance: torch.Tensor  # [N, 3]
    pdf_area: torch.Tensor  # [N]
    is_env: torch.Tensor  # bool [N]
    tri: torch.Tensor  # i32 [N] (-1 for env)


def _sin_theta(direction):
    return torch.sqrt(torch.clamp(1.0 - direction[..., 1] * direction[..., 1], min=1e-12))


def _env_texel(scene, direction):
    h, w = scene.env.emission.shape[:2]
    uv = smath.cartesian_to_spherical_uv(direction)
    x = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
    return y, x


def eval_environment(scene, direction):
    """Nearest-texel environment radiance; 1x1 = constant environment."""
    y, x = _env_texel(scene, direction)
    return scene.env.emission[y, x]


def sample_environment(scene, u1, u2):
    """Importance-sample the environment through its 2D tables."""
    uv, pdf_uv = sample_dist2d(scene.env.dist, u1, u2)
    direction = smath.spherical_uv_to_cartesian(uv)
    pdf_w = pdf_uv / (_TWO_PI2 * _sin_theta(direction))
    return direction, eval_environment(scene, direction), pdf_w


def sample_area_light(scene, u_sel, u1, u2) -> LightSampleRecord:
    """Emissive triangle from the power distribution, uniform point on it;
    pdf_area = P(light) / area. One packed-row gather per sample."""
    lights = scene.lights
    li, _, _ = sample_dist1d(lights.power_dist, u_sel)
    li = torch.clamp(li, max=max(lights.num_lights, 1) - 1)
    row = lights.packed[li]
    p0, e1, e2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    b1, b2 = smath.sample_uniform_triangle(u1, u2)
    pos = p0 + e1 * b1[..., None] + e2 * b2[..., None]
    return LightSampleRecord(
        position=pos,
        normal=smath.normalize(smath.cross(e1, e2)),
        radiance=row[..., 9:12],
        pdf_area=row[..., 13] / torch.clamp(row[..., 12], min=1e-12),
        is_env=torch.zeros(pos.shape[:-1], dtype=torch.bool, device=pos.device),
        tri=row[..., 14].to(torch.int32),
    )


def sample_light(scene, u_sel, u1, u2) -> LightSampleRecord:
    """Environment-vs-area split by ``env_probability``."""
    p_env = scene.lights.env_probability
    area = sample_area_light(
        scene,
        torch.clamp((u_sel - p_env) / max(1.0 - p_env, 1e-6), 0.0, 1.0 - 1e-7),
        u1, u2,
    )
    env_dir, env_rad, env_pdf = sample_environment(
        scene, (u_sel / max(p_env, 1e-6)) % 1.0, u1
    )
    if scene.lights.num_lights > 0:
        pick_env, pe = u_sel < p_env, p_env
    else:
        pick_env, pe = torch.ones_like(u_sel, dtype=torch.bool), 1.0
    pe3 = pick_env[..., None]
    return LightSampleRecord(
        position=torch.where(pe3, env_dir, area.position),
        normal=torch.where(pe3, -env_dir, area.normal),
        radiance=torch.where(pe3, env_rad, area.radiance),
        pdf_area=torch.where(pick_env, env_pdf * pe, area.pdf_area * (1.0 - pe)),
        is_env=pick_env,
        tri=torch.where(pick_env, -1, area.tri),
    )


def light_pdf_area(scene, tri, light_row):
    """Area-measure NEE pdf of having sampled triangle light ``light_row``,
    including the env/area split (MIS for emissive hits)."""
    lights = scene.lights
    row = lights.packed[torch.clamp(light_row, min=0).long()]
    p_area_branch = 1.0 - lights.env_probability if lights.num_lights > 0 else 0.0
    pdf = row[..., 13] / torch.clamp(row[..., 12], min=1e-12) * p_area_branch
    return torch.where(light_row >= 0, pdf, 0.0)


def env_eval_and_pdf_w_mis(scene, direction):
    """(radiance, NEE solid-angle pdf) of an escaped direction through one
    gather of the fused [He, We, 4] emission+pdf table."""
    y, x = _env_texel(scene, direction)
    row = scene.env.emission_pdf[y, x]
    pdf_w = row[..., 3] / (_TWO_PI2 * _sin_theta(direction))
    p_env = scene.lights.env_probability if scene.lights.num_lights > 0 else 1.0
    return row[..., 0:3], pdf_w * p_env
