"""Next-event-estimation light sampling (counterpart of
stratum_tpu/render/lights.py): power-weighted emissive triangles and
analytic sphere lights, the environment through its 2D CDF tables or its
luminance mip pyramid (``ENV_SAMPLER``), the env/area split, the MIS pdfs,
and the receiver-aware solid-angle cone sampler of sphere lights.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.core.distribution import dist2d_pdf, sample_dist1d, sample_dist2d
from stratum_tpu_torch.scene.schema import env_mip_dims

_TWO_PI2 = 2.0 * math.pi * math.pi

# environment sampler: "dist2d" = the 2D CDF tables; "mip" = hierarchical
# texel descent over the luminance * sin(theta) sum pyramid. Sampling and
# the MIS pdfs follow it together.
ENV_SAMPLER = "dist2d"


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


def _env_mip_meta(scene):
    he, we = scene.env.emission.shape[:2]
    dims = env_mip_dims(he, we)  # finest first
    offs, row = [], 0
    for h, w in dims:
        offs.append(row)
        row += h * w
    return dims, offs


def _children(flat, off, h, w, by, bx):
    """The four child weights of 2x2 blocks at (by, bx) of a level [h, w];
    a child outside a degenerate (1-wide) level weighs 0."""
    ps = []
    for dy in (0, 1):
        for dx in (0, 1):
            yy = torch.clamp(by + dy, max=h - 1)
            xx = torch.clamp(bx + dx, max=w - 1)
            ok = ((by + dy) < h) & ((bx + dx) < w)
            ps.append(torch.where(ok, flat[off + yy * w + xx], 0.0))
    return ps


def sample_environment_mip(scene, u1, u2):
    """Hierarchical env texel sampling: descend the sum pyramid from its
    1x1 root, at each level picking one of the 2x2 children in proportion
    to its energy with one uniform, rescaled into the chosen child's bin.
    pdf = product of the child probabilities x finest texel count, over uv,
    then to solid angle."""
    flat = scene.env.lum_mips
    dims, offs = _env_mip_meta(scene)
    u = u1
    cy = torch.zeros(u.shape, dtype=torch.int64, device=u.device)
    cx = torch.zeros_like(cy)
    pdf = torch.ones(u.shape, dtype=torch.float32, device=u.device)
    quad = ((0, 1), (1, 0), (1, 1))
    for lvl in range(len(dims) - 2, -1, -1):
        h, w = dims[lvl]
        ph, pw = dims[lvl + 1]
        cy = cy * (h // ph)
        cx = cx * (w // pw)
        ps = _children(flat, offs[lvl], h, w, cy, cx)
        total = ps[0] + ps[1] + ps[2] + ps[3]
        degen = total < 1e-12
        probs = [torch.where(degen, 0.25, p / torch.clamp(total, min=1e-12)) for p in ps]
        sel_y, sel_x = torch.zeros_like(cy), torch.zeros_like(cx)
        p_sel, acc = probs[0], probs[0]
        for j, (dy, dx) in enumerate(quad):
            take = u >= acc
            sel_y = torch.where(take, dy, sel_y)
            sel_x = torch.where(take, dx, sel_x)
            p_sel = torch.where(take, probs[j + 1], p_sel)
            acc = acc + probs[j + 1]
        starts = [torch.zeros_like(u)]
        for j in range(3):
            starts.append(starts[-1] + probs[j])
        bin_lo = starts[0]
        for j, (dy, dx) in enumerate(quad):
            bin_lo = torch.where((sel_y == dy) & (sel_x == dx), starts[j + 1], bin_lo)
        u = torch.clamp((u - bin_lo) / torch.clamp(p_sel, min=1e-12), 0.0, 1.0 - 1e-7)
        cy = cy + sel_y
        cx = cx + sel_x
        pdf = pdf * torch.clamp(p_sel, min=1e-12)
    h0, w0 = dims[0]
    uv = torch.stack([(cx.to(torch.float32) + u) / w0, (cy.to(torch.float32) + u2) / h0], dim=-1)
    direction = smath.spherical_uv_to_cartesian(uv)
    pdf_w = pdf * (h0 * w0) / (_TWO_PI2 * _sin_theta(direction))
    return direction, eval_environment(scene, direction), pdf_w


def environment_mip_pdf_uv(scene, uv):
    """pdf over uv of :func:`sample_environment_mip`: the same pyramid walk,
    multiplying the probability of the child that holds uv."""
    flat = scene.env.lum_mips
    dims, offs = _env_mip_meta(scene)
    pdf = torch.ones(uv.shape[:-1], dtype=torch.float32, device=uv.device)
    for lvl in range(len(dims) - 2, -1, -1):
        h, w = dims[lvl]
        y = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
        x = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
        by, bx = (y // 2) * 2, (x // 2) * 2
        ps = _children(flat, offs[lvl], h, w, by, bx)
        total = ps[0] + ps[1] + ps[2] + ps[3]
        sel = (torch.clamp(y - by, max=1) << 1) | torch.clamp(x - bx, max=1)
        p_sel = torch.where(
            sel == 0, ps[0], torch.where(sel == 1, ps[1], torch.where(sel == 2, ps[2], ps[3]))
        ) / torch.clamp(total, min=1e-12)
        p_sel = torch.where(total < 1e-12, 0.25, p_sel)
        pdf = pdf * torch.clamp(p_sel, min=1e-12)
    h0, w0 = dims[0]
    return pdf * (h0 * w0)


def sample_environment(scene, u1, u2):
    """Importance-sample the environment (2D tables or the mip descent, per
    ENV_SAMPLER) -> (direction, radiance, solid-angle pdf)."""
    if ENV_SAMPLER == "mip":
        return sample_environment_mip(scene, u1, u2)
    uv, pdf_uv = sample_dist2d(scene.env.dist, u1, u2)
    direction = smath.spherical_uv_to_cartesian(uv)
    pdf_w = pdf_uv / (_TWO_PI2 * _sin_theta(direction))
    return direction, eval_environment(scene, direction), pdf_w


def environment_pdf_w(scene, direction):
    """Solid-angle pdf of :func:`sample_environment` (per ENV_SAMPLER)."""
    uv = smath.cartesian_to_spherical_uv(direction)
    if ENV_SAMPLER == "mip":
        pdf_uv = environment_mip_pdf_uv(scene, uv)
    else:
        pdf_uv = dist2d_pdf(scene.env.dist, uv)
    return pdf_uv / (_TWO_PI2 * _sin_theta(direction))


def env_pdf_w_mis(scene, direction):
    """NEE solid-angle pdf of an escaped direction, with the env split."""
    p_env = scene.lights.env_probability if scene.lights.num_lights > 0 else 1.0
    return environment_pdf_w(scene, direction) * p_env


def _light_index(lights, u_sel):
    li, _, _ = sample_dist1d(lights.power_dist, u_sel)
    return torch.clamp(li, max=max(lights.num_lights, 1) - 1)


def sample_area_light(scene, u_sel, u1, u2) -> LightSampleRecord:
    """Emissive primitive from the power distribution and a uniform point on
    it (on a sphere light's surface where the row is one); pdf_area =
    P(light) / area. One packed-row gather per sample."""
    row = scene.lights.packed[_light_index(scene.lights, u_sel)]
    p0, e1, e2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    b1, b2 = smath.sample_uniform_triangle(u1, u2)
    pos = p0 + e1 * b1[..., None] + e2 * b2[..., None]
    nrm = smath.normalize(smath.cross(e1, e2))
    if scene.spheres.num_spheres > 0:
        sph3 = (row[..., 15] > 0.5)[..., None]
        sdir = smath.sample_uniform_sphere(u1, u2)
        pos = torch.where(sph3, p0 + sdir * row[..., 3:4], pos)
        nrm = torch.where(sph3, sdir, nrm)
    return LightSampleRecord(
        position=pos,
        normal=nrm,
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
    gather of the fused [He, We, 4] emission+pdf table; under the mip
    sampler, whose pdf is not the tables', the two apart."""
    if ENV_SAMPLER == "mip":
        return eval_environment(scene, direction), env_pdf_w_mis(scene, direction)
    y, x = _env_texel(scene, direction)
    row = scene.env.emission_pdf[y, x]
    pdf_w = row[..., 3] / (_TWO_PI2 * _sin_theta(direction))
    p_env = scene.lights.env_probability if scene.lights.num_lights > 0 else 1.0
    return row[..., 0:3], pdf_w * p_env


def _sphere_cone(lights, row, ref_pos):
    """(solid-angle pdf of the cone sampler, cos of the cone's half angle,
    squared distance to the center) of sphere-light rows seen from
    ``ref_pos``."""
    center, radius = row[..., 0:3], row[..., 3]
    d2 = smath.length_squared(center - ref_pos)
    sin2_max = torch.clamp(radius * radius / torch.clamp(d2, min=1e-20), 0.0, 1.0)
    cos_max = smath.safe_sqrt(1.0 - sin2_max)
    p_area_branch = 1.0 - lights.env_probability if lights.num_lights > 0 else 0.0
    pdf_w = row[..., 13] / torch.clamp(smath.TWO_PI * (1.0 - cos_max), min=1e-9) * p_area_branch
    return pdf_w, cos_max, d2


def sample_sphere_light_cone(scene, ref_pos, u_sel, u1, u2):
    """Receiver-aware NEE: a sphere light samples the cone of directions it
    subtends from ``ref_pos`` instead of its area (outside the sphere and
    past the small-angle limit); triangle and env samples are
    :func:`sample_light`'s. -> (LightSampleRecord, pdf_is_w [N] bool):
    where pdf_is_w, ``pdf_area`` holds the solid-angle pdf."""
    base = sample_light(scene, u_sel, u1, u2)
    lights = scene.lights
    p_env = lights.env_probability
    u_area = torch.clamp((u_sel - p_env) / max(1.0 - p_env, 1e-6), 0.0, 1.0 - 1e-7)
    row = lights.packed[_light_index(lights, u_area)]
    is_sphere = (row[..., 15] > 0.5) & ~base.is_env
    center, radius = row[..., 0:3], row[..., 3]
    pdf_w, cos_max, d2 = _sphere_cone(lights, row, ref_pos)
    to_c = center - ref_pos
    d = torch.sqrt(torch.clamp(d2, min=1e-20))
    inside = d2 <= radius * radius * 1.0001
    cos_t = 1.0 - u1 * (1.0 - cos_max)
    sin_t = smath.safe_sqrt(1.0 - cos_t * cos_t)
    phi = smath.TWO_PI * u2
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
    wi = smath.to_world(local, to_c / d[..., None])
    # the near intersection along wi
    b = smath.dot(-to_c, wi)
    t_hit = -b - torch.sqrt(torch.clamp(b * b - (d2 - radius * radius), min=0.0))
    pos = ref_pos + wi * t_hit[..., None]
    use_cone = is_sphere & ~inside & (cos_max < 1.0 - 1e-7)
    cone3 = use_cone[..., None]
    return LightSampleRecord(
        position=torch.where(cone3, pos, base.position),
        normal=torch.where(cone3, smath.normalize(pos - center), base.normal),
        radiance=base.radiance,
        pdf_area=torch.where(use_cone, pdf_w, base.pdf_area),
        is_env=base.is_env,
        tri=base.tri,
    ), use_cone


def sphere_cone_pdf_w(scene, ref_pos, light_row):
    """Solid-angle pdf with which :func:`sample_sphere_light_cone` yields a
    direction onto sphere light ``light_row`` from ``ref_pos`` (MIS of a
    BSDF ray that hits a sphere emitter) -> (pdf_w, usable)."""
    row = scene.lights.packed[torch.clamp(light_row, min=0).long()]
    pdf_w, cos_max, d2 = _sphere_cone(scene.lights, row, ref_pos)
    radius = row[..., 3]
    usable = ((row[..., 15] > 0.5) & (light_row >= 0) & (d2 > radius * radius * 1.0001)
              & (cos_max < 1.0 - 1e-7))
    return pdf_w, usable
