"""Analytic sphere intersection (counterpart of stratum_tpu/ops/spheres.py):
every ray tests every sphere as one dense [N, S] quadratic, since scenes
carry few analytic spheres.

Sphere hits come back through the same HitRecord fields as triangles: the
integrator offsets the sphere id by the triangle count (tri >= T is sphere
tri - T), and ``bary`` carries the hit's spherical (u, v) = (phi / 2pi,
theta / pi), from which shading rebuilds position, normal and uv.
"""

from __future__ import annotations

import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.ops.intersect import T_MAX


def sphere_uv(unit_dir):
    """Spherical uv of a unit direction from the sphere center (the
    environment's equirect convention)."""
    return smath.cartesian_to_spherical_uv(unit_dir)


def _roots(center, radius, origin, direction, t_min):
    """(t [N, S] of the nearest root past t_min, disc >= 0 and radius > 0)."""
    oc = origin[:, None, :] - center[None, :, :]  # [N, S, 3]
    b = torch.sum(oc * direction[:, None, :], dim=-1)
    c = torch.sum(oc * oc, dim=-1) - (radius * radius)[None, :]
    disc = b * b - c
    ok = (disc >= 0.0) & (radius > 0.0)[None, :]
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0, t1 = -b - sq, -b + sq
    return torch.where(t0 > t_min, t0, t1), ok


def intersect_spheres(center, radius, origin, direction, t_min=1e-4, t_max=None):
    """Closest analytic sphere hit per ray. center [S, 3], radius [S]
    (radius <= 0 rows never hit) -> (t [N] (T_MAX on a miss), sid [N] (-1
    on a miss), uv [N, 2])."""
    n = origin.shape[0]
    if t_max is None:
        t_max = torch.full((n,), T_MAX, dtype=torch.float32, device=origin.device)
    t, ok = _roots(center, radius, origin, direction, t_min)
    valid = ok & (t > t_min) & (t < t_max[:, None])
    t = torch.where(valid, t, T_MAX)
    sid = torch.argmin(t, dim=1)
    t_best = torch.gather(t, 1, sid[:, None])[:, 0]
    hit = t_best < T_MAX
    sid = torch.where(hit, sid, -1).to(torch.int32)
    p = origin + direction * t_best[:, None]
    safe = torch.clamp(sid, min=0).long()
    r = torch.clamp(radius[safe], min=1e-12)
    uv = sphere_uv((p - center[safe]) / r[:, None])
    return torch.where(hit, t_best, T_MAX), sid, torch.where(hit[:, None], uv, 0.0)


def occluded_spheres(center, radius, origin, direction, t_max, t_min=1e-4):
    """Does any analytic sphere cut the segment?"""
    t, ok = _roots(center, radius, origin, direction, t_min)
    limit = (t_max * (1.0 - 1e-3))[:, None]
    return torch.any(ok & (t > t_min) & (t < limit), dim=1)
