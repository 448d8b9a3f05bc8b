"""Heterogeneous participating media: delta and ratio tracking on dense
grids (counterpart of stratum_tpu/render/medium.py).

Every medium is resampled to one f16 density brick [K, R, R, R] with a
per-medium majorant; free flight is Woodcock (delta) tracking inside each
medium's world box, shadow segments take ratio-tracking transmittance. Each
volume slot takes exactly MAX_NULL_COLLISIONS steps and draws on every
step, as the reference's ``lax.scan`` does, so the RNG stream is the
reference's. Slots past the last one in use (``MediumData.slots_used``)
are inactive on every lane: their steps would only advance the RNG
counter, which one ``skip`` does for them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.core import rng as srng

MAX_VOLUMES = 8
GRID_RES = 64  # default brick resolution; build_media adapts up to MAX_RES
MAX_RES = 128
MAX_NULL_COLLISIONS = 64


class MediumData(NamedTuple):
    """All volumes of a scene (dense bricks). Slot majorant 0 = unused."""

    density: torch.Tensor  # f16 [K, R, R, R] extinction sigma_t, (z, y, x)
    albedo: torch.Tensor  # f32 [K, 3] single-scattering albedo
    g: torch.Tensor  # f32 [K] HG anisotropy
    box_lo: torch.Tensor  # f32 [K, 3] world box
    box_hi: torch.Tensor  # f32 [K, 3]
    majorant: torch.Tensor  # f32 [K]
    slots_used: int  # slots 0..slots_used-1 may be active (host value)

    @property
    def num_slots(self) -> int:
        return self.majorant.shape[0]


def empty_media() -> MediumData:
    """No media: a 1^3 brick (``density.shape[1] == 1`` means none)."""
    k = MAX_VOLUMES
    return MediumData(
        density=np.zeros((k, 1, 1, 1), np.float16),
        albedo=np.ones((k, 3), np.float32),
        g=np.zeros((k,), np.float32),
        box_lo=np.zeros((k, 3), np.float32),
        box_hi=np.zeros((k, 3), np.float32),
        majorant=np.zeros((k,), np.float32),
        slots_used=0,
    )


def _resample_grid(d: np.ndarray, r: int) -> np.ndarray:
    """Resample [Dz, Dy, Dx] -> [r, r, r]: a larger axis box-averages each
    target cell's source footprint, a smaller one is sampled linearly at
    the cell centers."""
    out = d.astype(np.float32)
    for axis in range(3):
        n = out.shape[axis]
        if n == r:
            continue
        out = np.moveaxis(out, axis, 0)
        if n > r:
            edges = (np.arange(r + 1) * n) // r
            sums = np.add.reduceat(out, edges[:-1], axis=0)
            cnt = np.diff(edges).astype(np.float32)
            out = sums / cnt.reshape((r,) + (1,) * (out.ndim - 1))
        else:
            pos = (np.arange(r) + 0.5) * n / r - 0.5
            i0 = np.clip(np.floor(pos).astype(np.int64), 0, n - 1)
            i1 = np.minimum(i0 + 1, n - 1)
            f = np.clip(pos - i0, 0.0, 1.0).reshape((r,) + (1,) * (out.ndim - 1))
            out = out[i0] * (1.0 - f) + out[i1] * f
        out = np.moveaxis(out, 0, axis)
    return out


def build_media(volumes: list, grid_res: int | None = None) -> MediumData:
    """volumes: dicts with density (numpy [Dz, Dy, Dx]), box_lo, box_hi,
    albedo, g -> MediumData (numpy). The bricks share one resolution: the
    largest source side's next power of two in [GRID_RES, MAX_RES], unless
    ``grid_res`` pins it."""
    if not volumes:
        return empty_media()
    k = MAX_VOLUMES
    if grid_res is None:
        max_dim = max(max(np.asarray(v["density"]).shape[:3]) for v in volumes[:k])
        r = GRID_RES
        while r < max_dim and r < MAX_RES:
            r *= 2
    else:
        r = grid_res
    density = np.zeros((k, r, r, r), np.float16)
    albedo = np.ones((k, 3), np.float32)
    g = np.zeros((k,), np.float32)
    box_lo = np.zeros((k, 3), np.float32)
    box_hi = np.zeros((k, 3), np.float32)
    majorant = np.zeros((k,), np.float32)
    for i, v in enumerate(volumes[:k]):
        density[i] = _resample_grid(np.asarray(v["density"], np.float32), r).astype(np.float16)
        albedo[i] = np.asarray(v.get("albedo", (1.0, 1.0, 1.0)), np.float32)
        g[i] = float(v.get("g", 0.0))
        box_lo[i] = np.asarray(v["box_lo"], np.float32)
        box_hi[i] = np.asarray(v["box_hi"], np.float32)
        # the majorant bounds the f16 brick the tracker samples
        majorant[i] = float(density[i].astype(np.float32).max())
    used = np.nonzero(majorant > 0)[0]
    return MediumData(density=density, albedo=albedo, g=g, box_lo=box_lo, box_hi=box_hi,
                      majorant=majorant, slots_used=int(used[-1]) + 1 if used.size else 0)


def density_at(media: MediumData, slot, p):
    """Nearest-cell density at world points p [N, 3] in the box of
    ``slot`` (an int, or per-lane [N]); 0 outside the box."""
    lo, hi = media.box_lo[slot], media.box_hi[slot]
    r = media.density.shape[1]
    q = (p - lo) / torch.clamp(hi - lo, min=1e-9)
    inside = torch.all((q >= 0.0) & (q <= 1.0), dim=-1)
    idx = torch.clamp((q * r).to(torch.int64), 0, r - 1)
    if isinstance(slot, int):
        d = media.density[slot][idx[..., 2], idx[..., 1], idx[..., 0]]
    else:
        d = media.density[slot.long(), idx[..., 2], idx[..., 1], idx[..., 0]]
    return torch.where(inside, d.to(torch.float32), 0.0)


def hg_phase(g, cos_theta):
    """Henyey-Greenstein phase value; ``cos_theta`` between the propagation
    direction and the outgoing one (forward = +1). It is its own
    solid-angle pdf under :func:`sample_hg`."""
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    return smath.INV_4PI * (1.0 - g * g) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=1e-12)), min=1e-12)


def sample_hg(g, wo, u1, u2):
    """Sample the HG phase about the propagation direction -wo -> (wi, pdf)."""
    iso = torch.abs(g) < 1e-3
    safe_g = torch.where(iso, 1e-3, g)
    sq = (1.0 - safe_g * safe_g) / (1.0 - safe_g + 2.0 * safe_g * u1)
    cos_t = torch.where(iso, 1.0 - 2.0 * u1,
                        (1.0 + safe_g * safe_g - sq * sq) / (2.0 * safe_g))
    sin_t = smath.safe_sqrt(1.0 - cos_t * cos_t)
    phi = smath.TWO_PI * u2
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
    return smath.to_world(local, -wo), hg_phase(g, cos_t)


def _segment_overlap(media: MediumData, origin, direction, t_max):
    """Entry and exit [N, K] of each ray segment [0, t_max] with each
    volume box (both 0 where they miss or the slot is unused)."""
    inv_d = torch.where(torch.abs(direction) > 1e-20, 1.0 / direction,
                        torch.sign(direction) * 1e20 + 1e20)
    o, iv = origin[:, None, :], inv_d[:, None, :]
    t0 = (media.box_lo[None] - o) * iv
    t1 = (media.box_hi[None] - o) * iv
    tn = torch.clamp(torch.amax(torch.minimum(t0, t1), dim=-1), min=0.0)
    tf = torch.minimum(torch.amin(torch.maximum(t0, t1), dim=-1), t_max[:, None])
    hit = (tn < tf) & (media.majorant[None] > 0)
    return torch.where(hit, tn, 0.0), torch.where(hit, tf, 0.0)


def sample_free_flight(media: MediumData, origin, direction, t_max, st):
    """Delta tracking through the volumes along [0, t_max], nearest entry
    first (volumes do not overlap) -> (t_scatter [N] (inf: none), slot [N],
    weight [N, 3] (the albedo where a lane scattered, else 1), st)."""
    n = origin.shape[0]
    f32 = dict(dtype=torch.float32, device=origin.device)
    t0s, t1s = _segment_overlap(media, origin, direction, t_max)
    order = torch.argsort(torch.where(t1s > t0s, t0s, float("inf")), dim=1, stable=True)
    t_scatter = torch.full((n,), float("inf"), **f32)
    slot_out = torch.full((n,), -1, dtype=torch.int64, device=origin.device)
    for k in range(media.slots_used):
        slot = order[:, k]
        t0 = torch.gather(t0s, 1, slot[:, None])[:, 0]
        t1 = torch.gather(t1s, 1, slot[:, None])[:, 0]
        maj = torch.clamp(media.majorant[slot], min=1e-9)
        alive = (t1 > t0) & (media.majorant[slot] > 0) & ~torch.isfinite(t_scatter)
        t = t0
        scat_t = torch.full((n,), float("inf"), **f32)
        for _ in range(MAX_NULL_COLLISIONS):
            u, st = srng.next_floats(st, 2)
            t = t - torch.log(1.0 - u[:, 0]) / maj
            inside = t < t1
            real = u[:, 1] < density_at(media, slot, origin + direction * t[:, None]) / maj
            scat_t = torch.where(alive & inside & real, t, scat_t)
            alive = alive & inside & ~real
        newly = torch.isfinite(scat_t) & ~torch.isfinite(t_scatter)
        t_scatter = torch.where(newly, scat_t, t_scatter)
        slot_out = torch.where(newly, slot, slot_out)
    st = srng.skip(st, 2 * MAX_NULL_COLLISIONS * (media.num_slots - media.slots_used))
    weight = torch.where(torch.isfinite(t_scatter)[:, None],
                         media.albedo[torch.clamp(slot_out, min=0)], 1.0)
    return t_scatter, slot_out.to(torch.int32), weight, st


def transmittance(media: MediumData, origin, direction, t_max, st):
    """Ratio-tracking transmittance along shadow segments -> (T [N], st)."""
    n = origin.shape[0]
    t0s, t1s = _segment_overlap(media, origin, direction, t_max)
    trans = torch.ones((n,), dtype=torch.float32, device=origin.device)
    for k in range(media.slots_used):
        t0, t1 = t0s[:, k], t1s[:, k]
        maj = torch.clamp(media.majorant[k], min=1e-9)
        alive = (t1 > t0) & (media.majorant[k] > 0)
        t = t0
        for _ in range(MAX_NULL_COLLISIONS):
            u, st = srng.next_float(st)
            t = t - torch.log(1.0 - u) / maj
            inside = t < t1
            ratio = 1.0 - density_at(media, k, origin + direction * t[:, None]) / maj
            trans = torch.where(alive & inside, trans * torch.clamp(ratio, min=0.0), trans)
            alive = alive & inside & (trans > 1e-5)
    return trans, srng.skip(st, MAX_NULL_COLLISIONS * (media.num_slots - media.slots_used))
