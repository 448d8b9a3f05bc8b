"""ReSTIR direct illumination: RIS with temporal and spatial reservoir reuse
(counterpart of stratum_tpu/render/restir.py).

Per frame: the first hits at jittered pixel positions; ``candidates`` light
samples streamed into a fresh reservoir with target p_hat = luminance of
the unshadowed contribution; the previous frame's reservoir merged in
(fetched at this hit's pixel in ``prev_view`` when given, its history M
capped at history_limit x candidates); ``spatial_taps`` random neighbours
of the same world-space hash-grid cell merged in; one shadow ray shades the
winner. The result is direct lighting plus directly visible emission and
environment.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.core import reservoir as sres
from stratum_tpu_torch.core import rng as srng
from stratum_tpu_torch.ops import hashgrid as shg
from stratum_tpu_torch.ops.intersect import T_MAX, ray_offset
from stratum_tpu_torch.render import camera as scamera
from stratum_tpu_torch.render import lights as slights
from stratum_tpu_torch.render.integrator import (
    RenderConfig,
    _bsdf_fns,
    _trace_fns,
    check_supported,
)
from stratum_tpu_torch.render.lighttrace import hit_shading_point, pixel_index
from stratum_tpu_torch.render.shading import apply_textures, load_material

_RESTIR_STREAM = 0xC0FFEE11
_ENV_DIST = T_MAX * 0.5


class RestirState(NamedTuple):
    """Per-pixel reservoirs carried across frames."""

    light_pos: torch.Tensor  # [N, 3]
    light_normal: torch.Tensor  # [N, 3]
    light_radiance: torch.Tensor  # [N, 3]
    is_env: torch.Tensor  # bool [N]
    target_pdf: torch.Tensor  # [N]
    total_weight: torch.Tensor  # [N]
    m: torch.Tensor  # [N]


def init_restir(num_pixels: int, device="cuda") -> RestirState:
    """Empty reservoirs on ``device`` (the card unless the caller asks for
    the CPU)."""
    z3 = torch.zeros((num_pixels, 3), dtype=torch.float32, device=device)
    z = torch.zeros((num_pixels,), dtype=torch.float32, device=device)
    return RestirState(z3, z3, z3, torch.zeros((num_pixels,), dtype=torch.bool, device=device),
                       z, z, z)


def _pack_state(s: RestirState) -> torch.Tensor:
    """[N, 16] rows, so a history or neighbour fetch is one gather."""
    n = s.m.shape[0]
    return torch.cat([
        s.light_pos, s.light_normal, s.light_radiance,
        s.is_env.to(torch.float32)[:, None], s.target_pdf[:, None], s.total_weight[:, None],
        s.m[:, None], torch.zeros((n, 3), dtype=torch.float32, device=s.m.device),
    ], dim=-1)


def _unpack_state(p: torch.Tensor) -> RestirState:
    return RestirState(light_pos=p[:, 0:3], light_normal=p[:, 3:6], light_radiance=p[:, 6:9],
                       is_env=p[:, 9] > 0.5, target_pdf=p[:, 10], total_weight=p[:, 11],
                       m=p[:, 12])


def _state_of(res: sres.Reservoir) -> RestirState:
    s = res.sample
    return RestirState(light_pos=s["pos"], light_normal=s["nrm"], light_radiance=s["rad"],
                       is_env=s["env"], target_pdf=res.target_pdf,
                       total_weight=res.total_weight, m=res.m)


def restir_di(scene, view, cfg: RenderConfig, state: RestirState, seed, candidates: int = 4,
              history_limit: float = 20.0, prev_view=None, spatial_taps: int = 0,
              hash_jitter: bool = False):
    """One ReSTIR DI frame -> (new state, direct radiance [H, W, 3]).
    ``prev_view``: the view ``state`` was rendered with (temporal
    reprojection); ``spatial_taps`` > 0 merges that many same-cell
    neighbours; ``hash_jitter`` jitters each query in its tangent plane by
    up to a cell."""
    px, py = scamera.pixel_grid(cfg.width, cfg.height, scene.device)
    hist_packed = _pack_state(state) if prev_view is not None else None
    new_state, direct = _restir_flat(scene, view, cfg, state, hist_packed, px, py, seed,
                                     candidates, history_limit, prev_view, spatial_taps,
                                     hash_jitter)
    return new_state, direct.reshape(cfg.height, cfg.width, 3)


def _restir_flat(scene, view, cfg: RenderConfig, state: RestirState, hist_packed, px, py,
                 seed, candidates: int, history_limit: float, prev_view, spatial_taps: int,
                 hash_jitter: bool = False):
    """ReSTIR DI over the lanes (px, py), ``state`` rows aligned with them;
    temporal reprojection reads the whole frame's packed table
    ``hist_packed`` -> (new state rows, direct radiance rows [n, 3])."""
    check_supported(cfg)
    dev = scene.device
    bsdf_eval, _ = _bsdf_fns(cfg)
    trace_closest, _, trace_occluded, _ = _trace_fns(scene, cfg)
    seed_word = (_RESTIR_STREAM + (torch.as_tensor(seed).to(torch.int64) & 0xFFFFFFFF)) \
        & 0xFFFFFFFF
    st = srng.rng_init(px, py, seed_word.to(dev))
    u, st = srng.next_floats(st, 2)
    origin, direction = scamera.generate_rays(view, px, py, u, cfg.width, cfg.height)
    n = origin.shape[0]
    hit = trace_closest(origin, direction)
    sp = hit_shading_point(scene, hit, direction)
    mat = load_material(scene.materials, sp.material)
    if scene.textures.resolution > 1:
        mat = apply_textures(mat, scene.materials, scene.textures, sp.material, sp.uv)
    wo_local = smath.to_local(-direction, sp.shading_normal)

    def unshadowed(lpos, lnormal, lrad, is_env):
        """Unshadowed contribution of a light sample at this pixel's hit,
        with its direction and distance."""
        env3 = is_env[..., None]
        to_l = torch.where(env3, lpos, lpos - sp.position)
        dist = torch.where(is_env, _ENV_DIST, smath.length(to_l))
        wi = torch.where(env3, lpos, to_l / torch.clamp(dist, min=1e-20)[..., None])
        cos_l = torch.where(is_env, 1.0, torch.clamp(smath.dot(-wi, lnormal), min=0.0))
        ev = bsdf_eval(mat, wo_local, smath.to_local(wi, sp.shading_normal))
        g = torch.where(is_env, 1.0, smath.safe_div(cos_l, dist * dist))
        contrib = ev.f * lrad * (torch.abs(smath.dot(wi, sp.shading_normal)) * g)[..., None]
        return torch.where((cos_l > 0)[..., None], contrib, 0.0), wi, dist

    # -- initial candidates (RIS) -------------------------------------------
    f32 = dict(dtype=torch.float32, device=dev)
    res = sres.init_reservoir(dict(pos=torch.zeros((n, 3), **f32), nrm=torch.zeros((n, 3), **f32),
                                   rad=torch.zeros((n, 3), **f32),
                                   env=torch.zeros((n,), dtype=torch.bool, device=dev)), n)
    for _ in range(candidates):
        u, st = srng.next_floats(st, 4)
        ls = slights.sample_light(scene, u[..., 0], u[..., 1], u[..., 2])
        contrib, _, _ = unshadowed(ls.position, ls.normal, ls.radiance, ls.is_env)
        p_hat = smath.luminance(contrib)
        res = sres.update(res, dict(pos=ls.position, nrm=ls.normal, rad=ls.radiance,
                                    env=ls.is_env),
                          p_hat, smath.safe_div(p_hat, ls.pdf_area), u[..., 3])

    # -- temporal merge: the previous frame's reservoir, reprojected ---------
    if prev_view is not None:
        pix, inside, _ = scamera.sensor_importance(prev_view, sp.position, cfg.width, cfg.height)
        hist = _unpack_state(hist_packed[pixel_index(pix, cfg.width, cfg.height)])
        hist = hist._replace(m=torch.where(inside & hit.hit, hist.m, 0.0))
    else:
        hist = state

    def merge_in(res, other: RestirState, u_merge, m_cap):
        """Stream another reservoir's sample into ``res`` with weight
        p_hat here x its W x its (capped) M."""
        m_other = torch.clamp(other.m, max=m_cap)
        w_contrib = smath.safe_div(other.total_weight,
                                   other.m * torch.clamp(other.target_pdf, min=1e-20))
        contrib_o, _, _ = unshadowed(other.light_pos, other.light_normal,
                                     other.light_radiance, other.is_env)
        p_hat_o = smath.luminance(contrib_o)
        w_o = p_hat_o * w_contrib * m_other
        total = res.total_weight + w_o
        keep = (u_merge * torch.clamp(total, min=1e-20)) < w_o
        sample = sres._select(keep, dict(pos=other.light_pos, nrm=other.light_normal,
                                         rad=other.light_radiance, env=other.is_env),
                              res.sample)
        return sres.Reservoir(sample=sample, target_pdf=torch.where(keep, p_hat_o, res.target_pdf),
                              total_weight=total, m=res.m + m_other)

    u_merge, st = srng.next_float(st)
    merged = merge_in(res, hist, u_merge, history_limit * candidates)

    # -- spatial reuse: same-cell neighbours through the world hash grid ----
    if spatial_taps > 0:
        cell = shg.cell_size_for(view.camera_to_world[:, 3], sp.position, 2.0e-3)
        grid = shg.build_hashgrid(sp.position, cell)
        qpos = sp.position
        if hash_jitter:
            uj, st = srng.next_floats(st, 2)
            t_b, b_b = smath.make_orthonormal(sp.geom_normal)
            phi = uj[..., 1] * (2.0 * np.pi)
            qpos = sp.position + (cell * uj[..., 0:1] * (
                t_b * torch.cos(phi)[:, None] + b_b * torch.sin(phi)[:, None]))
        ids, valid = shg.query(grid, qpos, max_results=8)
        packed = _pack_state(_state_of(merged))
        lanes = torch.arange(n, device=dev)
        n_valid = valid.sum(dim=-1)
        for _ in range(spatial_taps):
            u, st = srng.next_floats(st, 2)
            pick = torch.minimum((u[..., 0] * n_valid).to(torch.int32),
                                 torch.clamp(n_valid - 1, min=0).to(torch.int32))
            nid = torch.gather(ids, 1, pick[:, None].long())[:, 0]
            ok = (n_valid > 0) & (nid >= 0) & (nid != lanes) & hit.hit
            nb = _unpack_state(packed[torch.clamp(nid, min=0).long()])
            merged = merge_in(merged, nb._replace(m=torch.where(ok, nb.m, 0.0)), u[..., 1],
                              history_limit * candidates)

    # -- shade the winner ----------------------------------------------------
    contrib, wi, dist = unshadowed(merged.sample["pos"], merged.sample["nrm"],
                                   merged.sample["rad"], merged.sample["env"])
    w_big = sres.contribution_weight(merged)
    ok = hit.hit & (merged.target_pdf > 0)
    occluded = trace_occluded(ray_offset(sp.position, sp.geom_normal), wi,
                              torch.where(ok, dist, 0.0))
    ok = ok & ~occluded
    direct = torch.where(
        ok[..., None],
        smath.safe_div(contrib, merged.target_pdf[..., None])
        * (merged.target_pdf * w_big)[..., None],
        0.0)
    direct = direct + torch.where(
        (~hit.hit)[..., None], slights.eval_environment(scene, direction),
        torch.where((sp.front_face & (sp.light >= 0))[..., None], mat.emission, 0.0))
    return _state_of(merged), direct


def restir_di_jit(scene, view, cfg, state, seed, candidates=4, history_limit=20.0,
                  prev_view=None, spatial_taps=0, hash_jitter=False):
    """:func:`restir_di` under the reference's compiled entry point's name."""
    return restir_di(scene, view, cfg, state, seed, candidates, history_limit, prev_view,
                     spatial_taps, hash_jitter)
