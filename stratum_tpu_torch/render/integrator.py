"""Wavefront integrators (counterpart of stratum_tpu/render/integrator.py:
RenderConfig, the tracer resolution, trace_direct / render_direct(_progressive)
and trace_path / render_path(_with_counts, _progressive)).

``tracer="auto"`` resolves as the reference does: the dense tracer
(``"mxu"``, ops/mxu.py) at <= MXU_TRI_THRESHOLD triangles, else
``"pallas"``, the block kernel (ops/block_trace.py) under the reference's
name for its Pallas tracer. ``"brute"`` is the exact oracle.

The path tracer runs one sample per pixel as a dense per-bounce wavefront:
intersect, add MIS-weighted emission, run NEE (from the presampled light
tile with ``presample_lights``), sample the BSDF, continue with Russian
roulette. The reference's ``lax.scan`` over bounces is a Python loop here.
On ``"pallas"``, bounce 0 traces unsorted (the primary wave is
tile-coherent), later bounces go through the trace-local sort, every
bounce's NEE shadow rays are traced in ONE deferred occlusion wave after
the loop, and the ``binned_*`` options send sorted closest waves, early
bounces and the occlusion wave through the binned pair-stream tracer
(ops/binned.py). The dense tracers have no candidate prep to amortise, so
they trace every wave unsorted and each bounce's shadow rays at once, and
their hits resolve with one ``tri_payload`` row gather. Integer and hash
paths (RNG, tile order, coherent granules) match the reference bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.core import rng as srng
from stratum_tpu_torch.ops import binned, block_trace, mxu, raysort
from stratum_tpu_torch.ops.bvh import morton3
from stratum_tpu_torch.ops.intersect import (
    T_MAX,
    intersect_brute_force,
    occluded_brute_force,
    ray_offset,
)
from stratum_tpu_torch.render import camera as scamera
from stratum_tpu_torch.render import lights as slights
from stratum_tpu_torch.render.shading import (
    material_from_row,
    shading_point_from_row,
    shadow_terminator_factor,
)

_ENV_DIST = float(np.float32(T_MAX) * np.float32(0.5))


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render parameters, field for field the reference's RenderConfig
    (the same names, order and defaults).

    ``gs``, ``gs_primary`` and ``gs_shadow`` set the block tracer's group
    size as the reference's do (-1: 4, -2: follow ``gs``; 1 is the K3
    kernel's single leaves). TPU schedule knobs that give identical results
    (``unroll_bounces``, ``ring``, ``entry_group*``, ``gs_gate``) are
    accepted and ignored: the CUDA kernel has one schedule. Options that
    would change what is rendered and are not ported raise
    NotImplementedError at a value other than their default (see
    :func:`check_supported`)."""

    width: int = 256
    height: int = 256
    max_bounces: int = 4
    use_nee: bool = True
    use_mis: bool = True
    unroll_bounces: int = 1
    rr_depth: int = 2
    rr_min_beta: float = 0.05
    slim_carry: bool = False
    bsdf: str = "lambert"  # "lambert" | "disney"
    tracer: str = "auto"  # "auto" | "mxu" | "pallas" | "brute" (see resolved_tracer)
    alpha_test: bool = False
    ris_candidates: int = 1
    sort_rays: bool = True  # trace-local sort of closest waves 1..N
    indirect_only: bool = False
    defer_shadows: bool = True  # one occlusion wave after the bounce loop
    presample_lights: int = 0  # >0: per-frame tile of light samples
    clamp_indirect: float = 0.0  # >0: luminance clamp on indirect terms
    shadow_rr: float = 0.0  # >0: Russian roulette on NEE shadow rays
    debug_path_edges: int = 0
    lvc_connections: int = 0  # BDPT's light-vertex-cache connections
    coherent_tiles: int = 0  # >0: granule-shared groups of tile rows
    coherent_block: int = 2048  # lanes per coherence granule
    tex_filter: str = "trilinear"  # texture filter ("trilinear" | "stochastic")
    entry_group: int = 0
    entry_group_primary: int = 0
    entry_group_shadow: int = 0
    ring: int = -1
    gs: int = -1
    gs_primary: int = -2
    gs_shadow: int = -2
    gs_gate: int = -1
    binned_secondary: int = 0  # >0: sorted closest waves binned, g rays a group
    binned_shadow: int = 0  # >0: occlusion waves binned, g rays a group
    binned_pcap: int = 16  # binned: leaves kept per group (more are dropped)
    binned_bounces: int = 0  # bounces 1..n: unsorted binned closest waves
    binned_mcap_num: int = 0  # binned pair capacity n * num / 8 (0: n // 2)
    binned_em: str = "ray"  # binned emission: "ray" or "group" slab tests
    binned_sb: int = 1  # binned: bins of one leaf per padded step
    wave_caps: tuple = ()


# below this triangle count "auto" tests every triangle with the dense
# tracer instead of walking the BVH (the reference's threshold)
MXU_TRI_THRESHOLD = 16384
TRACERS = ("mxu", "pallas", "brute")  # the tracers the port runs
_TRACERS = {
    "packet": "the XLA packet tracer",
    "bvh": "the LBVH tracer",
}
_ITEM = {  # ROADMAP Queue 1 item that ports each refused option
    "tracer": "item 1 (the packet tracer and the LBVH)",
    "alpha_test": "item 4 (RIS NEE, alpha_test, wave_caps, media and spheres)",
    "ris_candidates>1": "item 4 (RIS NEE, alpha_test, wave_caps, media and spheres)",
    "wave_caps": "item 4 (RIS NEE, alpha_test, wave_caps, media and spheres)",
    "slim_carry": "item 3 (render_path_batched / render_path_lanes)",
    "debug_path_edges": "item 6 (denoise, tonemap, AOVs and sessions)",
    "indirect_only": "item 5 (light tracing, BDPT, ReSTIR and adaptive)",
    "use_nee=False": "item 4 (RIS NEE, alpha_test, wave_caps, media and spheres)",
    "use_mis=False": "item 4 (RIS NEE, alpha_test, wave_caps, media and spheres)",
    "lvc_connections": "item 5 (light tracing, BDPT, ReSTIR and adaptive)",
    "tex_filter": "item 2 (textures and the colonnade)",
}


def check_supported(cfg: RenderConfig) -> None:
    """Raise NotImplementedError for options the port does not run yet."""
    if cfg.tracer in _TRACERS:
        raise NotImplementedError(
            f"tracer={cfg.tracer!r} ({_TRACERS[cfg.tracer]}): ROADMAP Queue 1 "
            + _ITEM["tracer"]
        )
    if cfg.tracer != "auto" and cfg.tracer not in TRACERS:
        raise ValueError(f"unknown tracer {cfg.tracer!r}")
    if cfg.bsdf not in ("lambert", "disney"):
        raise ValueError(f"unknown bsdf {cfg.bsdf!r}")
    refused = {
        "alpha_test": cfg.alpha_test,
        "ris_candidates>1": cfg.ris_candidates > 1,
        "wave_caps": bool(cfg.wave_caps),
        "slim_carry": cfg.slim_carry,
        "debug_path_edges": cfg.debug_path_edges > 0,
        "indirect_only": cfg.indirect_only,
        "use_nee=False": not cfg.use_nee,
        "use_mis=False": not cfg.use_mis,
        "lvc_connections": cfg.lvc_connections != 0,
        "tex_filter": cfg.tex_filter != "trilinear",
    }
    for name, on in refused.items():
        if on:
            raise NotImplementedError(f"{name}: ROADMAP Queue 1 {_ITEM[name]}")
    if (cfg.binned_secondary or cfg.binned_bounces) and not cfg.sort_rays:
        # the reference silently ignores both without its sorted peel
        raise ValueError("binned_secondary and binned_bounces need sort_rays=True")


def resolved_tracer(scene, cfg: RenderConfig) -> str:
    """The tracer ``cfg.tracer`` names; ``auto`` gives the dense tracer at
    <= MXU_TRI_THRESHOLD (padded) triangles, the block kernel above."""
    if cfg.tracer == "auto":
        return "mxu" if scene.geo.num_triangles <= MXU_TRI_THRESHOLD else "pallas"
    return cfg.tracer


def mis_power_heuristic(pdf_a, pdf_b):
    a2 = pdf_a * pdf_a
    return smath.safe_div(a2, a2 + pdf_b * pdf_b)


def _ray_jitter(px, py, seed):
    st = srng.rng_init(px, py, seed, offset=0)
    return srng.next_floats(st, 2)


def _bsdf_fns(cfg: RenderConfig):
    if cfg.bsdf == "disney":
        from stratum_tpu_torch.render import disney

        return disney.disney_eval, disney.disney_sample
    from stratum_tpu_torch.render import bsdf as sbsdf

    return sbsdf.lambert_eval, sbsdf.lambert_sample


def _firefly_clamp(cfg: RenderConfig, term, depth: int, min_depth: int):
    """Clamp an indirect contribution's luminance to cfg.clamp_indirect."""
    if cfg.clamp_indirect <= 0 or depth < min_depth:
        return term
    lum = smath.luminance(term)
    scale = torch.where(
        lum > cfg.clamp_indirect,
        cfg.clamp_indirect / torch.clamp(lum, min=1e-20),
        1.0,
    )
    return term * scale[..., None]


def _shadow_ray_rr(cfg: RenderConfig, contrib, candidate, st):
    """Russian roulette on NEE shadow rays: survive with probability
    proportional to the unoccluded luminance, survivors carry 1/p."""
    if cfg.shadow_rr <= 0:
        return contrib, candidate, st
    p = torch.clamp(smath.luminance(contrib) / cfg.shadow_rr, 0.05, 1.0)
    u, st = srng.next_floats(st, 1)
    return contrib / p[..., None], candidate & (u[..., 0] < p), st


def _group_size(value: int, follow: int) -> int:
    """A ``gs*`` field -> the block tracer's group size (integrator.py:
    466-482 of the reference): -2 follows ``follow``, other negatives mean
    the default 4, and 0 runs single leaves like 1."""
    if value == -2:
        return follow
    return block_trace.GS if value < 0 else max(value, 1)


def _trace_fns(scene, cfg: RenderConfig, capture=None):
    """(closest, closest_unsorted, occluded, closest_binned_peel), the
    counterpart of the reference's ``_trace_fns4``. On ``"pallas"``: the
    sorted closest tracer (binned with ``binned_secondary``), the unsorted
    primary peel (always the block tracer), the occlusion tracer (binned
    with ``binned_shadow``) and, with ``binned_bounces``, the unsorted
    binned closest tracer of the early bounces (else None); closest results
    are resolved by finalize_hit's one payload gather after any unsort. On
    a dense tracer (``"mxu"``, ``"brute"``) the closest tracer serves every
    wave unsorted and its hits carry triangle ids. With a ``capture``
    dict, every tracer call appends the inputs it hands a tracer: (o, d,
    t) under "closest" / "occluded", (o, d, t, stats) under
    "binned_closest" / "binned_occluded"."""
    tracer = resolved_tracer(scene, cfg)

    def record(kind, *rays):
        if capture is not None:
            capture.setdefault(kind, []).append(rays)

    if tracer != "pallas":
        geo, feat = scene.geo, scene.tri_features

        def closest(o, d, tm=None):
            record("closest", o, d, tm)
            if tracer == "mxu":
                return mxu.intersect_mxu(o, d, feat, t_max=tm)
            return intersect_brute_force(o, d, geo.positions, geo.indices, t_max=tm)

        def occluded(o, d, t):
            record("occluded", o, d, t)
            if tracer == "mxu":
                return mxu.occluded_mxu(o, d, t, feat)
            return occluded_brute_force(o, d, t, geo.positions, geo.indices)

        return closest, closest, occluded, None

    fat = scene.fat_bvh
    gs = _group_size(cfg.gs, block_trace.GS)
    binned_kw = dict(pcap=cfg.binned_pcap, sb=cfg.binned_sb, em=cfg.binned_em,
                     with_stats=capture is not None)

    def mcap(n):
        return n * cfg.binned_mcap_num // 8 if cfg.binned_mcap_num else None

    def block_closest(gs_c):
        def closest(o, d, tm=None):
            record("closest", o, d, tm)
            return block_trace.block_closest(fat, o, d, tm, gs=gs_c)

        return closest

    def binned_closest(g):
        def closest(o, d, tm=None):
            h = binned.binned_closest(fat, o, d, tm, g=g, mcap=mcap(o.shape[0]), **binned_kw)
            if capture is None:
                return h
            record("binned_closest", o, d, tm, h[1].stats)
            return h[0]

        return closest

    def finalized(fn):
        def g(o, d, tm=None):
            return block_trace.finalize_hit(scene.slot_payload, o, d, fn(o, d, tm))

        return g

    closest_sorted = (
        binned_closest(cfg.binned_secondary) if cfg.binned_secondary else block_closest(gs)
    )
    if cfg.sort_rays:
        pos = scene.geo.positions
        closest_sorted = raysort.sorted_closest(
            closest_sorted, pos.amin(dim=0), pos.amax(dim=0)
        )
    closest_b = None
    if cfg.binned_bounces:
        closest_b = finalized(binned_closest(cfg.binned_secondary or 8))

    gs_o = _group_size(cfg.gs_shadow, gs)

    def occluded(o, d, t):
        if not cfg.binned_shadow:
            record("occluded", o, d, t)
            return block_trace.block_occluded(fat, o, d, t, gs=gs_o)
        occ = binned.binned_occluded(fat, o, d, t, g=cfg.binned_shadow,
                                     mcap=mcap(o.shape[0]), **binned_kw)
        if capture is None:
            return occ
        record("binned_occluded", o, d, t, occ[1].stats)
        return occ[0]

    closest_u = block_closest(_group_size(cfg.gs_primary, gs))
    return finalized(closest_sorted), finalized(closest_u), occluded, closest_b


def _hit_rows(scene, hit):
    """(shading row [N, 32], material row [N, 24]) of each hit: from the
    block tracer's fused slot payload, or for the dense tracers' triangle
    ids by one ``tri_payload`` row gather (row 0 on a miss)."""
    if hit.payload is not None:
        return hit.payload[:, 0:32], hit.payload[:, 64:88]
    row = scene.tri_payload[torch.clamp(hit.tri, min=0).long()]
    return row[:, 0:32], row[:, 32:56]


def light_tile_for(scene, cfg: RenderConfig, seed, scene_lo, scene_hi):
    """Per-frame tile of ``presample_lights`` light samples [T, 16]; with
    coherent_tiles, sorted so consecutive rows are spatially close (area
    rows by position morton, env rows last by direction morton)."""
    t_tile = cfg.presample_lights
    dev = scene.device
    st_tile = srng.rng_init(
        torch.arange(t_tile, dtype=torch.int32, device=dev), 0x1EA51E57, seed
    )
    ut, _ = srng.next_floats(st_tile, 3)
    tl = slights.sample_light(scene, ut[..., 0], ut[..., 1], ut[..., 2])
    tile = torch.cat(
        [
            tl.position, tl.normal, tl.radiance, tl.pdf_area[:, None],
            tl.is_env.to(torch.float32)[:, None],
            tl.tri.to(torch.float32)[:, None],
            torch.zeros((t_tile, 4), dtype=torch.float32, device=dev),
        ],
        dim=-1,
    )
    if cfg.coherent_tiles > 0:
        if t_tile % cfg.coherent_tiles != 0:
            raise ValueError("presample_lights must be a multiple of coherent_tiles")
        q_area = (tl.position - scene_lo) / torch.clamp(scene_hi - scene_lo, min=1e-9)
        q = torch.where(tl.is_env[:, None], tl.position * 0.5 + 0.5, q_area)
        key = morton3(torch.clamp(q, 0.0, 1.0)) | (tl.is_env.to(torch.int64) << 31)
        tile = tile[torch.argsort(key, stable=True)]
    return tile


def light_segment(ls, nee_pos, shadow_origin, scene_lo, scene_hi):
    """Direction, shadow-segment length, light-side cosine and solid-angle
    pdf of light samples seen from ``nee_pos``. Env segments are clipped to
    the scene-bounds exit: nothing can occlude past it, and a T_MAX/2
    segment would only inflate the tracer's candidate sets."""
    env3 = ls.is_env[..., None]
    to_light = torch.where(env3, ls.position, ls.position - nee_pos)
    dist = torch.where(ls.is_env, _ENV_DIST, smath.length(to_light))
    wi = torch.where(env3, ls.position, to_light / torch.clamp(dist, min=1e-20)[..., None])
    cos_l = torch.where(ls.is_env, 1.0, torch.clamp(smath.dot(-wi, ls.normal), min=0.0))
    g = torch.where(ls.is_env, 1.0, smath.safe_div(cos_l, dist * dist))
    pdf_w = torch.where(ls.is_env, ls.pdf_area, smath.safe_div(ls.pdf_area, g))
    inv_wi = torch.where(torch.abs(wi) > 1e-20, 1.0 / wi, torch.sign(wi) * 1e20 + 1e20)
    t_lohi = (scene_lo[None, :] - shadow_origin) * inv_wi
    t_hilo = (scene_hi[None, :] - shadow_origin) * inv_wi
    t_exit = torch.amin(torch.maximum(t_lohi, t_hilo), dim=-1)
    t_exit = torch.clamp(t_exit, min=0.0) * 1.001 + 1e-3
    return wi, torch.where(ls.is_env, torch.minimum(dist, t_exit), dist), cos_l, pdf_w


def tile_row_sample(light_tile, idx):
    """LightSampleRecord of presampled tile rows ``idx``."""
    row = light_tile[idx]
    return slights.LightSampleRecord(
        position=row[..., 0:3], normal=row[..., 3:6], radiance=row[..., 6:9],
        pdf_area=row[..., 9], is_env=row[..., 10] > 0.5,
        tri=row[..., 11].to(torch.int32),
    )


def _granule_base(cfg: RenderConfig, px, py, seed, depth: int):
    """Per-lane base row of the coherence granule's tile group: each
    granule of ``coherent_block`` lanes, keyed by its first lane's pixel,
    draws one group of ``coherent_tiles`` consecutive tile rows."""
    nb = cfg.coherent_block
    n = px.shape[0]
    n_groups = cfg.presample_lights // cfg.coherent_tiles
    first_x, first_y = px[::nb], py[::nb]
    key = torch.stack(
        [
            srng.as_u32(first_x), srng.as_u32(first_y),
            torch.full_like(first_x, srng.u32(depth + seed * 131), dtype=torch.int32),
            torch.full_like(first_x, 0x1D1E5, dtype=torch.int32),
        ],
        dim=-1,
    )
    u_grp = srng._bits_to_float(srng.pcg4d(key)[..., 0])
    base = torch.clamp((u_grp * n_groups).to(torch.int64), max=n_groups - 1)
    return torch.repeat_interleave(base * cfg.coherent_tiles, nb)[:n]


def trace_path(scene, view, cfg: RenderConfig, seed: int, px=None, py=None,
               capture=None):
    """One path-traced sample per pixel -> (radiance [N, 3], n_rays int64):
    n_rays counts closest rays of alive lanes plus NEE shadow rays, like
    the reference's counters. ``capture``: see :func:`_trace_fns`."""
    check_supported(cfg)
    dev = scene.device
    bsdf_eval, bsdf_sample = _bsdf_fns(cfg)
    scene_lo = scene.geo.positions.amin(dim=0)
    scene_hi = scene.geo.positions.amax(dim=0)
    trace_closest, trace_closest_u, trace_occluded, trace_closest_b = _trace_fns(
        scene, cfg, capture
    )
    # deferring pays off by amortising the block tracer's candidate prep
    # over the bounces; the dense tracers have none (reference :704-707)
    defer = cfg.defer_shadows and resolved_tracer(scene, cfg) == "pallas"
    if px is None:
        px, py = scamera.pixel_grid(cfg.width, cfg.height, dev)
    jitter, st = _ray_jitter(px, py, seed)
    origin, direction = scamera.generate_rays(
        view, px, py, jitter, cfg.width, cfg.height
    )
    n = origin.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    radiance = torch.zeros((n, 3), **f32)
    beta = torch.ones((n, 3), **f32)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf_w = torch.full((n,), -1.0, **f32)  # < 0: camera vertex
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    presample_on = cfg.presample_lights > 0
    light_tile = (
        light_tile_for(scene, cfg, seed, scene_lo, scene_hi) if presample_on else None
    )
    shadow_parts = []

    for depth in range(cfg.max_bounces + 1):
        n_rays = n_rays + alive.sum()
        # dead lanes trace a zero-length segment: no candidates
        seg_max = torch.where(alive, T_MAX, 0.0)
        if depth == 0:
            closest_fn = trace_closest_u
        elif depth <= cfg.binned_bounces:
            closest_fn = trace_closest_b
        else:
            closest_fn = trace_closest
        hit = closest_fn(origin, direction, seg_max)
        srow, mrow = _hit_rows(scene, hit)
        sp = shading_point_from_row(srow, hit.tri, hit.bary, direction)
        mat = material_from_row(mrow)
        hit_mask = hit.hit

        # escaped rays: environment, MIS against NEE
        miss = alive & ~hit_mask
        env_le, env_nee_pdf = slights.env_eval_and_pdf_w_mis(scene, direction)
        camera_vtx = prev_pdf_w < 0.0
        w_env = torch.where(camera_vtx, 1.0, mis_power_heuristic(prev_pdf_w, env_nee_pdf))
        radiance = radiance + torch.where(
            miss[..., None],
            _firefly_clamp(cfg, beta * env_le * w_env[..., None], depth, 2),
            0.0,
        )

        # emissive hits, MIS against NEE
        is_emissive = alive & hit_mask & (sp.light >= 0) & sp.front_face
        dist2 = smath.length_squared(sp.position - origin)
        cos_light = torch.abs(smath.dot(direction, sp.geom_normal))
        nee_pdf_area = slights.light_pdf_area(scene, hit.tri, sp.light)
        nee_pdf_w = smath.safe_div(nee_pdf_area * dist2, cos_light)
        w_emit = torch.where(camera_vtx, 1.0, mis_power_heuristic(prev_pdf_w, nee_pdf_w))
        radiance = radiance + torch.where(
            is_emissive[..., None],
            _firefly_clamp(cfg, beta * mat.emission * w_emit[..., None], depth, 2),
            0.0,
        )

        alive = alive & hit_mask
        ns = sp.shading_normal
        wo_local = smath.to_local(-direction, ns)
        mat = mat._replace(
            eta=torch.where(sp.front_face, mat.eta, 1.0 / torch.clamp(mat.eta, min=1e-6))
        )
        nee_pos = sp.position
        shadow_origin = ray_offset(sp.position, sp.geom_normal)

        u, st = srng.next_floats(st, 3)
        if presample_on:
            ct = cfg.coherent_tiles
            if ct > 0:
                idx = _granule_base(cfg, px, py, seed, depth) + torch.clamp(
                    (u[..., 0] * ct).to(torch.int64), max=ct - 1
                )
            else:
                idx = torch.clamp(
                    (u[..., 0] * cfg.presample_lights).to(torch.int64),
                    max=cfg.presample_lights - 1,
                )
            ls = tile_row_sample(light_tile, idx)
        else:
            ls = slights.sample_light(scene, u[..., 0], u[..., 1], u[..., 2])
        wi, dist, cos_l, pdf_w = light_segment(
            ls, nee_pos, shadow_origin, scene_lo, scene_hi
        )
        wi_local = smath.to_local(wi, ns)
        ev = bsdf_eval(mat, wo_local, wi_local)
        term = shadow_terminator_factor(sp.geom_normal, ns, wi)
        f = ev.f * (torch.abs(wi_local[..., 2]) * term)[..., None]
        w_nee = mis_power_heuristic(pdf_w, ev.pdf_fwd)
        contrib = beta * f * ls.radiance * smath.safe_div(w_nee, pdf_w)[..., None]
        candidate = (
            alive & (pdf_w > 1e-12) & (cos_l > 0.0)
            & (torch.amax(contrib, dim=-1) > 0.0)
        )
        contrib = _firefly_clamp(cfg, contrib, depth, 1)
        contrib, candidate, st = _shadow_ray_rr(cfg, contrib, candidate, st)
        n_rays = n_rays + candidate.sum()
        if defer:
            shadow_parts.append((
                shadow_origin, wi, torch.where(candidate, dist, 0.0),
                torch.where(candidate[..., None], contrib, 0.0),
            ))
        else:
            occ = trace_occluded(shadow_origin, wi, dist)
            radiance = radiance + torch.where(
                (candidate & ~occ)[..., None], contrib, 0.0
            )

        # BSDF sampling
        u, st = srng.next_floats(st, 3)
        bs = bsdf_sample(mat, wo_local, u)
        new_dir = smath.to_world(bs.wi, ns)
        term = shadow_terminator_factor(sp.geom_normal, ns, new_dir)
        throughput = bs.f * smath.safe_div(
            torch.abs(bs.wi[..., 2]) * term, bs.pdf_fwd
        )[..., None]
        new_origin = ray_offset(sp.position, sp.geom_normal * torch.sign(bs.wi[..., 2:3]))
        pdf_next = bs.pdf_fwd
        beta = beta * torch.where(alive[..., None], throughput, 1.0)
        alive = alive & (pdf_next > 1e-12) & (torch.amax(beta, dim=-1) > 0.0)
        origin = torch.where(alive[..., None], new_origin, origin)
        direction = torch.where(alive[..., None], new_dir, direction)
        prev_pdf_w = pdf_next

        # Russian roulette
        u_rr, st = srng.next_float(st)
        if depth >= cfg.rr_depth:
            p_cont = torch.clamp(smath.max3(beta), cfg.rr_min_beta, 1.0)
            survive = u_rr < p_cont
            beta = torch.where(survive[..., None], beta / p_cont[..., None], beta)
            alive = alive & survive

    if shadow_parts:
        # the deferred shadow wave: every bounce's NEE rays in one pass
        o_f, w_f, t_f, c_f = (torch.cat(x) for x in zip(*shadow_parts))
        occ = trace_occluded(o_f, w_f, t_f)
        hit_contrib = torch.where((~occ & (t_f > 0))[..., None], c_f, 0.0)
        radiance = radiance + hit_contrib.view(len(shadow_parts), n, 3).sum(dim=0)
    return radiance, n_rays


def render_path_with_counts(scene, view, cfg: RenderConfig, seed: int, capture=None):
    """One path-traced sample per pixel -> (image [H, W, 3], traced-ray
    count), on the scene's device. On ``"pallas"`` pixels are traced in
    screen tiles of up to 32x64 (``tile_dims``) so ray blocks stay compact,
    untiled otherwise (reference :1560-1595); the pixel-keyed RNG makes the
    result independent of that layout. ``capture`` (a dict) collects the
    rays of every tracer call, so a caller can replay the waves this sample
    traced (see :func:`_trace_fns`)."""
    dims = None
    if resolved_tracer(scene, cfg) == "pallas":
        dims = scamera.tile_dims(cfg.width, cfg.height)
    if dims is None:
        px, py = scamera.pixel_grid(cfg.width, cfg.height, scene.device)
        rad, n_rays = trace_path(scene, view, cfg, seed, px, py, capture)
        return rad.reshape(cfg.height, cfg.width, 3), n_rays
    th, tw = dims
    px, py = scamera.pixel_grid_tiled(cfg.width, cfg.height, th, tw, scene.device)
    rad, n_rays = trace_path(scene, view, cfg, seed, px, py, capture)
    return scamera.untile_image(rad, cfg.width, cfg.height, th, tw), n_rays


def render_path(scene, view, cfg: RenderConfig, seed: int):
    """One path-traced sample per pixel -> image [H, W, 3]."""
    return render_path_with_counts(scene, view, cfg, seed)[0]


def render_path_progressive(scene, view, cfg: RenderConfig, spp: int, seed0: int = 0):
    """The mean of ``spp`` path-traced samples at seeds seed0, seed0 + 1, ..."""
    acc = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=scene.device)
    for s in range(spp):
        acc = acc + render_path(scene, view, cfg, seed0 + s)
    return acc / spp


def trace_direct(scene, view, cfg: RenderConfig, seed: int):
    """One sample per pixel of direct lighting, Lambertian with NEE only
    (the reference's M1 integrator) -> radiance [N, 3]: emission or the
    environment where the camera ray lands, plus one unweighted light
    sample through one shadow ray."""
    check_supported(cfg)
    dev = scene.device
    trace_closest, _, trace_occluded, _ = _trace_fns(scene, cfg)
    px, py = scamera.pixel_grid(cfg.width, cfg.height, dev)
    jitter, st = _ray_jitter(px, py, seed)
    origin, direction = scamera.generate_rays(view, px, py, jitter, cfg.width, cfg.height)
    hit = trace_closest(origin, direction)
    srow, mrow = _hit_rows(scene, hit)
    sp = shading_point_from_row(srow, hit.tri, hit.bary, direction)
    mat = material_from_row(mrow)
    radiance = torch.where(
        (~hit.hit)[..., None],
        slights.eval_environment(scene, direction),
        torch.where(sp.front_face[..., None], mat.emission, 0.0),
    )
    u, st = srng.next_floats(st, 3)
    ls = slights.sample_light(scene, u[..., 0], u[..., 1], u[..., 2])
    to_light = torch.where(ls.is_env[..., None], ls.position, ls.position - sp.position)
    dist = torch.where(ls.is_env, _ENV_DIST, smath.length(to_light))
    wi = torch.where(ls.is_env[..., None], ls.position, to_light / dist[..., None])
    cos_surf = smath.dot(wi, sp.shading_normal)
    cos_light = torch.where(ls.is_env, 1.0, torch.clamp(smath.dot(-wi, ls.normal), min=0.0))
    g = torch.where(ls.is_env, 1.0, smath.safe_div(cos_light, dist * dist))
    pdf_w = torch.where(ls.is_env, ls.pdf_area, smath.safe_div(ls.pdf_area, g))
    f = mat.base_color * smath.INV_PI
    contrib = f * ls.radiance * (
        torch.clamp(cos_surf, min=0.0) / torch.clamp(pdf_w, min=1e-12))[..., None]
    candidate = (hit.hit & (cos_surf > 0.0) & (torch.amax(contrib, dim=-1) > 0.0)
                 & (pdf_w > 1e-12))
    occ = trace_occluded(ray_offset(sp.position, sp.geom_normal), wi, dist)
    return radiance + torch.where((candidate & ~occ)[..., None], contrib, 0.0)


def render_direct(scene, view, cfg: RenderConfig, seed: int):
    """One direct-lighting sample per pixel -> image [H, W, 3]."""
    return trace_direct(scene, view, cfg, seed).reshape(cfg.height, cfg.width, 3)


def render_direct_progressive(scene, view, cfg: RenderConfig, spp: int, seed0: int = 0):
    """The mean of ``spp`` direct-lighting samples at seeds seed0, seed0 + 1, ..."""
    acc = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=scene.device)
    for s in range(spp):
        acc = acc + render_direct(scene, view, cfg, seed0 + s)
    return acc / spp
