"""Wavefront integrators (counterpart of stratum_tpu/render/integrator.py:
RenderConfig, the tracer resolution, trace_direct / render_direct(_progressive)
and trace_path / render_path(_with_counts, _progressive, _batched, _lanes)).

``tracer="auto"`` resolves as the reference does on its TPU: the dense
tracer (``"mxu"``, ops/mxu.py) at <= MXU_TRI_THRESHOLD triangles, else
``"pallas"``, the block kernel (ops/block_trace.py) under the reference's
name for its Pallas tracer. ``"brute"`` is the exact oracle; ``"packet"``
(ops/packet.py) and ``"bvh"`` (ops/bvh.py) are the reference's XLA
traversals, and ``"null"`` its profiling fixture (synthetic hits, no
traversal).

The path tracer runs one sample per pixel as a dense per-bounce wavefront:
intersect, add MIS-weighted emission, run NEE (from the presampled light
tile with ``presample_lights``), sample the BSDF, continue with Russian
roulette. The reference's ``lax.scan`` over bounces is a Python loop here.
On ``"pallas"``, bounce 0 traces unsorted (the primary wave is
tile-coherent), later bounces go through the trace-local sort, every
bounce's NEE shadow rays are traced in ONE deferred occlusion wave after
the loop, and the ``binned_*`` options send sorted closest waves, early
bounces and the occlusion wave through the binned pair-stream tracer
(ops/binned.py). ``"packet"`` sorts and defers as ``"pallas"`` does. The
other tracers have no candidate prep to amortise, so they trace every wave
unsorted and each bounce's shadow rays at once. Hits that carry triangle
ids resolve with one ``tri_payload`` row gather. On a textured scene each
hit's material is modulated by its textures at the ray cone's mip level.
The estimator's other options are the reference's: RIS NEE
(``ris_candidates``), NEE or MIS off, the alpha test, participating media
(render/medium.py), analytic spheres and sphere lights (ops/spheres.py),
and ``wave_caps`` stream compaction. Integer and hash paths (RNG, tile
order, coherent granules, the compaction's pick) match the reference bit
for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.core import reservoir as sres
from stratum_tpu_torch.core import rng as srng
from stratum_tpu_torch.ops import binned, block_trace, mxu, packet, raysort
from stratum_tpu_torch.ops import spheres as sspheres
from stratum_tpu_torch.ops import bvh as sbvh
from stratum_tpu_torch.ops.bvh import morton3
from stratum_tpu_torch.ops.intersect import (
    T_MAX,
    HitRecord,
    intersect_brute_force,
    occluded_brute_force,
    ray_offset,
)
from stratum_tpu_torch.render import camera as scamera
from stratum_tpu_torch.render import lights as slights
from stratum_tpu_torch.render import medium as smedium
from stratum_tpu_torch.render import texture as stex
from stratum_tpu_torch.render.shading import (
    apply_normal_map,
    apply_textures,
    material_from_row,
    shading_point_from_row,
    shadow_terminator_factor,
)
from stratum_tpu_torch.utils import profiler as sprof

_ENV_DIST = float(np.float32(T_MAX) * np.float32(0.5))


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render parameters, field for field the reference's RenderConfig
    (the same names, order and defaults).

    ``gs``, ``gs_primary`` and ``gs_shadow`` set the block tracer's group
    size as the reference's do (-1: 4, -2: follow ``gs``; 1 is the K3
    kernel's single leaves). TPU schedule knobs that give identical results
    (``unroll_bounces``, ``ring``, ``entry_group*``, ``gs_gate``) are
    accepted and ignored: the CUDA kernel has one schedule. ``slim_carry``,
    the reference's scan-carry layout (its RNG rows rebuilt from the pixel
    grid each bounce; bit-identical results), is accepted and ignored too:
    the port has no scan carry. Every other option renders as the
    reference's does (:func:`check_supported` refuses only values that
    name nothing)."""

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
    tracer: str = "auto"  # see TRACERS and resolved_tracer
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
TRACERS = ("mxu", "pallas", "brute", "packet", "bvh", "null")
TEX_FILTERS = ("trilinear", "stochastic")
_BLOCK_TRACERS = ("pallas", "packet")  # tiled pixels, one deferred shadow wave


def check_supported(cfg: RenderConfig) -> None:
    """Raise ValueError for option values that name nothing."""
    if cfg.tracer != "auto" and cfg.tracer not in TRACERS:
        raise ValueError(f"unknown tracer {cfg.tracer!r}")
    if cfg.bsdf not in ("lambert", "disney"):
        raise ValueError(f"unknown bsdf {cfg.bsdf!r}")
    if cfg.tex_filter not in TEX_FILTERS:
        raise ValueError(f"unknown tex_filter {cfg.tex_filter!r}")
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


def _tri_tracers(scene, cfg: RenderConfig, tracer: str):
    """(closest, occluded) of a tracer whose hits carry triangle ids."""
    geo, feat, fat = scene.geo, scene.tri_features, scene.fat_bvh
    if tracer == "mxu":
        return (lambda o, d, tm: mxu.intersect_mxu(o, d, feat, t_max=tm),
                lambda o, d, t: mxu.occluded_mxu(o, d, t, feat))
    if tracer == "brute":
        return (lambda o, d, tm: intersect_brute_force(o, d, geo.positions, geo.indices, t_max=tm),
                lambda o, d, t: occluded_brute_force(o, d, t, geo.positions, geo.indices))
    if tracer == "packet":
        # a block of one screen tile, so block frusta stay compact
        dims = scamera.tile_dims(cfg.width, cfg.height)
        blk = max(512, min(dims[0] * dims[1] if dims else 2048, 4096))
        return (lambda o, d, tm: packet.packet_closest(fat, o, d, t_max=tm, block=blk),
                lambda o, d, t: packet.packet_occluded(fat, o, d, t, block=blk))
    if tracer == "bvh":
        return (lambda o, d, tm: sbvh.traverse_closest(scene.bvh, o, d, t_max=tm),
                lambda o, d, t: sbvh.traverse_occluded(scene.bvh, o, d, t))

    # "null", a profiling fixture: hits at t = 1 on triangle lane % T (so
    # the shading gathers vary per lane) and no occluder, at no traversal
    # cost; the difference to a real tracer's sample is the traversal's
    def null_closest(o, d, tm):
        lanes = torch.arange(o.shape[0], dtype=torch.int32, device=o.device)
        return HitRecord(
            t=torch.ones(o.shape[:1], dtype=torch.float32, device=o.device),
            tri=lanes % max(geo.num_triangles, 1),
            bary=torch.full((o.shape[0], 2), 0.3, dtype=torch.float32, device=o.device),
        )

    return null_closest, lambda o, d, t: torch.zeros(o.shape[:1], dtype=torch.bool,
                                                     device=o.device)


def _trace_fns(scene, cfg: RenderConfig, capture=None):
    """(closest, closest_unsorted, occluded, closest_binned_peel), the
    counterpart of the reference's ``_trace_fns4``. On ``"pallas"``: the
    sorted closest tracer (binned with ``binned_secondary``), the unsorted
    primary peel (always the block tracer), the occlusion tracer (binned
    with ``binned_shadow``) and, with ``binned_bounces``, the unsorted
    binned closest tracer of the early bounces (else None); closest results
    are resolved by finalize_hit's one payload gather after any unsort. On
    the other tracers hits carry triangle ids; ``"packet"`` sorts its
    closest waves after the unsorted primary peel as ``"pallas"`` does, the
    rest trace every wave unsorted. With a ``capture``
    dict, every tracer call appends the inputs it hands a tracer: (o, d,
    t) under "closest" / "occluded", (o, d, t, stats) under
    "binned_closest" / "binned_occluded". A scene with analytic spheres
    merges the dense sphere test into every closest tracer (the merged
    record carries triangle ids, ``T + sid`` for a sphere, and no payload)
    and into the occlusion tracer (reference :410-441)."""
    fns = _tri_trace_fns(scene, cfg, capture)
    if scene.spheres.num_spheres == 0:
        return fns
    closest, closest_u, occluded, closest_b = fns
    sph, t_offset = scene.spheres, scene.geo.num_triangles

    def with_spheres(closest_fn):
        def closest2(o, d, tm=None):
            h = closest_fn(o, d, tm)
            t_s, sid, uv = sspheres.intersect_spheres(sph.center, sph.radius, o, d, t_max=tm)
            closer = t_s < h.t
            return HitRecord(t=torch.where(closer, t_s, h.t),
                             tri=torch.where(closer, t_offset + sid, h.tri),
                             bary=torch.where(closer[:, None], uv, h.bary))

        return closest2

    def occluded2(o, d, t):
        return occluded(o, d, t) | sspheres.occluded_spheres(sph.center, sph.radius, o, d, t)

    return (with_spheres(closest), with_spheres(closest_u), occluded2,
            None if closest_b is None else with_spheres(closest_b))


def _tri_trace_fns(scene, cfg: RenderConfig, capture=None):
    """:func:`_trace_fns` of the triangles alone."""
    tracer = resolved_tracer(scene, cfg)

    def record(kind, *rays):
        if capture is not None:
            capture.setdefault(kind, []).append(rays)

    if tracer != "pallas":
        closest_t, occluded_t = _tri_tracers(scene, cfg, tracer)

        def closest(o, d, tm=None):
            record("closest", o, d, tm)
            return closest_t(o, d, tm)

        def occluded(o, d, t):
            record("occluded", o, d, t)
            return occluded_t(o, d, t)

        closest_sorted = closest
        if tracer == "packet" and cfg.sort_rays:
            pos = scene.geo.positions
            closest_sorted = raysort.sorted_closest(closest, pos.amin(dim=0), pos.amax(dim=0))
        return closest_sorted, closest, occluded, None

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
    """(shading row [N, 32], material row [N, 24], normal-texture id [N] or
    None) of each hit: from the block tracer's fused slot payload, or for
    triangle-id hits (and every hit of a scene with analytic spheres) by
    one ``tri_payload`` row gather (row 0 on a miss), whose normal-texture
    ids are gathered by material when needed."""
    if hit.payload is not None:
        return hit.payload[:, 0:32], hit.payload[:, 64:88], hit.payload[:, 63]
    row = scene.tri_payload[torch.clamp(hit.tri, min=0).long()]
    return row[:, 0:32], row[:, 32:56], None


def scene_bounds(scene):
    """(lo, hi) of the triangles and the analytic spheres."""
    lo = scene.geo.positions.amin(dim=0)
    hi = scene.geo.positions.amax(dim=0)
    if scene.spheres.num_spheres > 0:
        r = scene.spheres.radius[:, None]
        lo = torch.minimum(lo, (scene.spheres.center - r).amin(dim=0))
        hi = torch.maximum(hi, (scene.spheres.center + r).amax(dim=0))
    return lo, hi


def light_tile_for(scene, cfg: RenderConfig, seed, scene_lo, scene_hi):
    """Per-frame tile of ``presample_lights`` light samples [T, 16]; with
    coherent_tiles, sorted so consecutive rows are spatially close (area
    rows by position morton, env rows last by direction morton). With
    per-lane seeds the first lane's seed draws the tile, which the batch
    shares (reference :748-751)."""
    t_tile = cfg.presample_lights
    dev = scene.device
    if torch.is_tensor(seed):
        seed = seed.reshape(-1)[0]
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


def light_segment(ls, nee_pos, shadow_origin, scene_lo, scene_hi, pdf_is_w=None):
    """Direction, shadow-segment length, light-side cosine and solid-angle
    pdf of light samples seen from ``nee_pos`` (``pdf_is_w`` lanes, cone
    samples of sphere lights, already hold a solid-angle pdf). Env segments
    are clipped to the scene-bounds exit: nothing can occlude past it, and
    a T_MAX/2 segment would only inflate the tracer's candidate sets."""
    env3 = ls.is_env[..., None]
    to_light = torch.where(env3, ls.position, ls.position - nee_pos)
    dist = torch.where(ls.is_env, _ENV_DIST, smath.length(to_light))
    wi = torch.where(env3, ls.position, to_light / torch.clamp(dist, min=1e-20)[..., None])
    cos_l = torch.where(ls.is_env, 1.0, torch.clamp(smath.dot(-wi, ls.normal), min=0.0))
    g = torch.where(ls.is_env, 1.0, smath.safe_div(cos_l, dist * dist))
    solid = ls.is_env if pdf_is_w is None else ls.is_env | pdf_is_w
    pdf_w = torch.where(solid, ls.pdf_area, smath.safe_div(ls.pdf_area, g))
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
    granule of ``coherent_block`` lanes, keyed by its first lane's pixel
    and seed (``seed`` an int, or per-lane [N]), draws one group of
    ``coherent_tiles`` consecutive tile rows."""
    nb = cfg.coherent_block
    n = px.shape[0]
    n_groups = cfg.presample_lights // cfg.coherent_tiles
    first_x, first_y = px[::nb], py[::nb]
    if torch.is_tensor(seed):  # depth + seed * 131, wrapped to uint32 words
        word = srng.as_u32(seed[::nb].to(torch.int64) * 131 + depth)
    else:
        word = torch.full_like(first_x, srng.u32(depth + seed * 131), dtype=torch.int32)
    key = torch.stack(
        [
            srng.as_u32(first_x), srng.as_u32(first_y), word,
            torch.full_like(first_x, 0x1D1E5, dtype=torch.int32),
        ],
        dim=-1,
    )
    u_grp = srng._bits_to_float(srng.pcg4d(key)[..., 0])
    base = torch.clamp((u_grp * n_groups).to(torch.int64), max=n_groups - 1)
    return torch.repeat_interleave(base * cfg.coherent_tiles, nb)[:n]


def _alpha_retrace(scene, closest_fn, hit, origin, direction, seg_max):
    """Hits past alpha-masked texels continue (reference :811-850): three
    bounded re-traces, each from just past the cut-out hit, merged into the
    record (every field, the fused payload included) where the texel was
    transparent; other lanes trace zero-length segments."""
    spheres = scene.spheres.num_spheres > 0
    for _ in range(3):
        row = scene.geo.packed_tri[torch.clamp(hit.tri, min=0).long()]
        sp = shading_point_from_row(row, hit.tri, hit.bary, direction, True, spheres)
        arow = scene.materials.packed[torch.clamp(sp.material, min=0).long()]
        alpha_tex = arow[..., 18].to(torch.int64)
        a_val = stex.sample_bilinear(scene.textures, alpha_tex, sp.uv)[..., 3]
        transparent = hit.hit & (alpha_tex >= 0) & (a_val < arow[..., 19])
        re_origin = torch.where(
            transparent[..., None],
            origin + direction * (hit.t * 1.0001 + 1e-4)[..., None],
            origin,
        )
        hit2 = closest_fn(re_origin, direction, torch.where(transparent, seg_max, 0.0))
        hit = HitRecord(*(
            None if new is None
            else torch.where(transparent.view((-1,) + (1,) * (new.dim() - 1)), new, old)
            for new, old in zip(hit2, hit)
        ))
    return hit


def _budget(cfg: RenderConfig, b: int, n: int) -> int:
    """Lanes of bounce ``b``'s wave under ``wave_caps``: its fraction of
    ``n`` (the last entry for later bounces) rounded up to 256 lanes."""
    if b == 0:
        return n
    frac = float(cfg.wave_caps[b] if b < len(cfg.wave_caps) else cfg.wave_caps[-1])
    nb = int(np.ceil(n * frac / 256.0)) * 256
    return max(min(nb, n), min(256, n))


def compaction_order(pid, b: int, seed: int, alive):
    """Lane order of the compaction after bounce ``b`` (reference
    :1420-1438): alive lanes first, in the order of a float in [0, 1)
    hashed from (pixel id, b + 1, seed), dead lanes (key 2.0) last; a
    stable sort. The first ``_budget(b + 1)`` lanes are kept."""
    words = torch.stack([
        srng.as_u32(pid), torch.full_like(pid, b + 1, dtype=torch.int32),
        torch.full_like(pid, srng.u32(seed), dtype=torch.int32),
        torch.full_like(pid, 0x5E1EC7, dtype=torch.int32),
    ], dim=-1)
    key = torch.where(alive, srng._bits_to_float(srng.pcg4d(words)[..., 0]), 2.0)
    return torch.sort(key, stable=True).indices


def trace_path(scene, view, cfg: RenderConfig, seed, px=None, py=None, capture=None):
    """One path-traced sample per pixel -> (radiance [N, 3], n_rays int64):
    n_rays counts closest rays of alive lanes plus NEE shadow rays, like
    the reference's counters. ``seed`` is an int, or an int tensor [N] of
    per-lane seeds (``render_path_lanes``). ``capture``: see
    :func:`_trace_fns`.

    Each bounce intersects (re-tracing past alpha-masked texels with
    ``alpha_test``), delta-tracks the volumes up to the surface hit (a
    scatter point becomes the bounce's vertex), adds MIS-weighted emission,
    runs NEE (one light sample, or with ``ris_candidates`` > 1 the
    reservoir's pick of several; shadow segments attenuated through the
    volumes), samples the BSDF or the phase function and applies Russian
    roulette, drawing from each lane's RNG stream in the reference's order.
    With ``wave_caps`` the waves shrink between bounces to the capped lane
    counts (:func:`_budget`): dead lanes drop first, then a uniform subset
    of the alive ones, the survivors carrying the n_alive / cap splitting
    weight, and a dropped lane's radiance goes into the image at once."""
    call = sprof.enter("trace_path")
    check_supported(cfg)
    dev = scene.device
    bsdf_eval, bsdf_sample = _bsdf_fns(cfg)
    scene_lo, scene_hi = scene_bounds(scene)
    trace_closest, trace_closest_u, trace_occluded, trace_closest_b = _trace_fns(
        scene, cfg, capture
    )
    # deferring pays off by amortising the block tracers' candidate prep
    # over the bounces; the others have none (reference :704-707)
    defer = cfg.defer_shadows and resolved_tracer(scene, cfg) in _BLOCK_TRACERS
    has_media = scene.media.density.shape[1] > 1  # the reference's shape check
    spheres = scene.spheres.num_spheres > 0
    span = sprof.begin("camera")
    if px is None:
        px, py = scamera.pixel_grid(cfg.width, cfg.height, dev)
    if torch.is_tensor(seed):
        seed = seed.to(dev)
        if cfg.wave_caps:
            raise ValueError("wave_caps takes one seed per call, not per-lane seeds")
    jitter, st = _ray_jitter(px, py, seed)
    origin, direction = scamera.generate_rays(
        view, px, py, jitter, cfg.width, cfg.height
    )
    n = origin.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    textured = scene.textures.resolution > 1
    alpha = cfg.alpha_test and textured and scene.textures.uses(stex.SLOT_ALPHA)
    cone_angle = 2.0 * torch.tan(view.projection.vertical_fov * 0.5) / cfg.height
    presample_on = cfg.use_nee and cfg.presample_lights > 0
    light_tile = (
        light_tile_for(scene, cfg, seed, scene_lo, scene_hi) if presample_on else None
    )
    c = dict(  # the wavefront's per-lane state
        origin=origin, direction=direction,
        beta=torch.ones((n, 3), **f32), radiance=torch.zeros((n, 3), **f32),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        prev_pdf_w=torch.full((n,), -1.0, **f32),  # < 0: camera vertex
        st=st, cone_dist=torch.zeros((n,), **f32),
        n_rays=torch.zeros((), dtype=torch.int64, device=dev),  # a scalar: never compacted
    )
    sprof.end(span)

    def mis_weight(prev_pdf_w, nee_pdf_w):
        """Weight of a light reached by BSDF sampling (reference :928-937,
        970-982): 1 without NEE; from the camera 1; else the power
        heuristic, or 0 when NEE runs without MIS."""
        if not cfg.use_nee:
            return torch.ones_like(nee_pdf_w)
        other = mis_power_heuristic(prev_pdf_w, nee_pdf_w) if cfg.use_mis else 0.0
        return torch.where(prev_pdf_w < 0.0, 1.0, other)

    def bounce(depth: int, closest_fn, px_l, py_l):
        """One bounce on the lanes of ``c`` (updated in place) -> its
        deferred shadow rays (origin, wi, dist, contrib) or None."""
        span_b = sprof.begin("bounce", depth=depth)
        origin, direction, beta = c["origin"], c["direction"], c["beta"]
        alive, prev_pdf_w, st = c["alive"], c["prev_pdf_w"], c["st"]
        radiance = c["radiance"]
        n_alive = alive.sum()  # the wave's live lanes
        n_rays = c["n_rays"] + n_alive
        # dead lanes trace a zero-length segment: no candidates
        seg_max = torch.where(alive, T_MAX, 0.0)
        span = sprof.begin("closest", lanes=origin.shape[0], live=n_alive)
        hit = closest_fn(origin, direction, seg_max)
        if alpha:
            hit = _alpha_retrace(scene, closest_fn, hit, origin, direction, seg_max)
        sprof.end(span)
        span = sprof.begin("shade")
        srow, mrow, ntex = _hit_rows(scene, hit)
        sp = shading_point_from_row(srow, hit.tri, hit.bary, direction, textured, spheres)
        mat = material_from_row(mrow)
        hit_mask = hit.hit
        if textured:
            # the ray cone: path length so far times the pixel's spread
            # angle, scaled to uv by the hit's uv area, picks the mip level
            c["cone_dist"] = c["cone_dist"] + torch.where(hit_mask & alive, hit.t, 0.0)
            footprint = c["cone_dist"] * cone_angle * torch.sqrt(
                torch.clamp(sp.uv_area, min=0.0))
            lod = stex.ray_cone_lod(scene.textures, footprint)
            u_lod = None
            if cfg.tex_filter == "stochastic":  # drawn before the other draws
                u_tex, st = srng.next_floats(st, 1)
                u_lod = u_tex[..., 0]
            mat = apply_textures(mat, scene.materials, scene.textures, sp.material, sp.uv,
                                 lod, u_lod, mat_row=mrow)
            sp = sp._replace(shading_normal=apply_normal_map(
                sp, scene.materials, scene.textures, lod, tex_id=ntex))

        # volumes: delta tracking up to the surface hit (or the escape)
        surface = alive & hit_mask
        if has_media:
            seg_end = torch.where(hit_mask, hit.t, _ENV_DIST)
            t_scat, m_slot, m_weight, st = smedium.sample_free_flight(
                scene.media, origin, direction, seg_end, st)
            in_medium = alive & torch.isfinite(t_scat)
            m_pos = origin + direction * torch.where(in_medium, t_scat, 0.0)[..., None]
            m_g = scene.media.g[torch.clamp(m_slot, min=0).long()]
            surface = surface & ~in_medium

        # escaped rays: environment, MIS against NEE
        miss = alive & ~hit_mask
        if has_media:
            miss = miss & ~in_medium
        # indirect_only: escapes and emitter hits at depth 0 (seen by the
        # camera) and 1 (the BSDF side of direct light), and NEE at depth 0,
        # belong to the direct pass (reference :938-942, 953-954, 1203-1205)
        direct_pass = cfg.indirect_only and depth < 2
        # debug_path_edges keeps only paths of that many edges: escapes and
        # emitter hits at depth edges - 1, NEE at depth edges - 2
        # (reference :943-944, 955-956, 1206-1207); the draws stay the same
        edges = cfg.debug_path_edges
        other_length = edges > 0 and depth + 1 != edges
        if direct_pass or other_length:
            miss = torch.zeros_like(miss)
        env_le, env_nee_pdf = slights.env_eval_and_pdf_w_mis(scene, direction)
        w_env = mis_weight(prev_pdf_w, env_nee_pdf)
        radiance = radiance + torch.where(
            miss[..., None],
            _firefly_clamp(cfg, beta * env_le * w_env[..., None], depth, 2),
            0.0,
        )

        # emissive hits, MIS against NEE
        is_emissive = surface & (sp.light >= 0) & sp.front_face
        if direct_pass or other_length:
            is_emissive = torch.zeros_like(is_emissive)
        dist2 = smath.length_squared(sp.position - origin)
        cos_light = torch.abs(smath.dot(direction, sp.geom_normal))
        nee_pdf_area = slights.light_pdf_area(scene, hit.tri, sp.light)
        nee_pdf_w = smath.safe_div(nee_pdf_area * dist2, cos_light)
        if spheres and not presample_on:
            # a sphere light is NEE-sampled by its cone (presampled tiles
            # hold area samples, so MIS stays in area measure there)
            cone_pdf, cone_ok = slights.sphere_cone_pdf_w(scene, origin, sp.light)
            nee_pdf_w = torch.where(cone_ok, cone_pdf, nee_pdf_w)
        w_emit = mis_weight(prev_pdf_w, nee_pdf_w)
        radiance = radiance + torch.where(
            is_emissive[..., None],
            _firefly_clamp(cfg, beta * mat.emission * w_emit[..., None], depth, 2),
            0.0,
        )

        alive = alive & hit_mask
        if has_media:
            alive = alive | in_medium
        ns = sp.shading_normal
        wo_local = smath.to_local(-direction, ns)
        mat = mat._replace(
            eta=torch.where(sp.front_face, mat.eta, 1.0 / torch.clamp(mat.eta, min=1e-6))
        )
        # the NEE vertex: the surface hit, or the medium scatter point
        nee_pos = sp.position
        shadow_origin = ray_offset(sp.position, sp.geom_normal)
        if has_media:
            nee_pos = torch.where(in_medium[..., None], m_pos, nee_pos)
            shadow_origin = torch.where(in_medium[..., None], m_pos, shadow_origin)

        def scatter(wi):
            """Vertex throughput toward wi (cosine folded in; albedo x HG
            phase at a medium vertex) and its forward solid-angle pdf."""
            wi_local = smath.to_local(wi, ns)
            ev = bsdf_eval(mat, wo_local, wi_local)
            term = shadow_terminator_factor(sp.geom_normal, ns, wi)
            f = ev.f * (torch.abs(wi_local[..., 2]) * term)[..., None]
            pdf_fwd = ev.pdf_fwd
            if has_media:
                ph = smedium.hg_phase(m_g, smath.dot(direction, wi))
                f = torch.where(in_medium[..., None], m_weight * ph[..., None], f)
                pdf_fwd = torch.where(in_medium, ph, pdf_fwd)
            return f, pdf_fwd

        def nee_light(u):
            """One light sample from nee_pos -> (record, pdf_is_w): a tile
            row with presampling, a sphere light's cone where the scene
            has spheres, else the area/env sampler."""
            if presample_on:
                ct = cfg.coherent_tiles
                if ct > 0:
                    idx = _granule_base(cfg, px_l, py_l, seed, depth) + torch.clamp(
                        (u[..., 0] * ct).to(torch.int64), max=ct - 1)
                else:
                    idx = torch.clamp((u[..., 0] * cfg.presample_lights).to(torch.int64),
                                      max=cfg.presample_lights - 1)
                ls = tile_row_sample(light_tile, idx)
                return ls, torch.zeros_like(ls.is_env)
            if spheres:
                return slights.sample_sphere_light_cone(
                    scene, nee_pos, u[..., 0], u[..., 1], u[..., 2])
            ls = slights.sample_light(scene, u[..., 0], u[..., 1], u[..., 2])
            return ls, torch.zeros_like(ls.is_env)

        nee_off = (cfg.indirect_only and depth == 0) or (edges > 0 and depth + 2 != edges)
        nee_allowed = torch.zeros_like(alive) if nee_off else alive
        shadow = None
        if cfg.use_nee and cfg.ris_candidates > 1:
            # RIS: candidates weighed by their unshadowed contribution, and
            # only the reservoir's pick pays a shadow ray
            nl = alive.shape[0]
            res = sres.init_reservoir(dict(
                contrib=torch.zeros((nl, 3), **f32), wi=torch.zeros((nl, 3), **f32),
                dist=torch.zeros((nl,), **f32), pdf_w=torch.zeros((nl,), **f32),
            ), nl)
            for _ in range(cfg.ris_candidates):
                u, st = srng.next_floats(st, 4)
                ls, pdf_is_w = nee_light(u)
                wi, dist, cos_l, pdf_w = light_segment(
                    ls, nee_pos, shadow_origin, scene_lo, scene_hi, pdf_is_w)
                f_m, _ = scatter(wi)
                c_m = f_m * ls.radiance * smath.safe_div(torch.ones_like(pdf_w), pdf_w)[..., None]
                c_m = torch.where((cos_l > 0)[..., None], c_m, 0.0)
                p_hat = smath.luminance(c_m)
                res = sres.update(res, dict(contrib=c_m, wi=wi, dist=dist, pdf_w=pdf_w),
                                  p_hat, p_hat, u[..., 3])
            wi, dist = res.sample["wi"], res.sample["dist"]
            contrib = beta * res.sample["contrib"] * smath.safe_div(
                res.total_weight, res.m * torch.clamp(res.target_pdf, min=1e-20))[..., None]
            if cfg.use_mis:
                contrib = contrib * mis_power_heuristic(
                    res.sample["pdf_w"], scatter(wi)[1])[..., None]
            candidate = nee_allowed & (res.target_pdf > 0) & (torch.amax(contrib, dim=-1) > 0)
        elif cfg.use_nee:
            u, st = srng.next_floats(st, 3)
            ls, pdf_is_w = nee_light(u)
            wi, dist, cos_l, pdf_w = light_segment(
                ls, nee_pos, shadow_origin, scene_lo, scene_hi, pdf_is_w)
            f, pdf_fwd = scatter(wi)
            w_nee = mis_power_heuristic(pdf_w, pdf_fwd) if cfg.use_mis else 1.0
            contrib = beta * f * ls.radiance * smath.safe_div(w_nee, pdf_w)[..., None]
            candidate = (
                nee_allowed & (pdf_w > 1e-12) & (cos_l > 0.0)
                & (torch.amax(contrib, dim=-1) > 0.0)
            )
        if cfg.use_nee:
            if has_media:  # shadow segments attenuate through the volumes
                trans, st = smedium.transmittance(scene.media, shadow_origin, wi, dist, st)
                contrib = contrib * trans[..., None]
            contrib = _firefly_clamp(cfg, contrib, depth, 1)
            contrib, candidate, st = _shadow_ray_rr(cfg, contrib, candidate, st)
            n_rays = n_rays + candidate.sum()
            if defer:
                shadow = (shadow_origin, wi, torch.where(candidate, dist, 0.0),
                          torch.where(candidate[..., None], contrib, 0.0))
            else:
                occ = trace_occluded(shadow_origin, wi, dist)
                radiance = radiance + torch.where((candidate & ~occ)[..., None], contrib, 0.0)

        # BSDF sampling, or the phase function at a medium vertex
        u, st = srng.next_floats(st, 3)
        bs = bsdf_sample(mat, wo_local, u)
        new_dir = smath.to_world(bs.wi, ns)
        term = shadow_terminator_factor(sp.geom_normal, ns, new_dir)
        throughput = bs.f * smath.safe_div(
            torch.abs(bs.wi[..., 2]) * term, bs.pdf_fwd
        )[..., None]
        new_origin = ray_offset(sp.position, sp.geom_normal * torch.sign(bs.wi[..., 2:3]))
        pdf_next = bs.pdf_fwd
        if has_media:
            hg_dir, hg_pdf = smedium.sample_hg(m_g, -direction, u[..., 0], u[..., 1])
            med3 = in_medium[..., None]
            new_dir = torch.where(med3, hg_dir, new_dir)
            throughput = torch.where(med3, m_weight, throughput)
            new_origin = torch.where(med3, m_pos, new_origin)
            pdf_next = torch.where(in_medium, hg_pdf, pdf_next)
        beta = beta * torch.where(alive[..., None], throughput, 1.0)
        alive = alive & (pdf_next > 1e-12) & (torch.amax(beta, dim=-1) > 0.0)
        c["origin"] = torch.where(alive[..., None], new_origin, origin)
        c["direction"] = torch.where(alive[..., None], new_dir, direction)
        c["prev_pdf_w"] = pdf_next

        # Russian roulette
        u_rr, st = srng.next_float(st)
        if depth >= cfg.rr_depth:
            p_cont = torch.clamp(smath.max3(beta), cfg.rr_min_beta, 1.0)
            survive = u_rr < p_cont
            beta = torch.where(survive[..., None], beta / p_cont[..., None], beta)
            alive = alive & survive
        c.update(beta=beta, alive=alive, st=st, radiance=radiance, n_rays=n_rays)
        sprof.end(span)
        sprof.end(span_b)
        return shadow

    if cfg.wave_caps:
        out = _compacting_bounces(cfg, n, c, bounce, trace_closest, trace_closest_u,
                                  trace_occluded, px, py, seed)
        sprof.end(call)
        return out

    shadow_parts = []
    for depth in range(cfg.max_bounces + 1):
        if depth == 0:
            closest_fn = trace_closest_u
        elif depth <= cfg.binned_bounces:
            closest_fn = trace_closest_b
        else:
            closest_fn = trace_closest
        part = bounce(depth, closest_fn, px, py)
        if part is not None:
            shadow_parts.append(part)
    radiance = c["radiance"]
    if shadow_parts:
        # the deferred shadow wave: every bounce's NEE rays in one pass
        span = sprof.begin("shadow")
        o_f, w_f, t_f, c_f = (torch.cat(x) for x in zip(*shadow_parts))
        occ = trace_occluded(o_f, w_f, t_f)
        hit_contrib = torch.where((~occ & (t_f > 0))[..., None], c_f, 0.0)
        radiance = radiance + hit_contrib.view(len(shadow_parts), n, 3).sum(dim=0)
        sprof.end(span)
    sprof.end(call)
    return radiance, c["n_rays"]


def _compacting_bounces(cfg, n, c, bounce, trace_closest, trace_closest_u, trace_occluded,
                        px, py, seed):
    """The bounce loop under ``wave_caps`` (reference :1381-1501): after a
    bounce whose successor's budget is smaller, the lanes are ordered by
    :func:`compaction_order`; the dropped lanes' radiance is added into the
    image, and the kept ones move through two packed row gathers (14 f32
    columns, 8 int32 ones: RNG words, alive, pixel id and pixel) with the
    splitting weight on their throughput. The deferred shadow wave sums
    the full-width parts and scatters the compacted ones by pixel id."""
    dev = c["alive"].device
    img = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    pid = torch.arange(n, dtype=torch.int32, device=dev)
    px_l, py_l = px, py
    parts = []
    nb_prev = n
    for b in range(cfg.max_bounces + 1):
        part = bounce(b, trace_closest_u if b == 0 else trace_closest, px_l, py_l)
        if part is not None:
            parts.append((part, pid))
        if b == cfg.max_bounces:
            break
        nb_next = min(_budget(cfg, b + 1, n), nb_prev)
        if nb_next == nb_prev:
            continue
        order = compaction_order(pid, b, seed, c["alive"])
        kept, dropped = order[:nb_next], order[nb_next:]
        img.index_add_(0, pid[dropped].long(), c["radiance"][dropped])
        split_w = torch.clamp(c["alive"].sum().to(torch.float32) / np.float32(nb_next), min=1.0)
        fpack = torch.cat([
            c["origin"], c["direction"], c["beta"], c["radiance"],
            c["prev_pdf_w"][:, None], c["cone_dist"][:, None],
        ], dim=-1)[kept]
        ipack = torch.cat([
            c["st"], c["alive"].to(torch.int32)[:, None], pid[:, None],
            px_l.to(torch.int32)[:, None], py_l.to(torch.int32)[:, None],
        ], dim=-1)[kept]
        c.update(
            origin=fpack[:, 0:3], direction=fpack[:, 3:6], beta=fpack[:, 6:9] * split_w,
            radiance=fpack[:, 9:12], prev_pdf_w=fpack[:, 12], cone_dist=fpack[:, 13],
            st=ipack[:, 0:4], alive=ipack[:, 4] > 0,
        )
        pid, px_l, py_l = ipack[:, 5], ipack[:, 6], ipack[:, 7]
        nb_prev = nb_next
    radiance = img.index_add_(0, pid.long(), c["radiance"])
    if parts:
        o_f, w_f, t_f, c_f = (torch.cat(x) for x in zip(*(p for p, _ in parts)))
        occ = trace_occluded(o_f, w_f, t_f)
        hit_contrib = torch.where((~occ & (t_f > 0))[..., None], c_f, 0.0)
        full, tail, tail_pid = [], [], []
        for contrib, (_, p) in zip(hit_contrib.split([x[2].shape[0] for x, _ in parts]), parts):
            if contrib.shape[0] == n:
                full.append(contrib)
            else:
                tail.append(contrib)
                tail_pid.append(p)
        if full:
            radiance = radiance + sum(full)
        if tail:
            radiance = radiance.index_add(0, torch.cat(tail_pid).long(), torch.cat(tail))
    return radiance, c["n_rays"]


def render_path_with_counts(scene, view, cfg: RenderConfig, seed: int, capture=None):
    """One path-traced sample per pixel -> (image [H, W, 3], traced-ray
    count), on the scene's device. On ``"pallas"`` and ``"packet"`` pixels
    are traced in screen tiles of up to 32x64 (``tile_dims``) so ray blocks
    stay compact,
    untiled otherwise (reference :1560-1595); the pixel-keyed RNG makes the
    result independent of that layout. ``capture`` (a dict) collects the
    rays of every tracer call, so a caller can replay the waves this sample
    traced (see :func:`_trace_fns`)."""
    px, py, dims = _pixels(scene, cfg)
    rad, n_rays = trace_path(scene, view, cfg, seed, px, py, capture)
    return _image(rad, cfg, dims), n_rays


def _pixels(scene, cfg: RenderConfig):
    """(px, py, tile dims or None): screen tiles on the block tracers."""
    dims = None
    if resolved_tracer(scene, cfg) in _BLOCK_TRACERS:
        dims = scamera.tile_dims(cfg.width, cfg.height)
    if dims is None:
        return (*scamera.pixel_grid(cfg.width, cfg.height, scene.device), None)
    return (*scamera.pixel_grid_tiled(cfg.width, cfg.height, *dims, scene.device), dims)


def _image(rad, cfg: RenderConfig, dims):
    if dims is None:
        return rad.reshape(cfg.height, cfg.width, 3)
    return scamera.untile_image(rad, cfg.width, cfg.height, *dims)


def render_path(scene, view, cfg: RenderConfig, seed: int):
    """One path-traced sample per pixel -> image [H, W, 3]."""
    return render_path_with_counts(scene, view, cfg, seed)[0]


def render_path_progressive(scene, view, cfg: RenderConfig, spp: int, seed0: int = 0):
    """The mean of ``spp`` path-traced samples at seeds seed0, seed0 + 1, ..."""
    acc = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=scene.device)
    for s in range(spp):
        acc = acc + render_path(scene, view, cfg, seed0 + s)
    return acc / spp


def render_path_batched(scene, view, cfg: RenderConfig, spp: int, seed0: int = 0):
    """The ``spp`` samples at seeds seed0, seed0 + 1, ... accumulated on
    the device with no host synchronisation between them -> (mean image
    [H, W, 3], total traced rays). The reference's ``lax.scan`` over the
    seeds; the same per-sample program and the same sequential sum, so
    the image is :func:`render_path_progressive`'s."""
    px, py, dims = _pixels(scene, cfg)
    acc = torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32, device=scene.device)
    rays = torch.zeros((), dtype=torch.int64, device=scene.device)
    for s in range(spp):
        rad, n_rays = trace_path(scene, view, cfg, seed0 + s, px, py)
        acc, rays = acc + rad, rays + n_rays
    return _image(acc / spp, cfg, dims), rays


def render_path_lanes(scene, view, cfg: RenderConfig, spp: int, seed0: int = 0,
                      capture=None):
    """All ``spp`` samples of every pixel in one wavefront: the lanes are
    [spp x pixels], lane (s, p) traces pixel p at seed seed0 + s, so every
    bounce traces one ``spp * W * H``-lane wave -> (mean image [H, W, 3],
    total traced rays). The per-frame light tile (``presample_lights``)
    comes from seed0 and is shared by the batch, and coherence granules
    may straddle two samples, so with presampling the image equals the
    sequential mean only in expectation; without it, up to the order of the
    sums. Memory grows with ``spp``. ``capture``: see :func:`_trace_fns`."""
    px, py, dims = _pixels(scene, cfg)
    n = cfg.width * cfg.height
    seeds = torch.repeat_interleave(
        seed0 + torch.arange(spp, dtype=torch.int64, device=scene.device), n)
    rad, n_rays = trace_path(scene, view, cfg, seeds, px.repeat(spp), py.repeat(spp), capture)
    return _image(rad.view(spp, n, 3).mean(dim=0), cfg, dims), n_rays


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
    srow, mrow, _ = _hit_rows(scene, hit)
    sp = shading_point_from_row(srow, hit.tri, hit.bary, direction,
                                spheres=scene.spheres.num_spheres > 0)
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
