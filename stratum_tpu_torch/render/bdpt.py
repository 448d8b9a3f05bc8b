"""Bidirectional path tracing: every (s, t) connection strategy with MIS
(counterpart of stratum_tpu/render/bdpt.py).

Both subpaths are dense per-lane vertex arrays [N, depth]. A camera
subpath and a light subpath are walked per lane (:func:`random_walk`: one
closest wave per vertex and subpath set, Russian roulette from
``rr_depth``), then every strategy is evaluated against the stored forward
and reverse area pdfs: s = 0 (the camera path hits an emitter), the
environment (BSDF escape and
environment NEE under the pairwise power heuristic: a light subpath cannot
start at infinity), s = 1 (NEE), s >= 2 x t >= 2 (connections: each camera
vertex to every vertex of its own light subpath, or with
``lvc_connections`` to reservoir picks from the pooled light-vertex cache
of all lanes) and t = 1 (light vertices splatted to the camera). Each
strategy's shadow rays ride ONE occlusion wave (:func:`_batched_occlusion`),
and the t = 1 splat is summed in a fixed order (lighttrace.splat_add).

The reference loops over vertices, light-cache draws and splat slots; here
each strategy runs once over all of them as lanes (:func:`_pairs`), with
per-lane MIS lengths (:func:`_mis_weight_lanes`), the RNG draws taken in
the loops' order and the terms added in it: every lane computes the
loop's value, in far fewer torch ops than the loops issue.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.core import reservoir as sres
from stratum_tpu_torch.core import rng as srng
from stratum_tpu_torch.ops import hashgrid as shg
from stratum_tpu_torch.ops.intersect import T_MAX, HitRecord, ray_offset
from stratum_tpu_torch.render import camera as scamera
from stratum_tpu_torch.render import lights as slights
from stratum_tpu_torch.render.integrator import (
    RenderConfig,
    _bsdf_fns,
    _trace_fns,
    check_supported,
    mis_power_heuristic,
)
from stratum_tpu_torch.render.lighttrace import (
    _LIGHT_STREAM,
    cam_factor,
    hit_shading_point,
    pixel_index,
    splat_add,
)
from stratum_tpu_torch.render.shading import apply_textures, load_material

_ENV_DIST = T_MAX * 0.5


class VertexArrays(NamedTuple):
    """One subpath's surface vertices [N, D] (slot 0 the first surface
    vertex; the camera or the light sample is kept apart)."""

    position: torch.Tensor  # [N, D, 3]
    ns: torch.Tensor  # [N, D, 3] shading normal (toward the arrival side)
    ng: torch.Tensor  # [N, D, 3] geometric normal (same orientation)
    wo: torch.Tensor  # [N, D, 3] unit direction toward the previous vertex
    beta: torch.Tensor  # [N, D, 3] throughput up to this vertex
    pdf_fwd: torch.Tensor  # [N, D] area pdf of generating this vertex
    pdf_rev: torch.Tensor  # [N, D] area pdf of the reverse construction
    material: torch.Tensor  # [N, D] int32 material row
    uv: torch.Tensor  # [N, D, 2]
    front: torch.Tensor  # [N, D] bool front face
    light_row: torch.Tensor  # [N, D] int32 light row, -1 off emitters
    valid: torch.Tensor  # [N, D] bool


class EscapeRecord(NamedTuple):
    """Rays that left the scene during a walk: step i escaped while tracing
    toward vertex i."""

    mask: torch.Tensor  # bool [N, D]
    direction: torch.Tensor  # [N, D, 3]
    beta: torch.Tensor  # [N, D, 3]
    pdf_w: torch.Tensor  # [N, D] solid-angle pdf of the escape direction


def _mat_at(scene, cfg, material, uv, front):
    mat = load_material(scene.materials, material)
    if scene.textures.resolution > 1:
        mat = apply_textures(mat, scene.materials, scene.textures, material, uv)
    return mat._replace(eta=torch.where(front, mat.eta, 1.0 / torch.clamp(mat.eta, min=1e-6)))


def _to_area(pdf_w, from_pos, to_pos, to_ng):
    """Solid-angle pdf at ``from`` -> area pdf at ``to``."""
    d = to_pos - from_pos
    cos_t = torch.abs(smath.dot(smath.normalize(d), to_ng))
    return pdf_w * smath.safe_div(cos_t, smath.length_squared(d))


def _cat_hits(hits):
    return HitRecord(*(None if f[0] is None else torch.cat(f) for f in zip(*hits)))


def random_walk(scene, cfg, st, origin, direction, beta0, pdf_dir_w, depth: int,
                trace_closest=None, splits=None):
    """A subpath of ``depth`` surface vertices and its escapes, Russian
    roulette from ``cfg.rr_depth`` (its compensation in beta, not in the
    stored pdfs) -> (VertexArrays, EscapeRecord, RNG state, the reverse
    area pdf of the endpoint). ``pdf_dir_w`` is the solid-angle pdf of the
    first direction. Dead lanes trace zero-length segments. ``splits``
    (lane counts; default all lanes) walks independent subpath sets at
    once: each traces its own waves, and the shading runs on all lanes
    together."""
    bsdf_eval, bsdf_sample = _bsdf_fns(cfg)
    if trace_closest is None:
        trace_closest = _trace_fns(scene, cfg)[0]
    n, dev = origin.shape[0], origin.device
    ends = np.cumsum(splits or (n,)).tolist()
    parts = list(zip([0] + ends[:-1], ends))

    def trace(o, d, t):
        return _cat_hits([trace_closest(o[a:b], d[a:b], t[a:b]) for a, b in parts])

    f32 = dict(dtype=torch.float32, device=dev)
    cols = {k: [] for k in VertexArrays._fields}
    esc = {k: [] for k in EscapeRecord._fields}
    beta, prev_pos = beta0, origin
    prev_ng = torch.zeros_like(origin)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    endpoint_rev = torch.zeros((n,), **f32)
    for i in range(depth):
        hit = trace(origin, direction, torch.where(alive, T_MAX, 0.0))
        sp = hit_shading_point(scene, hit, direction)
        escaped = alive & ~hit.hit
        esc["mask"].append(escaped)
        esc["direction"].append(torch.where(escaped[:, None], direction, 0.0))
        esc["beta"].append(torch.where(escaped[:, None], beta, 0.0))
        esc["pdf_w"].append(torch.where(escaped, pdf_dir_w, 0.0))
        alive = alive & hit.hit
        pdf_fwd = _to_area(pdf_dir_w, prev_pos, sp.position, sp.geom_normal)
        mat = _mat_at(scene, cfg, sp.material, sp.uv, sp.front_face)
        wo_local = smath.to_local(-direction, sp.shading_normal)
        u, st = srng.next_floats(st, 3)
        bs = bsdf_sample(mat, wo_local, u)
        a1, a3 = alive, alive[:, None]
        for name, val, zero in (
            ("position", sp.position, 0.0), ("ns", sp.shading_normal, 0.0),
            ("ng", sp.geom_normal, 0.0), ("wo", -direction, 0.0), ("beta", beta, 0.0),
            ("pdf_fwd", pdf_fwd, 0.0), ("material", sp.material, -1),
            ("uv", sp.uv, 0.0), ("front", sp.front_face, False),
            ("light_row", sp.light, -1),
        ):
            cols[name].append(torch.where(a3 if val.dim() == 2 else a1, val, zero))
        cols["valid"].append(alive)
        cols["pdf_rev"].append(torch.zeros((n,), **f32))
        # the reverse pdf of the previous vertex (the endpoint's for i = 0)
        rev_area = _to_area(bs.pdf_rev, sp.position, prev_pos, prev_ng)
        if i > 0:
            cols["pdf_rev"][i - 1] = torch.where(alive, rev_area, cols["pdf_rev"][i - 1])
        else:
            endpoint_rev = torch.where(alive, rev_area, endpoint_rev)
        new_dir = smath.to_world(bs.wi, sp.shading_normal)
        thr = bs.f * smath.safe_div(torch.abs(bs.wi[..., 2]), bs.pdf_fwd)[..., None]
        beta = beta * torch.where(a3, thr, 1.0)
        alive_next = alive & (bs.pdf_fwd > 1e-12) & (torch.amax(beta, dim=-1) > 0)
        u_rr, st = srng.next_float(st)
        if i >= cfg.rr_depth:
            p_cont = torch.clamp(smath.max3(beta), cfg.rr_min_beta, 1.0)
            survive = u_rr < p_cont
            beta = torch.where(survive[:, None], beta / p_cont[:, None], beta)
            alive_next = alive_next & survive
        origin = torch.where(
            alive_next[:, None],
            ray_offset(sp.position, sp.geom_normal * torch.sign(bs.wi[..., 2:3])), origin)
        direction = torch.where(alive_next[:, None], new_dir, direction)
        pdf_dir_w, prev_pos, prev_ng, alive = bs.pdf_fwd, sp.position, sp.geom_normal, alive_next
    va = VertexArrays(**{k: torch.stack(v, dim=1) for k, v in cols.items()})
    return va, EscapeRecord(**{k: torch.stack(v, dim=1) for k, v in esc.items()}), st, endpoint_rev


# ---------------------------------------------------------------------------
# MIS weights: forward / reverse ratio loops over the stored vertices
# ---------------------------------------------------------------------------

def _remap0(x):
    return torch.where(x > 0, x, 1.0)


def mis_weight_arrays(z_fwd, z_rev, y_fwd, y_rev, tsurf: int, s: int):
    """Power-heuristic weight of strategy (s, t = tsurf + 1) from the area
    pdfs with the connection's overrides in place. z [N, >= tsurf]: slot j
    is camera vertex z_{j+1}; y [N, >= s]: slot 0 the point on the light."""
    n = z_fwd.shape[0]
    sum_ri = torch.zeros((n,), dtype=torch.float32, device=z_fwd.device)
    ri = torch.ones_like(sum_ri)
    for j in range(tsurf - 1, -1, -1):
        ri = ri * smath.safe_div(_remap0(z_rev[:, j]), _remap0(z_fwd[:, j]))
        sum_ri = sum_ri + ri * ri
    ri = torch.ones_like(sum_ri)
    for j in range(s - 1, -1, -1):
        ri = ri * smath.safe_div(_remap0(y_rev[:, j]), _remap0(y_fwd[:, j]))
        sum_ri = sum_ri + ri * ri
    return 1.0 / (1.0 + sum_ri)


def mis_weight_arrays_dynamic(z_fwd, z_rev, y_fwd, y_rev, tsurf: int, s_var, d_max: int):
    """:func:`mis_weight_arrays` with a per-lane light prefix length
    ``s_var`` [N]: the light side walks slots d_max - 1 .. 0 and counts a
    slot from s_var - 1 down."""
    tsurf_var = torch.full_like(s_var, tsurf)
    return _mis_weight_lanes(z_fwd, z_rev, tsurf_var, tsurf, y_fwd, y_rev, s_var, d_max)


def _mis_weight_lanes(z_fwd, z_rev, tsurf_var, d_cam: int, y_fwd, y_rev, s_var, d_light: int):
    """:func:`mis_weight_arrays` with per-lane ``tsurf`` and ``s``: each
    side walks all its slots and counts a slot from its lane's own length
    down. An uncounted slot leaves the product alone and adds an exact 0,
    so every lane's weight is the static loops' bit for bit."""
    sum_ri = torch.zeros(z_fwd.shape[:1], dtype=torch.float32, device=z_fwd.device)
    for fwd, rev, length, d in ((z_fwd, z_rev, tsurf_var, d_cam), (y_fwd, y_rev, s_var, d_light)):
        ri = torch.ones_like(sum_ri)
        for j in range(d - 1, -1, -1):
            active = j <= length - 1
            ratio = smath.safe_div(_remap0(rev[:, j]), _remap0(fwd[:, j]))
            ri = torch.where(active, ri * ratio, ri)
            sum_ri = sum_ri + torch.where(active, ri * ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


def _pairs(x):
    """A per-vertex field [n, D, ...] as one lane per (vertex, path), vertex
    major: lane j * n + i is vertex j of path i."""
    return x.transpose(0, 1).reshape((-1,) + tuple(x.shape[2:]))


def _tile(x, reps: int):
    """[m, ...] repeated ``reps`` times along the lanes."""
    return x.repeat((reps,) + (1,) * (x.dim() - 1))


def _slot_of(n: int, slots: int, device):
    """The vertex slot of each lane of :func:`_pairs`' layout [slots * n]."""
    return torch.arange(slots, dtype=torch.int32, device=device).repeat_interleave(n)


def _set_slot(arr, slot, val):
    """Rows of ``arr`` [N, D] with column ``slot`` [N] (per lane) set to
    ``val`` [N] (a slot of -1 sets nothing)."""
    iota = torch.arange(arr.shape[1], dtype=torch.int32, device=arr.device)[None, :]
    return torch.where(iota == slot[:, None], val[:, None], arr)


def _accumulate(radiance, terms, n: int):
    """radiance + each vertex's term [slots * n, 3] in vertex order."""
    for j in range(terms.shape[0] // n):
        radiance = radiance + terms[j * n:(j + 1) * n]
    return radiance


def _set_col(arr, j: int, val):
    out = arr.clone()
    out[:, j] = val
    return out


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------

def _camera_dir_pdf_w(view, direction, width: int, height: int):
    """Solid-angle pdf of the pixel-uniform camera ray along ``direction``
    (the pinhole's importance We)."""
    fwd = view.camera_to_world[:, 2]
    cos_c = torch.clamp(smath.dot(direction, fwd), min=1e-6)
    return (width * height) / (view.projection.sensor_area * cos_c ** 3)


def _cam_factor(view, position, width: int, height: int):
    """We cos_c / d^2 of a point connection to the pinhole."""
    return cam_factor(view, position, width * height)


def _batched_occlusion(trace_occluded, rays):
    """ONE occlusion wave over a list of (origin, wi, dist) ray sets, cut
    back into one flag array per set (occlusion is per ray, so the flags
    equal the per-set waves'; callers keep their accumulation order)."""
    o, w, t = (torch.cat(x) for x in zip(*rays))
    occ = trace_occluded(o, w, t)
    return list(occ.split([r[2].shape[0] for r in rays]))


class _Light(NamedTuple):
    """The light subpath with its endpoint as slot 0: [N, depth + 1]."""

    pos: torch.Tensor
    ns: torch.Tensor
    ng: torch.Tensor
    wo: torch.Tensor
    beta: torch.Tensor
    fwd: torch.Tensor
    rev: torch.Tensor
    mat: torch.Tensor
    uvs: torch.Tensor
    front: torch.Tensor
    valid: torch.Tensor


def _connect_paired(scene, cfg, z, radiance, depth, y: _Light, bsdf_eval, trace_occluded,
                    zslot_mat):
    """s >= 2 x t >= 2: every camera vertex to every vertex of its own
    light subpath, all depth^2 shadow rays in one occlusion wave."""
    occ_rays, terms = [], []
    for j in range(depth):  # camera endpoint z_{j+1}
        mat_z = zslot_mat(j)
        wo_z_local = smath.to_local(z.wo[:, j], z.ns[:, j])
        for k in range(1, depth + 1):  # light endpoint: combined slot k
            d_zy = y.pos[:, k] - z.position[:, j]
            dist = smath.length(d_zy)
            wi = d_zy / torch.clamp(dist, min=1e-20)[:, None]
            cos_z = torch.abs(smath.dot(wi, z.ns[:, j]))
            cos_y = torch.abs(smath.dot(-wi, y.ns[:, k]))
            g = smath.safe_div(cos_z * cos_y, dist * dist)
            ev_z = bsdf_eval(mat_z, wo_z_local, smath.to_local(wi, z.ns[:, j]))
            mat_y = _mat_at(scene, cfg, y.mat[:, k], y.uvs[:, k], y.front[:, k])
            ev_y = bsdf_eval(mat_y, smath.to_local(y.wo[:, k], y.ns[:, k]),
                             smath.to_local(-wi, y.ns[:, k]))
            contrib = z.beta[:, j] * ev_z.f * ev_y.f * y.beta[:, k] * g[:, None]
            cand = z.valid[:, j] & y.valid[:, k] & (torch.amax(contrib, dim=-1) > 0)
            occ_rays.append((ray_offset(z.position[:, j], z.ng[:, j]), wi,
                             torch.where(cand, dist, 0.0)))
            z_rev = _set_col(z.pdf_rev, j, _to_area(ev_y.pdf_fwd, y.pos[:, k],
                                                    z.position[:, j], z.ng[:, j]))
            if j >= 1:
                z_rev[:, j - 1] = _to_area(ev_z.pdf_rev, z.position[:, j],
                                           z.position[:, j - 1], z.ng[:, j - 1])
            y_rev = _set_col(y.rev, k, _to_area(ev_z.pdf_fwd, z.position[:, j],
                                                y.pos[:, k], y.ng[:, k]))
            y_rev[:, k - 1] = _to_area(ev_y.pdf_rev, y.pos[:, k], y.pos[:, k - 1],
                                       y.ng[:, k - 1])
            w = mis_weight_arrays(z.pdf_fwd, z_rev, y.fwd[:, : k + 1], y_rev[:, : k + 1],
                                  j + 1, k + 1)
            terms.append((cand, contrib * w[:, None]))
    for (cand, term), occ in zip(terms, _batched_occlusion(trace_occluded, occ_rays)):
        radiance = radiance + torch.where((cand & ~occ)[:, None], term, 0.0)
    return radiance


# cross-frame LVC reservoir history M-cap, in multiples of lvc_connections
LVC_HISTORY_LIMIT = 8.0
_F_PDF = 21  # cache row: 21 vertex columns, then the pdf prefixes


def _connect_lvc(scene, cfg, st, z, radiance, depth, y: _Light, bsdf_eval, trace_occluded,
                 zpair, prev_lvc=None, cam_pos=None):
    """s >= 2 x t >= 2 through the light-vertex cache: each camera vertex
    draws ``cfg.lvc_connections`` cells uniformly from the pooled cache of
    every lane's light vertices, streams them through a reservoir weighted
    by the unshadowed contribution (RIS weight p_hat * depth: a lane owes
    the sum over its depth strategies, and the lanes are iid replicas), and
    shades the winner through one shadow ray with its per-lane dynamic MIS
    weight. ``prev_lvc`` (the previous frame's winners) merges in through a
    hash grid over their camera-vertex positions, its history M capped at
    lvc_connections x LVC_HISTORY_LIMIT -> (radiance, st, this frame's
    winners or None). Every camera vertex and draw is one lane of a single
    evaluation (:func:`_pairs`' vertex-major layout, ``zpair`` the camera
    vertices' fields in it); each lane computes what the reference's loop
    over vertices and draws computes for it."""
    n, dev = z.position.shape[0], z.position.device
    d1 = depth + 1
    n2 = depth * n
    n_draws = cfg.lvc_connections
    zeros3 = torch.zeros((n, 1, 3), dtype=torch.float32, device=dev)
    cache = torch.cat([
        y.pos, y.ns, y.ng, y.wo, y.beta,                     # 0:15
        y.mat[..., None].to(torch.float32),                  # 15
        y.uvs,                                               # 16:18
        y.front[..., None].to(torch.float32),                # 18
        y.valid[..., None].to(torch.float32),                # 19
        torch.arange(d1, dtype=torch.float32, device=dev)[None, :, None].expand(n, d1, 1),
        y.fwd[:, None, :].expand(n, d1, d1),
        y.rev[:, None, :].expand(n, d1, d1),
        torch.cat([zeros3, y.pos[:, :-1]], dim=1),           # the previous vertex
        torch.cat([zeros3, y.ng[:, :-1]], dim=1),
    ], dim=-1).reshape(n * d1, _F_PDF + 2 * d1 + 6)
    cw = cache.shape[1]
    n_cells = n * depth  # slots 1..depth (slot 0 is NEE's s = 1)

    def eval_cand(row, reps: int):
        """Cache rows re-targeted at the camera vertices (``reps`` rows a
        vertex lane): the unshadowed contribution and the four connection
        pdfs -> (payload, p_hat)."""
        z_j, ns_j = _tile(zpair["pos"], reps), _tile(zpair["ns"], reps)
        mat_z = type(zpair["mat"])(*(_tile(f, reps) for f in zpair["mat"]))
        pos_y, ns_y, wo_y, beta_y = row[:, 0:3], row[:, 3:6], row[:, 9:12], row[:, 12:15]
        d_zy = pos_y - z_j
        dist = smath.length(d_zy)
        wi = d_zy / torch.clamp(dist, min=1e-20)[:, None]
        g = smath.safe_div(torch.abs(smath.dot(wi, ns_j)) * torch.abs(smath.dot(-wi, ns_y)),
                           dist * dist)
        ev_z = bsdf_eval(mat_z, _tile(zpair["wo_local"], reps), smath.to_local(wi, ns_j))
        mat_y = _mat_at(scene, cfg, row[:, 15].to(torch.int32), row[:, 16:18], row[:, 18] > 0.5)
        ev_y = bsdf_eval(mat_y, smath.to_local(wo_y, ns_y), smath.to_local(-wi, ns_y))
        contrib = _tile(zpair["beta"], reps) * ev_z.f * ev_y.f * beta_y * g[:, None]
        ok = (row[:, 19] > 0.5) & _tile(zpair["valid"], reps)
        contrib = torch.where(ok[:, None], contrib, 0.0)
        pdf4 = torch.stack([ev_y.pdf_fwd, ev_z.pdf_rev, ev_z.pdf_fwd, ev_y.pdf_rev], dim=-1)
        return dict(contrib=contrib, wi=wi, dist=dist, pdf4=pdf4, row=row), \
            smath.luminance(contrib)

    # the draws of vertex j follow those of vertex j - 1, as in a loop
    grid_draws = 2 if prev_lvc is not None else 0
    per_vertex = 2 * n_draws + grid_draws
    u_all, st = srng.next_floats(st, per_vertex * depth)
    u_all = _pairs(u_all.view(n, depth, per_vertex))  # [n2, per_vertex]
    zf = lambda *shape: torch.zeros((n2,) + shape, dtype=torch.float32, device=dev)  # noqa: E731
    res = sres.init_reservoir(dict(contrib=zf(3), wi=zf(3), dist=zf(), pdf4=zf(4), row=zf(cw)),
                              n2)
    if n_draws:
        u = u_all[:, :2 * n_draws].reshape(n2, n_draws, 2).transpose(0, 1).reshape(-1, 2)
        cell = torch.clamp((u[:, 0] * n_cells).to(torch.int32), max=n_cells - 1)
        lane = cell // depth
        slot = cell - lane * depth + 1  # 1..depth
        cands, p_hats = eval_cand(cache[(lane * d1 + slot).long()], n_draws)
        for r in range(n_draws):
            sl = slice(r * n2, (r + 1) * n2)
            p_hat = p_hats[sl]
            res = sres.update(res, {k: v[sl] for k, v in cands.items()}, p_hat, p_hat * depth,
                              u[sl, 1])

    if prev_lvc is not None:
        prev_grid = shg.build_hashgrid(
            prev_lvc["pos"], shg.cell_size_for(cam_pos, prev_lvc["pos"], 2.0e-3))
        u = u_all[:, 2 * n_draws:]
        ids, valid_q = shg.query(prev_grid, zpair["pos"], max_results=4)
        n_valid = valid_q.sum(dim=-1)
        pick = torch.minimum((u[:, 0] * n_valid).to(torch.int32),
                             torch.clamp(n_valid - 1, min=0).to(torch.int32))
        pid = torch.gather(ids, 1, pick[:, None].long())[:, 0]
        ok = (n_valid > 0) & (pid >= 0) & zpair["valid"]
        prow = prev_lvc["packed"][torch.clamp(pid, min=0).long()]
        cand, p_hat = eval_cand(prow[:, :cw], 1)
        # merge with weight p_hat * W_prev * M_prev (history M capped)
        m_prev = torch.clamp(prow[:, cw + 1], max=cfg.lvc_connections * LVC_HISTORY_LIMIT)
        m_prev = torch.where(ok, m_prev, 0.0)
        w_o = p_hat * prow[:, cw] * m_prev
        total = res.total_weight + w_o
        keep = (u[:, 1] * torch.clamp(total, min=1e-20)) < w_o
        res = sres.Reservoir(sample=sres._select(keep, cand, res.sample),
                             target_pdf=torch.where(keep, p_hat, res.target_pdf),
                             total_weight=total, m=res.m + m_prev)

    kept = res.sample
    w_ris = smath.safe_div(res.total_weight, res.m * torch.clamp(res.target_pdf, min=1e-20))
    new_lvc = None
    if prev_lvc is not None or cam_pos is not None:
        # this frame's winners at their camera vertices, for the next frame
        new_lvc = dict(pos=zpair["pos"],
                       packed=torch.cat([kept["row"], w_ris[:, None], res.m[:, None]], dim=-1))
    row = kept["row"]
    pos_y, ng_y = row[:, 0:3], row[:, 6:9]
    k_w = row[:, 20].to(torch.int32)
    evy_fwd, evz_rev, evz_fwd, evy_rev = kept["pdf4"].unbind(-1)
    j_lane = zpair["slot"]
    z_rev = _set_slot(zpair["pdf_rev_rows"], j_lane,
                      _to_area(evy_fwd, pos_y, zpair["pos"], zpair["ng"]))
    z_rev = _set_slot(z_rev, torch.where(j_lane >= 1, j_lane - 1, -1),
                      _to_area(evz_rev, zpair["pos"], zpair["prev_pos"], zpair["prev_ng"]))
    # the light side's overrides at the winner's own slots k, k - 1
    y_rev = _set_slot(row[:, _F_PDF + d1: _F_PDF + 2 * d1], k_w,
                      _to_area(evz_fwd, zpair["pos"], pos_y, ng_y))
    y_rev = _set_slot(y_rev, k_w - 1, _to_area(
        evy_rev, pos_y, row[:, _F_PDF + 2 * d1: _F_PDF + 2 * d1 + 3],
        row[:, _F_PDF + 2 * d1 + 3: _F_PDF + 2 * d1 + 6]))
    w_mis = _mis_weight_lanes(zpair["pdf_fwd_rows"], z_rev, j_lane + 1, depth,
                              row[:, _F_PDF: _F_PDF + d1], y_rev, k_w + 1, d1)
    cand = res.target_pdf > 0
    # the winners' shadow rays of every camera vertex in ONE occlusion wave
    (occ,) = _batched_occlusion(trace_occluded, [(
        ray_offset(zpair["pos"], zpair["ng"]), kept["wi"], torch.where(cand, kept["dist"], 0.0))])
    terms = torch.where((cand & ~occ)[:, None], kept["contrib"] * (w_ris * w_mis)[:, None], 0.0)
    return _accumulate(radiance, terms, n), st, new_lvc


def trace_bdpt(scene, view, cfg: RenderConfig, seed, px=None, py=None, lane0=0,
               num_light_paths=None, prev_lvc=None, want_lvc_state=False, capture=None):
    """One bidirectional sample per pixel -> (radiance [N, 3] of the t >= 2
    strategies, splat image [W*H, 3] of t = 1), plus this frame's light
    cache winners with ``want_lvc_state``. ``px``/``py`` default to the
    whole pixel grid; a caller tracing a part of it passes ``lane0`` (the
    global index of its first lane: the light paths' RNG streams stay
    unique) and ``num_light_paths`` (all lanes', the splat's 1/N).
    ``capture``: see integrator._trace_fns.

    The camera and light subpaths are walked together (each wave traced
    per subpath set: camera wave i, then light wave i), and each strategy
    is evaluated for every vertex of a path at once, in :func:`_pairs`'
    vertex-major lanes; its terms are added in the reference's order."""
    check_supported(cfg)
    dev = scene.device
    bsdf_eval, _ = _bsdf_fns(cfg)
    trace_closest, _, trace_occluded, _ = _trace_fns(scene, cfg, capture)
    width, height = cfg.width, cfg.height
    num_pix = width * height
    depth = cfg.max_bounces + 1  # surface vertices per subpath
    f32 = dict(dtype=torch.float32, device=dev)

    # ---- the camera subpath's start ---------------------------------------
    if px is None:
        px, py = scamera.pixel_grid(width, height, dev)
    st = srng.rng_init(px, py, seed)
    u, st = srng.next_floats(st, 2)
    origin, direction = scamera.generate_rays(view, px, py, u, width, height)
    n = origin.shape[0]

    # ---- the light subpath's start ----------------------------------------
    # the light-start pdf folds in the area branch's selection probability
    has_light = scene.lights.num_lights > 0
    p_area_sel = 1.0 - scene.lights.env_probability if has_light else 0.0
    stl = srng.rng_init(lane0 + torch.arange(n, dtype=torch.int64, device=dev),
                        _LIGHT_STREAM, seed)
    u, stl = srng.next_floats(stl, 3)
    ls = slights.sample_area_light(scene, u[..., 0], u[..., 1], u[..., 2])
    ls = ls._replace(pdf_area=ls.pdf_area * p_area_sel)
    u, stl = srng.next_floats(stl, 2)
    ldir_local = smath.sample_cos_hemisphere(u[..., 0], u[..., 1])
    ldir = smath.to_world(ldir_local, ls.normal)
    y0_beta = ls.radiance * smath.safe_div(1.0, ls.pdf_area)[..., None]
    if not has_light:
        y0_beta = torch.zeros_like(y0_beta)

    # ---- both walks, one wave of each set per vertex ------------------------
    walk, walk_esc, st_both, rev_both = random_walk(
        scene, cfg, torch.cat([st, stl]),
        torch.cat([origin, ray_offset(ls.position, ls.normal)]), torch.cat([direction, ldir]),
        torch.cat([torch.ones((n, 3), **f32), y0_beta * np.pi]),
        torch.cat([_camera_dir_pdf_w(view, direction, width, height),
                   smath.cosine_hemisphere_pdfW(ldir_local[..., 2])]),
        depth, trace_closest, splits=(n, n))
    z = VertexArrays(*(f[:n] for f in walk))
    yw = VertexArrays(*(f[n:] for f in walk))
    z_esc = EscapeRecord(*(f[:n] for f in walk_esc))
    st = st_both[:n]

    def prepend(a0, a):
        return torch.cat([a0[:, None], a], dim=1)

    y = _Light(
        pos=prepend(ls.position, yw.position), ns=prepend(ls.normal, yw.ns),
        ng=prepend(ls.normal, yw.ng), wo=prepend(torch.zeros((n, 3), **f32), yw.wo),
        beta=prepend(y0_beta, yw.beta), fwd=prepend(ls.pdf_area, yw.pdf_fwd),
        rev=prepend(rev_both[n:], yw.pdf_rev),
        mat=prepend(torch.full((n,), -1, dtype=torch.int32, device=dev), yw.material),
        uvs=prepend(torch.zeros((n, 2), **f32), yw.uv),
        front=prepend(torch.ones((n,), dtype=torch.bool, device=dev), yw.front),
        valid=prepend((ls.pdf_area > 0) & has_light, yw.valid & has_light),
    )

    radiance = torch.zeros((n, 3), **f32)
    splat = torch.zeros((num_pix, 3), **f32)
    cam_pos = view.camera_to_world[:, 3]

    # every camera vertex as one lane (vertex major), with what the
    # strategies read of it and of the vertex before it
    zeros3 = torch.zeros((n, 1, 3), **f32)
    zpair = dict(
        pos=_pairs(z.position), ns=_pairs(z.ns), ng=_pairs(z.ng), beta=_pairs(z.beta),
        valid=_pairs(z.valid), light_row=_pairs(z.light_row), front=_pairs(z.front),
        prev_pos=_pairs(torch.cat([zeros3, z.position[:, :-1]], dim=1)),
        prev_ng=_pairs(torch.cat([zeros3, z.ng[:, :-1]], dim=1)),
        pdf_fwd_rows=_tile(z.pdf_fwd, depth), pdf_rev_rows=_tile(z.pdf_rev, depth),
        slot=_slot_of(n, depth, dev),
        mat=_mat_at(scene, cfg, _pairs(z.material), _pairs(z.uv), _pairs(z.front)),
    )
    zpair["wo_local"] = smath.to_local(_pairs(z.wo), zpair["ns"])
    j_lane = zpair["slot"]
    prev_slot = torch.where(j_lane >= 1, j_lane - 1, -1)
    zero_y = torch.zeros((depth * n, 1), **f32)

    def emission_dir_pdf_area(light_pos, light_ng, to_pos, to_ng):
        """Area pdf of the cosine emission sampler toward ``to_pos``."""
        d = smath.normalize(to_pos - light_pos)
        pdf_w = smath.cosine_hemisphere_pdfW(smath.dot(d, light_ng))
        return _to_area(pdf_w, light_pos, to_pos, to_ng)

    # ---- s = 0: the camera path hits an emitter -----------------------------
    on_light = zpair["valid"] & (zpair["light_row"] >= 0) & zpair["front"]
    z_rev = _set_slot(zpair["pdf_rev_rows"], j_lane,
                      slights.light_pdf_area(scene, zpair["light_row"], zpair["light_row"]))
    z_rev = _set_slot(z_rev, prev_slot, emission_dir_pdf_area(
        zpair["pos"], zpair["ng"], zpair["prev_pos"], zpair["prev_ng"]))
    w = _mis_weight_lanes(zpair["pdf_fwd_rows"], z_rev, j_lane + 1, depth, zero_y, zero_y,
                          torch.zeros_like(j_lane), 0)
    radiance = _accumulate(radiance, torch.where(
        on_light[:, None], zpair["beta"] * zpair["mat"].emission * w[:, None], 0.0), n)

    # ---- the environment: escaped camera rays (and env NEE at s = 1) ------
    le, env_pdf = slights.env_eval_and_pdf_w_mis(scene, _pairs(z_esc.direction))
    w_env = torch.where(j_lane == 0, 1.0, mis_power_heuristic(_pairs(z_esc.pdf_w), env_pdf))
    radiance = _accumulate(radiance, torch.where(
        _pairs(z_esc.mask)[:, None], _pairs(z_esc.beta) * le * w_env[:, None], 0.0), n)

    # ---- s = 1: NEE from every camera vertex, one occlusion wave ----------
    u, st = srng.next_floats(st, 3 * depth)
    u = _pairs(u.view(n, depth, 3))
    lsj = slights.sample_light(scene, u[:, 0], u[:, 1], u[:, 2])
    env3 = lsj.is_env[:, None]
    to_y = torch.where(env3, lsj.position, lsj.position - zpair["pos"])
    dist = torch.where(lsj.is_env, _ENV_DIST, smath.length(to_y))
    wi = torch.where(env3, lsj.position, to_y / torch.clamp(dist, min=1e-20)[:, None])
    cos_l = torch.where(lsj.is_env, 1.0, torch.clamp(smath.dot(-wi, lsj.normal), min=0.0))
    cos_z = torch.abs(smath.dot(wi, zpair["ns"]))
    ev = bsdf_eval(zpair["mat"], zpair["wo_local"], smath.to_local(wi, zpair["ns"]))
    g = smath.safe_div(cos_l * cos_z, dist * dist)
    contrib_area = zpair["beta"] * ev.f * lsj.radiance * smath.safe_div(g, lsj.pdf_area)[:, None]
    contrib_env = (zpair["beta"] * ev.f * lsj.radiance
                   * smath.safe_div(cos_z, lsj.pdf_area)[:, None])
    contrib = torch.where(env3, contrib_env, contrib_area)
    cand = (zpair["valid"] & (lsj.pdf_area > 0) & (cos_l > 0)
            & (torch.amax(contrib, dim=-1) > 0) & (lsj.is_env | has_light))
    y_fwd1 = lsj.pdf_area[:, None]
    y_rev1 = _to_area(ev.pdf_fwd, zpair["pos"], lsj.position, lsj.normal)[:, None]
    z_rev = _set_slot(zpair["pdf_rev_rows"], j_lane, emission_dir_pdf_area(
        lsj.position, lsj.normal, zpair["pos"], zpair["ng"]))
    z_rev = _set_slot(z_rev, prev_slot, _to_area(ev.pdf_rev, zpair["pos"], zpair["prev_pos"],
                                                 zpair["prev_ng"]))
    w_area = _mis_weight_lanes(zpair["pdf_fwd_rows"], z_rev, j_lane + 1, depth, y_fwd1, y_rev1,
                               torch.ones_like(j_lane), 1)
    w = torch.where(lsj.is_env, mis_power_heuristic(lsj.pdf_area, ev.pdf_fwd), w_area)
    (occ,) = _batched_occlusion(trace_occluded, [
        (ray_offset(zpair["pos"], zpair["ng"]), wi, torch.where(cand, dist, 0.0))])
    radiance = _accumulate(radiance, torch.where((cand & ~occ)[:, None], contrib * w[:, None],
                                                 0.0), n)

    # ---- s >= 2, t >= 2: subpath connections ------------------------------
    new_lvc = None
    if cfg.lvc_connections > 0:
        radiance, st, new_lvc = _connect_lvc(
            scene, cfg, st, z, radiance, depth, y, bsdf_eval, trace_occluded, zpair,
            prev_lvc=prev_lvc,
            # the reference passes the camera only with want_lvc_state, and
            # then fails building the previous frame's grid without it
            cam_pos=cam_pos if want_lvc_state or prev_lvc is not None else None)
    else:
        mats = {}

        def zslot_mat(j):
            if j not in mats:
                mats[j] = _mat_at(scene, cfg, z.material[:, j], z.uv[:, j], z.front[:, j])
            return mats[j]

        radiance = _connect_paired(scene, cfg, z, radiance, depth, y, bsdf_eval,
                                   trace_occluded, zslot_mat)

    # ---- t = 1: every light vertex splatted to the camera ------------------
    d1 = depth + 1
    k_lane = _slot_of(n, d1, dev)
    ypos, yns, yng = _pairs(y.pos), _pairs(y.ns), _pairs(y.ng)
    to_cam = cam_pos - ypos
    dist = smath.length(to_cam)
    wi = to_cam / torch.clamp(dist, min=1e-20)[:, None]
    mat_y = _mat_at(scene, cfg, _pairs(y.mat), _pairs(y.uvs), _pairs(y.front))
    ev_y = bsdf_eval(mat_y, smath.to_local(_pairs(y.wo), yns), smath.to_local(wi, yns))
    on_light = k_lane == 0  # the light sample itself: emission toward the camera
    f_y = torch.where(on_light[:, None], 1.0, ev_y.f)
    ok_dir = ~on_light | (smath.dot(wi, yns) > 0)
    cosy = torch.abs(smath.dot(wi, yns))
    cf = _cam_factor(view, ypos, width, height)
    norm = num_light_paths if num_light_paths else n
    contrib = _pairs(y.beta) * f_y * (cosy * cf / norm)[:, None]
    pix, inside, _ = scamera.sensor_importance(view, ypos, width, height)
    cand = _pairs(y.valid) & ok_dir & inside & (torch.amax(contrib, dim=-1) > 0)
    zeros3 = torch.zeros((n, 1, 3), **f32)
    y_rev = _set_slot(_tile(y.rev, d1), k_lane, _to_area(
        _camera_dir_pdf_w(view, -wi, width, height), cam_pos, ypos, yng))
    y_rev = _set_slot(y_rev, k_lane - 1, _to_area(
        ev_y.pdf_rev, ypos, _pairs(torch.cat([zeros3, y.pos[:, :-1]], dim=1)),
        _pairs(torch.cat([zeros3, y.ng[:, :-1]], dim=1))))
    zero1 = torch.zeros((d1 * n, 1), **f32)
    w = _mis_weight_lanes(zero1, zero1, torch.zeros_like(k_lane), 0, _tile(y.fwd, d1), y_rev,
                          k_lane + 1, d1)
    (occ,) = _batched_occlusion(trace_occluded, [
        (ray_offset(ypos, yng), wi, torch.where(cand, dist, 0.0))])
    splat = splat_add(splat, pixel_index(pix, width, height),
                      torch.where((cand & ~occ)[:, None], contrib * w[:, None], 0.0))
    if want_lvc_state:
        return radiance, splat, new_lvc
    return radiance, splat


def render_bdpt(scene, view, cfg: RenderConfig, seed):
    """One BDPT sample per pixel -> image [H, W, 3]."""
    rad, splat = trace_bdpt(scene, view, cfg, seed)
    return (rad + splat).reshape(cfg.height, cfg.width, 3)


def render_bdpt_reuse(scene, view, cfg: RenderConfig, seed, prev_lvc=None):
    """One BDPT frame with cross-frame light-cache reuse -> (image, state);
    feed the state back as ``prev_lvc`` on the next frame (a static scene
    and camera keep the estimator consistent in the mean)."""
    rad, splat, new_lvc = trace_bdpt(scene, view, cfg, seed, prev_lvc=prev_lvc,
                                     want_lvc_state=True)
    return (rad + splat).reshape(cfg.height, cfg.width, 3), new_lvc


# pixels per chunk of the reference (its TPU's memory); the card takes the
# chunk count from the caller (bench.py: 16 at 1080p)
CHUNK_PIXELS = 1 << 18


def render_bdpt_chunked(scene, view, cfg: RenderConfig, seed, chunks: int | None = None):
    """BDPT over the pixel domain in ``chunks`` equal parts, so the subpath
    arrays are [chunk, depth]: each chunk traces its slice of the light
    paths (unique streams through ``lane0``) and splats into the shared
    image, normalised by the total light-path count, so the sum is the
    unchunked estimator (with LVC, reservoirs draw from the chunk's pool:
    a variance change, not a bias)."""
    num_pix = cfg.width * cfg.height
    if chunks is None:
        chunks = max(1, -(-num_pix // CHUNK_PIXELS))
    if num_pix % chunks:
        raise ValueError(f"{num_pix} pixels not divisible by {chunks} chunks")
    per = num_pix // chunks
    px, py = scamera.pixel_grid(cfg.width, cfg.height, scene.device)
    rads = []
    splat = torch.zeros((num_pix, 3), dtype=torch.float32, device=scene.device)
    for c in range(chunks):
        sl = slice(c * per, (c + 1) * per)
        rad_c, splat_c = trace_bdpt(scene, view, cfg, seed, px[sl], py[sl], lane0=c * per,
                                    num_light_paths=num_pix)
        rads.append(rad_c)
        splat = splat + splat_c
    return (torch.cat(rads) + splat).reshape(cfg.height, cfg.width, 3)


def render_bdpt_progressive(scene, view, cfg: RenderConfig, spp: int, seed0: int = 0,
                            chunks: int | None = None):
    """The mean of ``spp`` BDPT samples at seeds seed0, seed0 + 1, ..."""
    acc = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=scene.device)
    num_pix = cfg.width * cfg.height
    auto = chunks if chunks is not None else -(-num_pix // CHUNK_PIXELS)
    for s in range(spp):
        if auto > 1:
            acc = acc + render_bdpt_chunked(scene, view, cfg, seed0 + s, auto)
        else:
            acc = acc + render_bdpt(scene, view, cfg, seed0 + s)
    return acc / spp
