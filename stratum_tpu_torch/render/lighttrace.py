"""Light tracing: light subpaths splatted to the camera (counterpart of
stratum_tpu/render/lighttrace.py).

Subpaths start on a light (a power-weighted point and a cosine-weighted
direction), bounce through the scene, and at every vertex connect to the
pinhole with a visibility ray; the contribution lands on the pixel the
vertex projects to. The pinhole's importance is We = N_pix / (A_plane
cos^3 theta_c), so a connection from vertex y carries
``beta f cos(theta_y) We cos(theta_c) / d^2``.

Many lanes land on one pixel, so the splat is a scatter-add. On the card
an atomic ``index_add_`` sums in whatever order the threads arrive, which
makes two renders of one seed differ in the last bits; :func:`splat_add`
sums each pixel's terms in a fixed order instead (a stable sort by pixel,
then a pairwise tree within each pixel's run), on the CPU and the card
alike.
"""

from __future__ import annotations

import numpy as np
import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.core import rng as srng
from stratum_tpu_torch.core import transform as xform
from stratum_tpu_torch.ops.intersect import T_MAX, ray_offset
from stratum_tpu_torch.render import camera as scamera
from stratum_tpu_torch.render import lights as slights
from stratum_tpu_torch.render.integrator import (
    RenderConfig,
    _bsdf_fns,
    _hit_rows,
    _trace_fns,
    check_supported,
)
from stratum_tpu_torch.render.shading import (
    adjoint_ns_factor,
    apply_textures,
    load_material,
    shading_point_from_row,
)

# RNG stream of light paths: the state's second word, where camera streams
# hold the pixel row
_LIGHT_STREAM = srng.u32(0x9E3779B9)


def splat_add(image, idx, val):
    """``image[idx] += val`` for rows ``val`` [M, C] at pixels ``idx`` [M],
    summed in an order fixed by the data: the terms are stably sorted by
    pixel, and within each pixel's run the term at rank r takes in the one
    at rank r + s for s = 1, 2, 4, ... where r is a multiple of 2s, so the
    run's first term ends up holding its sum; those sums are added at their
    (distinct) pixels. Deterministic on the card, unlike an atomic add."""
    m = idx.shape[0]
    if m == 0:
        return image
    idx = idx.to(torch.int64)
    order = torch.sort(idx, stable=True).indices
    key, v = idx[order], val[order]
    pos = torch.arange(m, device=idx.device)
    head = torch.ones(m, dtype=torch.bool, device=idx.device)
    head[1:] = key[1:] != key[:-1]
    rank = pos - torch.cummax(torch.where(head, pos, 0), dim=0).values
    s = 1
    while s < m:
        partner = torch.clamp(pos + s, max=m - 1)
        take = (pos + s < m) & (key[partner] == key) & (rank % (2 * s) == 0)
        v = v + torch.where(take[:, None], v[partner], 0.0)
        s *= 2
    return image.index_put((key[head],), v[head], accumulate=True)


def cam_factor(view, position, num_pix: int):
    """We cos_c / d^2 of a point connection to the pinhole."""
    p_cam = xform.transform_point(view.world_to_camera, position)
    dist2 = smath.length_squared(p_cam)
    cos_c = torch.abs(p_cam[..., 2]) / torch.clamp(torch.sqrt(dist2), min=1e-20)
    a_plane = view.projection.sensor_area
    we = num_pix / torch.clamp(a_plane * cos_c ** 3, min=1e-20)
    return smath.safe_div(we * cos_c, dist2)


def pixel_index(pix, width: int, height: int):
    """Flat pixel of projected sensor coordinates (truncated, clamped)."""
    pxi = torch.clamp(pix[..., 0].to(torch.int32), 0, width - 1)
    pyi = torch.clamp(pix[..., 1].to(torch.int32), 0, height - 1)
    return pyi.to(torch.int64) * width + pxi


def hit_shading_point(scene, hit, direction):
    """Shading point of a closest hit with its uv and material row: from
    the block tracer's fused payload, or a ``tri_payload`` row by triangle."""
    srow, _, _ = _hit_rows(scene, hit)
    return shading_point_from_row(srow, hit.tri, hit.bary, direction, True,
                                  scene.spheres.num_spheres > 0)


def trace_light(scene, view, cfg: RenderConfig, seed, num_paths=None, lane0=0,
                total_paths=None):
    """``num_paths`` (default W*H) light subpaths, each vertex splatted to
    the camera -> image [H, W, 3]: an estimate of the path tracer's image
    without directly visible emitters (render_lt adds those). ``lane0``
    offsets the path ids (globally unique streams) and ``total_paths`` the
    estimator's 1/N."""
    check_supported(cfg)
    dev = scene.device
    bsdf_eval, bsdf_sample = _bsdf_fns(cfg)
    trace_closest, _, trace_occluded, _ = _trace_fns(scene, cfg)
    n = num_paths if num_paths is not None else cfg.width * cfg.height
    norm = total_paths if total_paths else n
    path_id = lane0 + torch.arange(n, dtype=torch.int64, device=dev)
    st = srng.rng_init(path_id, _LIGHT_STREAM, seed)
    cam_pos = view.camera_to_world[:, 3]
    num_pix = cfg.width * cfg.height
    image = torch.zeros((num_pix, 3), dtype=torch.float32, device=dev)

    u, st = srng.next_floats(st, 3)
    ls = slights.sample_area_light(scene, u[..., 0], u[..., 1], u[..., 2])
    u, st = srng.next_floats(st, 2)
    local_dir = smath.sample_cos_hemisphere(u[..., 0], u[..., 1])
    direction = smath.to_world(local_dir, ls.normal)
    beta = ls.radiance * smath.safe_div(np.pi, ls.pdf_area)[..., None]
    origin = ray_offset(ls.position, ls.normal)
    alive = (ls.pdf_area > 0) & (torch.amax(ls.radiance, dim=-1) > 0)
    textured = scene.textures.resolution > 1

    for _ in range(cfg.max_bounces + 1):
        hit = trace_closest(origin, direction, torch.where(alive, T_MAX, 0.0))
        sp = hit_shading_point(scene, hit, direction)
        mat = load_material(scene.materials, sp.material)
        if textured:
            mat = apply_textures(mat, scene.materials, scene.textures, sp.material, sp.uv)
        mat = mat._replace(
            eta=torch.where(sp.front_face, mat.eta, 1.0 / torch.clamp(mat.eta, min=1e-6)))
        alive = alive & hit.hit
        ns = sp.shading_normal
        wo_local = smath.to_local(-direction, ns)

        # connect this vertex to the camera
        to_cam = cam_pos - sp.position
        dist_c = smath.length(to_cam)
        wi_cam = to_cam / torch.clamp(dist_c, min=1e-20)[..., None]
        wi_cam_local = smath.to_local(wi_cam, ns)
        ev = bsdf_eval(mat, wo_local, wi_cam_local)
        adj_ns = adjoint_ns_factor(sp.geom_normal, ns, -direction, wi_cam)
        contrib = beta * ev.f * (torch.abs(wi_cam_local[..., 2]) * adj_ns
                                 * cam_factor(view, sp.position, num_pix) / norm)[..., None]
        pix, inside, _ = scamera.sensor_importance(view, sp.position, cfg.width, cfg.height)
        ok = alive & (torch.amax(contrib, dim=-1) > 0)
        occluded = trace_occluded(ray_offset(sp.position, sp.geom_normal), wi_cam,
                                  torch.where(ok & inside, dist_c, 0.0))
        ok = ok & inside & ~occluded
        image = splat_add(image, pixel_index(pix, cfg.width, cfg.height),
                          torch.where(ok[..., None], contrib, 0.0))

        # continue the subpath; importance transport carries eta^2 through
        # refraction and the shading-normal adjoint factor
        u, st = srng.next_floats(st, 3)
        bs = bsdf_sample(mat, wo_local, u)
        new_dir = smath.to_world(bs.wi, ns)
        thr = bs.f * smath.safe_div(torch.abs(bs.wi[..., 2]), bs.pdf_fwd)[..., None]
        adj = torch.where(bs.eta > 0, bs.eta * bs.eta, 1.0)
        adj = adj * adjoint_ns_factor(sp.geom_normal, ns, -direction, new_dir)
        beta = beta * torch.where(alive[..., None], thr * adj[..., None], 1.0)
        alive = alive & (bs.pdf_fwd > 1e-12) & (torch.amax(beta, dim=-1) > 0)
        origin = torch.where(
            alive[..., None],
            ray_offset(sp.position, sp.geom_normal * torch.sign(bs.wi[..., 2:3])), origin)
        direction = torch.where(alive[..., None], new_dir, direction)

        # Russian roulette on the light path
        u_rr, st = srng.next_float(st)
        p_cont = torch.clamp(smath.max3(beta), cfg.rr_min_beta, 1.0)
        survive = u_rr < p_cont
        beta = torch.where(survive[..., None], beta / p_cont[..., None], beta)
        alive = alive & survive
    return image.reshape(cfg.height, cfg.width, 3)


def trace_emission_only(scene, view, cfg: RenderConfig, seed):
    """Camera rays that gather only directly visible emission and the
    environment: the strategy light tracing cannot produce -> [H, W, 3]."""
    check_supported(cfg)
    dev = scene.device
    trace_closest = _trace_fns(scene, cfg)[0]
    px, py = scamera.pixel_grid(cfg.width, cfg.height, dev)
    st = srng.rng_init(px, py, seed)
    u, st = srng.next_floats(st, 2)
    origin, direction = scamera.generate_rays(view, px, py, u, cfg.width, cfg.height)
    hit = trace_closest(origin, direction)
    sp = hit_shading_point(scene, hit, direction)
    mat = load_material(scene.materials, sp.material)
    rad = torch.where(
        (~hit.hit)[..., None],
        slights.eval_environment(scene, direction),
        torch.where((sp.front_face & (sp.light >= 0))[..., None], mat.emission, 0.0),
    )
    return rad.reshape(cfg.height, cfg.width, 3)


def render_lt(scene, view, cfg: RenderConfig, seed):
    """A complete light-traced image: the splats plus directly visible
    emission."""
    return trace_light(scene, view, cfg, seed) + trace_emission_only(scene, view, cfg, seed)


def render_lt_progressive(scene, view, cfg: RenderConfig, spp: int, seed0: int = 0):
    """The mean of ``spp`` light-traced samples at seeds seed0, seed0 + 1, ..."""
    return _render_lt_batched(scene, view, cfg, spp, seed0)


def _render_lt_batched(scene, view, cfg: RenderConfig, spp: int, seed0: int = 0):
    """The samples accumulated on the device in the sequential order (the
    reference's scan over seeds)."""
    acc = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=scene.device)
    for s in range(spp):
        acc = acc + render_lt(scene, view, cfg, seed0 + s)
    return acc / spp
