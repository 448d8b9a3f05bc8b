"""The radiance of judged path lanes, worked out again along the program's
own random decisions. Plain torch.

The estimator is the one the configuration states: a unidirectional path
tracer with next-event estimation, the power heuristic between a light
sample and the BSDF's sample, and Russian roulette from ``rr_depth`` on
(survival ``min(1, max(rr_min_beta, max_c beta_c))``, survivors divided by
it). The BSDF is the principled (Disney) mixture of a Burley diffuse lobe
weighted ``1 - metallic`` and a GGX metal lobe with Schlick's Fresnel on
the base colour weighted ``metallic``; its pdf is the same mixture of a
cosine hemisphere and the visible-normal pdf. Shading normals are the
interpolated smooth vertex normals, softened at the terminator by
``g + g^2 - g^3`` of ``g = |ng.wi| / (|ns.wi| |ng.ns|)``. Light samples
take the environment with ``env_probability`` (directions uniform over the
equirectangular square: pdf ``1 / (2 pi^2 sin theta)``), else an emitting
triangle in proportion to its power (mean emission x area) and a point
uniform on it.

What the program drew from its random numbers is taken from its rays: each
bounce's direction (the next wave's ray of the lane), each light sample (the
shadow ray's direction and length, and whether one was sent at all) and
whether Russian roulette kept the lane (whether the next wave's ray is
live). Everything these decisions are weighted by is worked out here from
the raw scene: the hit, its normals and material, the BSDF's value and pdf,
the light's radiance, normal and pdf, the MIS weights, the roulette's
division and whether the shadow ray reaches its light. ``dtype`` is the
precision of that arithmetic (the control runs it in bfloat16).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench.reference import geometry

PDF_MIN = 1e-12  # a pdf at or below this ends a path, as the estimator states
ENV_EXIT = 5e-4  # an environment light sample's shadow ray runs past the scene's box
# why a lane's path is not followed
OTHER_SURFACE, WENT_ON, STOPPED = 1, 2, 3


class Lights(NamedTuple):
    tri: torch.Tensor  # f32 [E, 3, 3] emitting triangles
    normal: torch.Tensor  # f32 [E, 3] unit, from the winding
    radiance: torch.Tensor  # f32 [E, 3]
    pdf_area: torch.Tensor  # f32 [E] area-measure pdf, the light branch included
    pdf_tri: torch.Tensor  # f32 [T] the same for every triangle (0 for non-emitters)
    env: torch.Tensor  # f32 [3] the constant environment
    p_env: float


def lights(world: geometry.World, env, p_env: float) -> Lights:
    em = world.emissive[world.instance]
    tri = world.tri[em]
    c = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * c.norm(dim=-1)
    le = world.emission[world.instance[em]]
    power = le.mean(dim=-1) * area
    pdf_area = power / power.sum() / area * (1.0 - p_env)
    pdf_tri = torch.zeros(world.tri.shape[0], device=tri.device)
    pdf_tri[em] = pdf_area
    return Lights(tri=tri, normal=c / c.norm(dim=-1, keepdim=True), radiance=le,
                  pdf_area=pdf_area, pdf_tri=pdf_tri,
                  env=torch.as_tensor(env, dtype=torch.float32, device=tri.device),
                  p_env=float(p_env))


def _dot(a, b):
    return (a * b).sum(-1)


def _div(a, b, eps=1e-20):
    ok = b.abs() > eps
    return torch.where(ok, a / torch.where(ok, b, torch.ones_like(b)), torch.zeros_like(a))


def power_heuristic(a, b):
    return _div(a * a, a * a + b * b)


def env_pdf(lt: Lights, d):
    sin_t = torch.sqrt(torch.clamp(1.0 - d[:, 1] * d[:, 1], min=1e-12))
    return lt.p_env / (2.0 * math.pi ** 2 * sin_t)


def bsdf(base, metallic, roughness, ns, ng, wo, wi):
    """(f x |cos| x terminator, pdf) of the mixture for world directions
    ``wo`` (toward the viewer) and ``wi``."""
    co, ci = _dot(wo, ns), _dot(wi, ns)
    refl = (ci > 0) & (co > 0)
    h = wi + wo
    h = h / h.norm(dim=-1, keepdim=True)
    h = h * torch.sign(_dot(h, ns))[:, None]
    hn, hwi, hwo = _dot(h, ns), _dot(h, wi), _dot(h, wo)
    r = roughness
    # Burley diffuse
    fd90 = 0.5 + 2.0 * r * hwi * hwi
    fd = ((1.0 + (fd90 - 1.0) * (1.0 - ci.abs()) ** 5)
          * (1.0 + (fd90 - 1.0) * (1.0 - co.abs()) ** 5))
    f_d = base * (fd / math.pi)[:, None]
    pdf_d = torch.clamp(ci, min=0.0) / math.pi
    # GGX metal
    a = torch.clamp(r * r, min=1e-4)
    a2 = a * a
    dd = (1.0 - hn * hn) / a2 + hn * hn
    D = 1.0 / torch.clamp(math.pi * a2 * dd * dd, min=1e-20)

    def g1(c):
        return 1.0 / (1.0 + 0.5 * (torch.sqrt(1.0 + a2 * (1.0 - c * c)
                                              / torch.clamp(c * c, min=1e-12)) - 1.0))

    fres = base + (1.0 - base) * ((1.0 - torch.clamp(hwi, 0.0, 1.0)) ** 5)[:, None]
    f_m = fres * _div(D * g1(ci) * g1(co), 4.0 * ci.abs() * co.abs())[:, None]
    vndf = _div(g1(co) * D * torch.clamp(hwo, min=0.0), co.abs())
    pdf_m = _div(vndf, 4.0 * hwo.abs())
    wd, wm = 1.0 - metallic, metallic
    total = torch.clamp(wd + wm, min=1e-12)
    f = torch.where(refl[:, None], wd[:, None] * f_d + wm[:, None] * f_m, 0.0)
    pdf = torch.where(refl, wd / total * pdf_d + wm / total * pdf_m, 0.0)
    g = torch.clamp(_div(_dot(ng, wi).abs(), ci.abs() * _dot(ng, ns).abs()), 0.0, 1.0)
    return f * (ci.abs() * g * (1.0 + g - g * g))[:, None], pdf


def nearest_emitter(lt: Lights, p):
    """(index, distance) of the emitting triangle nearest to each point
    [n, 3]."""
    a, b, c = lt.tri[:, 0][None], lt.tri[:, 1][None], lt.tri[:, 2][None]
    q = p[:, None]
    n = lt.normal[None]
    plane = _dot(q - a, n)
    f = q - plane[..., None] * n

    def inside(u, v):
        return _dot(torch.linalg.cross(v - u, f - u), n) >= 0

    def seg(u, v):
        e = v - u
        s = _dot(q - u, e) / _dot(e, e).clamp(min=1e-30)
        return (q - u - s.clamp(0, 1)[..., None] * e).norm(dim=-1)

    within = inside(a, b) & inside(b, c) & inside(c, a)
    edge = torch.minimum(torch.minimum(seg(a, b), seg(b, c)), seg(c, a))
    return torch.where(within, plane.abs(), edge).min(dim=1)[::-1]


def box_exit(o, d, lo, hi):
    inv = 1.0 / torch.where(d == 0, torch.full_like(d, 1e-30), d)
    return torch.maximum((lo - o) * inv, (hi - o) * inv).amin(dim=-1).clamp(min=0.0)


def radiance(world: geometry.World, lt: Lights, waves: list, nee: list, render: dict, lo, hi,
             dtype=torch.float32):
    """Per judged lane -> (radiance [L, 3] f32, why it diverged [L] int:
    0 where the reference follows it, spawn gap). ``waves[b]``: the lanes' bounce-``b`` rays (``o``, ``d``, ``tm``:
    live where > 0) with the reference's hits on them (``ref_k``,
    ``ref_u``, ``ref_v``, ``ref_t``) and ``same_surface`` (the program's
    hit agrees); ``nee[b]``: their bounce-``b`` shadow rays (``o``, ``d``,
    ``tm``: sent where > 0) with the reference's ``ref_blocked``. A lane
    diverges where the program's hit is another surface, where it goes on
    past a bounce whose weights end the path, or where it stops before
    Russian roulette at a diffuse surface that reflects toward the viewer."""
    dev = waves[0]["o"].device
    n = waves[0]["o"].shape[0]
    rr_depth, rr_min = int(render["rr_depth"]), float(render["rr_min_beta"])
    beta = torch.ones((n, 3), dtype=dtype, device=dev)
    rad = torch.zeros((n, 3), dtype=dtype, device=dev)
    prev_pdf = torch.zeros(n, dtype=dtype, device=dev)
    active = waves[0]["tm"] > 0
    why = torch.zeros(n, dtype=torch.int64, device=dev)

    def diverge(mask, code):
        nonlocal why
        why = torch.where(mask & (why == 0), code, why)

    spawn = 0.0
    diag = float((hi - lo).norm())
    env = lt.env.to(dtype)
    for b, w in enumerate(waves):
        live = active & (w["tm"] > 0)
        bad = live & ~w["same_surface"]
        diverge(bad, OTHER_SURFACE)
        live = live & ~bad
        o, d = w["o"], w["d"]
        k = w["ref_k"]
        miss = live & (k < 0)
        w_env = power_heuristic(prev_pdf, env_pdf(lt, d).to(dtype)) if b else torch.ones_like(
            prev_pdf)
        rad = rad + torch.where(miss[:, None], beta * env * w_env[:, None], 0.0)
        hit = live & (k >= 0)
        rows = geometry.first_hit_rows(world, w["ref_t"], k, w["ref_u"], w["ref_v"], d)
        t = torch.where(hit, w["ref_t"], 0.0)
        p = o + d * t[:, None]
        ns, ng = rows["normal"].to(dtype), rows["geom_normal"].to(dtype)
        mesh = rows["mesh"]
        base = world.base_color[mesh].to(dtype)
        metal, rough = world.metallic[mesh].to(dtype), world.roughness[mesh].to(dtype)
        wo = (-d).to(dtype)
        # an emitter met by the BSDF's sample
        emit = hit & rows["emissive"] & rows["front"]
        dist2 = ((p - o) ** 2).sum(-1).to(dtype)
        nee_pdf_w = _div(lt.pdf_tri[torch.clamp(k, min=0)].to(dtype) * dist2,
                         _dot(d, rows["geom_normal"]).abs().to(dtype))
        w_emit = power_heuristic(prev_pdf, nee_pdf_w) if b else torch.ones_like(prev_pdf)
        le = world.emission[mesh].to(dtype)
        rad = rad + torch.where(emit[:, None], beta * le * w_emit[:, None], 0.0)
        # the light sample the program drew at this bounce
        s = nee[b]
        sent = hit & (s["tm"] > 0)
        wi, dist = s["d"], s["tm"]
        to_env = dist > box_exit(s["o"], wi, lo, hi) * (1.0 + ENV_EXIT) + ENV_EXIT
        lp = p + wi * dist[:, None]
        j = nearest_emitter(lt, lp)[0] if lt.tri.shape[0] else torch.zeros_like(k)
        cos_l = torch.clamp(-_dot(wi, lt.normal[j]), min=0.0).to(dtype)
        pdf_w = torch.where(to_env, env_pdf(lt, wi).to(dtype),
                            _div(lt.pdf_area[j].to(dtype) * (dist * dist).to(dtype), cos_l))
        le_l = torch.where(to_env[:, None], env, lt.radiance[j].to(dtype))
        f_s, pdf_s = bsdf(base, metal, rough, ns, ng, wo, wi.to(dtype))
        w_nee = power_heuristic(pdf_w, pdf_s)
        contrib = beta * f_s * le_l * _div(w_nee, pdf_w)[:, None]
        reach = sent & ~s["ref_blocked"]
        rad = rad + torch.where(reach[:, None], contrib, 0.0)
        if b + 1 == len(waves):
            break
        # the BSDF's sample: the lane's next ray
        nxt = waves[b + 1]
        cont = hit & (nxt["tm"] > 0)
        if bool(cont.any()):
            spawn = max(spawn, float((nxt["o"] - p)[cont].norm(dim=-1).max()) / diag)
        f_b, pdf_b = bsdf(base, metal, rough, ns, ng, wo, nxt["d"].to(dtype))
        beta = torch.where(cont[:, None], beta * _div(f_b, pdf_b[:, None]), beta)
        if b >= rr_depth:
            p_c = torch.clamp(beta.amax(dim=-1), rr_min, 1.0)
            beta = torch.where(cont[:, None], beta / p_c[:, None], beta)
        diverge(cont & ((pdf_b <= PDF_MIN) | (beta.amax(dim=-1) <= 0)), WENT_ON)
        reflects = (metal == 0) & (base.amax(dim=-1) > 0) & (_dot(wo, ns) > 0)
        diverge(hit & ~cont & (b < rr_depth) & reflects, STOPPED)
        prev_pdf = pdf_b
        active = cont
    return rad.float(), why, spawn
