"""Renderer debug views (counterpart of stratum_tpu/render/debug.py):
first-hit G-buffer channels, the environment sampler's pdf per camera
direction, per-path-length contribution images (``debug_path_edges``) and
the ReSTIR reservoir-weight view. The CLI takes them as ``--debug=<mode>``.
"""

from __future__ import annotations

import dataclasses

import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.core import rng as srng
from stratum_tpu_torch.render import aov as saov
from stratum_tpu_torch.render import camera as scamera
from stratum_tpu_torch.render import integrator as sintegrator
from stratum_tpu_torch.render import lights as slights

DEBUG_MODES = (
    "albedo",            # first-hit base colour
    "normal",            # shading normal as 0.5 n + 0.5
    "depth",             # hit distance over the frame's largest
    "instance",          # instance id hashed to a colour
    "uv",                # surface uv (fractional part)
    "env_pdf",           # environment sampling pdf per camera direction
    "env_test",          # Le x pdf (the importance map)
    "path_length_N",     # contributions of paths of N edges, e.g. path_length_2
    "reservoir_w",       # ReSTIR DI contribution weight
)


def _hash_colors(idx):
    """Stable pseudo-random colour per id: the pcg hash's low three bytes."""
    h = srng.pcg(idx)
    r = (h & 0xFF).to(torch.float32) / 255.0
    g = ((h >> 8) & 0xFF).to(torch.float32) / 255.0
    b = ((h >> 16) & 0xFF).to(torch.float32) / 255.0
    return torch.stack([r, g, b], dim=-1)


def _center_directions(scene, view, cfg):
    px, py = scamera.pixel_grid(cfg.width, cfg.height, scene.device)
    jitter = torch.full((px.shape[0], 2), 0.5, dtype=torch.float32, device=scene.device)
    return scamera.generate_rays(view, px, py, jitter, cfg.width, cfg.height)[1]


def render_debug(scene, view, cfg, mode: str, seed: int = 0, spp: int = 8):
    """One debug view -> [H, W, 3] float on the scene's device."""
    h, w = cfg.height, cfg.width
    if mode.startswith("path_length_"):
        edges = int(mode.rsplit("_", 1)[1])
        dcfg = dataclasses.replace(cfg, debug_path_edges=edges)
        return sintegrator.render_path_progressive(scene, view, dcfg, spp, seed)
    if mode == "reservoir_w":
        from stratum_tpu_torch.render import restir as srestir

        state = srestir.init_restir(w * h, scene.device)
        for s in range(spp):
            state, _ = srestir.restir_di_jit(scene, view, cfg, state, seed + s)
        wr = smath.safe_div(state.total_weight,
                            state.m * torch.clamp(state.target_pdf, min=1e-20))
        return wr.reshape(h, w, 1).expand(h, w, 3)
    if mode in ("env_pdf", "env_test"):
        direction = _center_directions(scene, view, cfg)
        pdf = slights.environment_pdf_w(scene, direction)
        if mode == "env_pdf":
            img = pdf[..., None].expand(pdf.shape + (3,))
        else:
            img = slights.eval_environment(scene, direction) * pdf[..., None]
        return img.reshape(h, w, 3)
    if mode == "uv":
        px, py = scamera.pixel_grid(w, h, scene.device)
        hit, sp, _, _ = saov._first_hits(scene, view, cfg, px, py)
        uvc = torch.cat([sp.uv % 1.0, torch.zeros_like(sp.uv[..., :1])], dim=-1)
        return torch.where(hit.hit[..., None], uvc, 0.0).reshape(h, w, 3)
    if mode not in ("albedo", "normal", "depth", "instance"):
        raise ValueError(f"unknown debug mode {mode!r}; known: {DEBUG_MODES}")
    gbuf = saov.render_gbuffer(scene, view, view, cfg)
    if mode == "albedo":
        return gbuf.albedo
    if mode == "normal":
        return gbuf.normal * 0.5 + 0.5
    if mode == "depth":
        d = torch.where(torch.isfinite(gbuf.depth), gbuf.depth, 0.0)
        dmax = torch.clamp(torch.amax(d), min=1e-6)
        return (d / dmax)[..., None].expand(d.shape + (3,))
    return _hash_colors(torch.clamp(gbuf.instance, min=0)) * (
        gbuf.instance >= 0)[..., None].to(torch.float32)
