"""Final-frame samples, back to back in a closed loop: one user renders a
progressive image and adds each call's samples to it.

``entry`` is ``render_path_with_counts`` (1 sample per pixel a call) or
``render_path_lanes`` (``lanes`` samples per pixel a call, as one
wavefront of lanes x pixels). Each call's seed follows from the run's
seed; the window ends in one synchronise, taken by the harness.
"""

from __future__ import annotations


def units(params: dict) -> int:
    return int(params.get("lanes", 1)) if params["entry"] == "render_path_lanes" else 1


def setup(ctx, params: dict) -> dict:
    import torch

    cfg = ctx.cfg
    accum = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=ctx.device)
    return dict(accum=accum, params=params, units=units(params))


def _render(ctx, st, seed: int):
    from stratum_tpu_torch.render import integrator

    p = st["params"]
    if p["entry"] == "render_path_lanes":
        lanes = int(p["lanes"])
        return integrator.render_path_lanes(ctx.scene, ctx.view, ctx.cfg, lanes, seed * lanes)
    if p["entry"] == "render_path_with_counts":
        return integrator.render_path_with_counts(ctx.scene, ctx.view, ctx.cfg, seed)
    raise ValueError(f"unknown entry {p['entry']!r}")


def warm(ctx, st):
    for i in range(int(st["params"].get("warm_calls", 2))):
        _render(ctx, st, ctx.seed_base + (1 << 25) + i)


def call(ctx, st, i: int):
    ctx.tracer.mark("sample", "begin")
    img, n_rays = _render(ctx, st, ctx.seed_base + i)
    st["accum"] += img * st["units"]
    ctx.tracer.mark("sample", "end")
    ctx.output(i, image=img, n_rays=n_rays)
