"""The G-buffer pass: first-hit geometry and demodulation data (counterpart
of stratum_tpu/render/aov.py): albedo, shading normal, hit distance,
instance id and each pixel's position in the previous view, reprojected
through the camera move and through the instance's motion transform
(``SceneData.instance_motion``, from ``flatten(time=, prev_time=)``).

Hits resolve as the integrator's do (``integrator._hit_rows``): the block
tracer's hits carry the fused slot payload, the other tracers' hits (and
every hit in a scene with analytic spheres) carry triangle ids and read one
``tri_payload`` row. On ``"pallas"`` the wave is one K1 launch of
unsorted, unjittered primary rays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.render import camera as scamera
from stratum_tpu_torch.render.integrator import RenderConfig, _hit_rows, _trace_fns
from stratum_tpu_torch.render.shading import (
    apply_textures,
    material_from_row,
    shading_point_from_row,
)
from stratum_tpu_torch.utils import profiler as sprof


class GBuffer(NamedTuple):
    """Per-pixel first-hit data, image-shaped [H, W, ...] (flat [N, ...]
    from :func:`gbuffer_flat`)."""

    albedo: torch.Tensor  # f32 [H, W, 3] base colour at the hit (1 on a miss)
    normal: torch.Tensor  # f32 [H, W, 3] shading normal (0 on a miss)
    depth: torch.Tensor  # f32 [H, W] hit distance (inf on a miss)
    instance: torch.Tensor  # i32 [H, W] instance id (-1 on a miss)
    prev_uv: torch.Tensor  # f32 [H, W, 2] uv in the previous view (-1 off it)


def render_gbuffer(scene, view, prev_view, cfg: RenderConfig) -> GBuffer:
    """Trace the pixel centres once (no jitter, so the buffers are stable
    from frame to frame) -> the G-buffer on the scene's device."""
    span = sprof.enter("gbuffer")
    px, py = scamera.pixel_grid(cfg.width, cfg.height, scene.device)
    flat = gbuffer_flat(scene, view, prev_view, cfg, px, py)
    h, w = cfg.height, cfg.width
    gbuf = GBuffer(
        albedo=flat.albedo.reshape(h, w, 3),
        normal=flat.normal.reshape(h, w, 3),
        depth=flat.depth.reshape(h, w),
        instance=flat.instance.reshape(h, w),
        prev_uv=flat.prev_uv.reshape(h, w, 2),
    )
    sprof.end(span)
    return gbuf


def _first_hits(scene, view, cfg: RenderConfig, px, py):
    """Pixel-centre rays of (px, py) through the unsorted closest tracer ->
    (hit, shading point with uv and material, material row, direction)."""
    jitter = torch.full((px.shape[0], 2), 0.5, dtype=torch.float32, device=scene.device)
    origin, direction = scamera.generate_rays(view, px, py, jitter, cfg.width, cfg.height)
    _, trace_closest, _, _ = _trace_fns(scene, cfg)
    hit = trace_closest(origin, direction)
    srow, mrow, _ = _hit_rows(scene, hit)
    sp = shading_point_from_row(srow, hit.tri, hit.bary, direction, textured=True,
                                spheres=scene.spheres.num_spheres > 0)
    instance = torch.where(hit.tri >= 0, srow[..., 26].to(torch.int32), -1)
    return hit, sp, mrow, instance


def gbuffer_flat(scene, view, prev_view, cfg: RenderConfig, px, py) -> GBuffer:
    """G-buffer rows [N, ...] of arbitrary pixel coords."""
    hit, sp, mrow, instance = _first_hits(scene, view, cfg, px, py)
    mat = material_from_row(mrow)
    if scene.textures.resolution > 1:
        mat = apply_textures(mat, scene.materials, scene.textures, sp.material, sp.uv,
                             mat_row=mrow)
    miss = ~hit.hit
    # emissive surfaces demodulate by 1: their radiance is emission, not
    # reflected light
    emissive = smath.luminance(mat.emission) > 0.0
    albedo = torch.where((miss | emissive)[..., None], 1.0, mat.base_color)
    normal = torch.where(miss[..., None], 0.0, sp.shading_normal)
    depth = torch.where(miss, torch.inf, hit.t)
    instance = torch.where(miss, -1, instance)
    # object motion: the hit's previous world position through its
    # instance's motion transform (identity rows for a static scene)
    mot = scene.instance_motion[torch.clamp(instance, min=0).long()]  # [N, 3, 4]
    prev_pos = torch.einsum("nij,nj->ni", mot[:, :, :3], sp.position) + mot[:, :, 3]
    pix, inside, _ = scamera.sensor_importance(prev_view, prev_pos, cfg.width, cfg.height)
    wh = torch.tensor([cfg.width, cfg.height], dtype=torch.float32, device=pix.device)
    prev_uv = torch.where((miss | ~inside)[..., None], -1.0, pix / wh)
    return GBuffer(albedo=albedo, normal=normal, depth=depth, instance=instance,
                   prev_uv=prev_uv)


class PickResult(NamedTuple):
    """First-hit data of queried pixels (:func:`pick`)."""

    instance: torch.Tensor  # i32 [Q] (-1 = miss)
    prim: torch.Tensor  # i32 [Q] triangle id, or T + sphere id (-1 = miss)
    material: torch.Tensor  # i32 [Q] material row (-1 = miss)
    depth: torch.Tensor  # f32 [Q] hit distance (inf = miss)
    position: torch.Tensor  # f32 [Q, 3] world hit position (0 = miss)
    uv: torch.Tensor  # f32 [Q, 2] surface uv
    normal: torch.Tensor  # f32 [Q, 3] shading normal


def pick(scene, view, cfg: RenderConfig, px, py) -> PickResult:
    """Pixels (px, py) (ints or integer sequences) -> what their centre
    rays hit: Q rays through the configured tracer."""
    dev = scene.device
    px = torch.atleast_1d(torch.as_tensor(px, dtype=torch.int32, device=dev))
    py = torch.atleast_1d(torch.as_tensor(py, dtype=torch.int32, device=dev))
    hit, sp, _, instance = _first_hits(scene, view, cfg, px, py)
    miss = ~hit.hit
    return PickResult(
        instance=torch.where(miss, -1, instance),
        prim=torch.where(miss, -1, hit.tri),
        material=torch.where(miss, -1, sp.material),
        depth=torch.where(miss, torch.inf, hit.t),
        position=torch.where(miss[..., None], 0.0, sp.position),
        uv=torch.where(miss[..., None], 0.0, sp.uv),
        normal=torch.where(miss[..., None], 0.0, sp.shading_normal),
    )
