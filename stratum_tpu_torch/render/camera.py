"""Camera views and primary-ray generation (counterpart of
stratum_tpu/render/camera.py:21-134): views, pixel grids, primary rays
and the sensor projection of light tracing."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.core import transform as xform


class ViewData(NamedTuple):
    camera_to_world: torch.Tensor  # f32 [3, 4]
    projection: xform.ProjectionData
    world_to_camera: torch.Tensor  # f32 [3, 4]


def make_view(camera_to_world, fovy: float, width: int, height: int,
              znear=0.001, device="cuda") -> ViewData:
    """Camera view on ``device``: the card unless the caller asks for
    the CPU (``device="cpu"``); without a CUDA device the default raises."""
    c2w = torch.tensor(np.asarray(camera_to_world, np.float32), device=device)
    proj = xform.make_perspective(
        fovy, aspect=height / width, znear=znear, device=c2w.device
    )
    return ViewData(camera_to_world=c2w, projection=proj, world_to_camera=xform.inverse(c2w))


def pixel_grid(width: int, height: int, device=None):
    """Integer pixel coords px[H*W], py[H*W] (int32) in row-major order."""
    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.int32, device=device),
        torch.arange(width, dtype=torch.int32, device=device),
        indexing="ij",
    )
    return px.reshape(-1), py.reshape(-1)


def tile_dims(width: int, height: int, th: int = 32, tw: int = 64):
    """Largest tile dims (<= th x tw) that evenly divide the image, or None
    if the image is too small to tile."""
    while th > 1 and height % th:
        th //= 2
    while tw > 1 and width % tw:
        tw //= 2
    if th * tw < 64:
        return None
    return th, tw


def pixel_grid_tiled(width: int, height: int, th: int, tw: int, device=None):
    """Pixel coords in tile-major order (compact th x tw screen tiles)."""
    px, py = pixel_grid(width, height, device)
    shape = (height // th, th, width // tw, tw)
    px = px.reshape(shape).permute(0, 2, 1, 3).reshape(-1)
    py = py.reshape(shape).permute(0, 2, 1, 3).reshape(-1)
    return px, py


def untile_image(flat, width: int, height: int, th: int, tw: int):
    """Inverse of pixel_grid_tiled's ordering: [N, C] -> [H, W, C]."""
    c = flat.shape[-1:]
    img = flat.reshape((height // th, width // tw, th, tw) + tuple(c))
    return img.permute(0, 2, 1, 3, 4).reshape((height, width) + tuple(c))


def generate_rays(view: ViewData, px, py, jitter, width: int, height: int):
    """Primary rays for pixel coords with subpixel jitter [N, 2] in [0,1).
    Returns (origin [N, 3], direction [N, 3])."""
    u = (px.to(torch.float32) + jitter[..., 0]) / width
    v = (py.to(torch.float32) + jitter[..., 1]) / height
    ndc = torch.stack([u * 2.0 - 1.0, -(v * 2.0 - 1.0)], dim=-1)
    d_cam = smath.normalize(xform.back_project(view.projection, ndc))
    origin = view.camera_to_world[..., 3].expand(d_cam.shape)
    direction = xform.transform_vector(view.camera_to_world, d_cam)
    return origin, smath.normalize(direction)


def sensor_importance(view: ViewData, world_pos, width: int, height: int):
    """A world point projected into the view -> (pixel xy f32 [N, 2],
    inside the frustum bool [N], the importance's measure factor
    dist^2 / (A_sensor cos^3) x pixels) (camera.py:106-134)."""
    p_cam = xform.transform_point(view.world_to_camera, world_pos)
    clip = xform.project_point(view.projection, p_cam)
    w = clip[..., 3]
    ndc = clip[..., :2] / torch.clamp(torch.abs(w), min=1e-20)[..., None]
    inside = ((w > 0) & (ndc[..., 0] >= -1.0) & (ndc[..., 0] <= 1.0)
              & (ndc[..., 1] >= -1.0) & (ndc[..., 1] <= 1.0))
    pix_x = (ndc[..., 0] * 0.5 + 0.5) * width
    pix_y = (-ndc[..., 1] * 0.5 + 0.5) * height
    dist2 = smath.length_squared(p_cam)
    cos_theta = torch.abs(p_cam[..., 2]) / torch.clamp(torch.sqrt(dist2), min=1e-20)
    pdf_w = dist2 / torch.clamp(
        view.projection.sensor_area * cos_theta * cos_theta * cos_theta, min=1e-20)
    return torch.stack([pix_x, pix_y], dim=-1), inside, pdf_w * (width * height)
