"""Multi-device rendering: the pixel lanes split over a list of torch
devices (counterpart of stratum_tpu/parallel/mesh.py).

The reference shards pixel tiles over a 1-D ``jax.sharding.Mesh`` with
``shard_map``. Here a :class:`Mesh` is a list of devices; every sharded
function cuts its lanes into one contiguous shard per device, runs the
shards in order, each on its own device against a replica of the scene
(made once per scene and device, and kept by the mesh), and gathers the results on
``devices[0]``. Every ``psum`` of the reference is a sum in shard order,
so runs with the same seed are bit-equal. A device may appear more than
once (one card split into shards, or ``["cpu"] * 8`` as the reference's 8
virtual CPU devices).

Because the RNG is keyed by absolute pixel coordinates, a shard draws
exactly what the unsharded render draws for its lanes. Two things tie a
lane to its neighbours: the coherent light-tile groups
(``coherent_tiles``), keyed by the first lane of each ``coherent_block``
lanes, and ``wave_caps``' compaction over a whole wave. Where shards are
whole coherence granules and no cap binds, a sharded image equals the
unsharded one up to float reassociation; otherwise only in expectation.
:func:`render_path_sharded` therefore rounds its shard boundaries to whole
granules when the render draws light-tile groups (1920 x 1080 pixels are
1,012.5 granules of 2,048: no equal split of them is whole granules).
The path-traced functions shard the lanes in the layout of the unsharded
render (screen tiles on the block tracers, ``integrator._pixels``), the
G-buffer, BDPT, ReSTIR and light tracing in row-major order, as their
unsharded counterparts do.
"""

from __future__ import annotations

import dataclasses

import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.render import camera as scamera
from stratum_tpu_torch.render import integrator as sintegrator
from stratum_tpu_torch.scene.schema import to_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices the lanes are split over, in shard order."""

    devices: tuple
    axis_names: tuple = ("tiles",)
    # device -> (source scene, its copy there): the scene replicated once
    # per device, until another scene is replicated there
    replicas: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None, axis: str = "tiles") -> Mesh:
    """1-D mesh over every CUDA device, or over ``devices`` (names or
    ``torch.device``s; repeats allowed). Raises when no device is given and
    there is no CUDA device."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_mesh(): no CUDA device; pass the devices "
                               "(e.g. ['cpu'] * 8) to split over the CPU")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = tuple(
        torch.device("cuda", torch.cuda.current_device())
        if torch.device(d) == torch.device("cuda") else torch.device(d)
        for d in devices)
    if not devices:
        raise ValueError("make_mesh(): an empty device list")
    return Mesh(devices, (axis,))


def _replica(scene, device, mesh: Mesh):
    """``scene`` on ``device``: itself where it already lives, else the
    mesh's copy there, made once."""
    if scene.device == device:
        return scene
    held = mesh.replicas.get(device)
    if held is None or held[0] is not scene:
        held = (scene, to_device(scene, device))
        mesh.replicas[device] = held
    return held[1]


def _shards(n: int, mesh: Mesh, what: str = "pixels", granule: int = 1):
    """[(device, slice)] of ``n`` lanes in contiguous shards, equal ones, or
    with ``granule`` > 1 (and room for one a shard) the equal boundaries
    rounded to whole granules."""
    k = mesh.size
    if n % k:
        raise ValueError(f"{n} {what} not divisible by {k} devices")
    if granule > 1 and n // k >= granule:
        cuts = [min(n, (i * n // k + granule // 2) // granule * granule) for i in range(k)]
    else:
        cuts = [i * (n // k) for i in range(k)]
    cuts.append(n)
    return [(dev, slice(cuts[i], cuts[i + 1])) for i, dev in enumerate(mesh.devices)]


def _granule(cfg) -> int:
    """Lanes that share a coherent light-tile group (``coherent_block``),
    where the render draws such groups; else 1."""
    if cfg.use_nee and cfg.presample_lights > 0 and cfg.coherent_tiles > 0:
        return cfg.coherent_block
    return 1


def _gather(parts, device):
    return torch.cat([p.to(device) for p in parts])


def _sum(parts, device):
    """The sum of the shards' partial results in shard order (the
    reference's psum)."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def render_path_sharded(scene, view, cfg, seed, mesh: Mesh):
    """Path-trace one sample per pixel with the pixel lanes sharded over
    ``mesh`` -> [H, W, 3] on ``mesh.devices[0]``. Requires width * height
    divisible by the mesh size."""
    return render_path_sharded_with_counts(scene, view, cfg, seed, mesh)[0]


def render_path_sharded_with_counts(scene, view, cfg, seed, mesh: Mesh):
    """:func:`render_path_sharded` -> (image, traced rays summed in shard
    order). Where the render draws coherent light-tile groups, the shard
    boundaries are rounded to whole ``coherent_block`` granules, so every
    granule keeps the unsharded render's lanes and group."""
    px, py, dims = sintegrator._pixels(scene, cfg)
    out, rays = [], []
    for dev, sl in _shards(cfg.width * cfg.height, mesh, granule=_granule(cfg)):
        rad, n_rays = sintegrator.trace_path(_replica(scene, dev, mesh), to_device(view, dev), cfg,
                                             seed, px[sl].to(dev), py[sl].to(dev))
        out.append(rad)
        rays.append(n_rays)
    dev0 = mesh.devices[0]
    return sintegrator._image(_gather(out, dev0), cfg, dims), _sum(rays, dev0)


def render_path_lanes_sharded(scene, view, cfg, spp, seed0, mesh: Mesh):
    """Lane-batched sampling (``integrator.render_path_lanes``) sharded
    over ``mesh``: each device traces its pixels' ``spp`` samples as extra
    wavefront lanes -> (mean image [H, W, 3], total rays, summed in shard
    order)."""
    px, py, dims = sintegrator._pixels(scene, cfg)
    means, rays = [], []
    for dev, sl in _shards(cfg.width * cfg.height, mesh):
        local = sl.stop - sl.start
        seeds = torch.repeat_interleave(
            seed0 + torch.arange(spp, dtype=torch.int64, device=dev), local)
        rad, n_rays = sintegrator.trace_path(
            _replica(scene, dev, mesh), to_device(view, dev), cfg, seeds,
            px[sl].to(dev).repeat(spp), py[sl].to(dev).repeat(spp))
        means.append(rad.view(spp, local, 3).mean(dim=0))
        rays.append(n_rays)
    dev0 = mesh.devices[0]
    return sintegrator._image(_gather(means, dev0), cfg, dims), _sum(rays, dev0)


def render_lt_sharded(scene, view, cfg, seed, mesh: Mesh):
    """Light tracing with the light paths sharded over ``mesh``: each
    device traces its slice of the path budget (``lane0`` keeps every
    path's RNG stream the unsharded one) into a partial splat image; the
    images are summed in shard order -> [H, W, 3]."""
    from stratum_tpu_torch.render import lighttrace as slt

    num_paths = cfg.width * cfg.height
    parts = []
    for dev, sl in _shards(num_paths, mesh, "paths"):
        parts.append(slt.trace_light(_replica(scene, dev, mesh), to_device(view, dev), cfg, seed,
                                     num_paths=sl.stop - sl.start, lane0=sl.start,
                                     total_paths=num_paths))
    dev0 = mesh.devices[0]
    emission = slt.trace_emission_only(scene, view, cfg, seed).to(dev0)
    return _sum(parts, dev0) + emission


def render_bdpt_sharded(scene, view, cfg, seed, mesh: Mesh):
    """BDPT with the camera pixels and the light paths sharded over
    ``mesh``: the t >= 2 strategies stay with the pixel's shard, the t = 1
    splat images are summed in shard order -> [H, W, 3]."""
    from stratum_tpu_torch.render import bdpt as sbdpt

    num_pix = cfg.width * cfg.height
    dev0 = mesh.devices[0]
    px, py = scamera.pixel_grid(cfg.width, cfg.height, scene.device)
    rads, splats = [], []
    for dev, sl in _shards(num_pix, mesh):
        rad, splat = sbdpt.trace_bdpt(_replica(scene, dev, mesh), to_device(view, dev), cfg, seed,
                                      px[sl].to(dev), py[sl].to(dev), lane0=sl.start,
                                      num_light_paths=num_pix)
        rads.append(rad)
        splats.append(splat)
    return (_gather(rads, dev0) + _sum(splats, dev0)).reshape(cfg.height, cfg.width, 3)


def render_path_progressive_sharded(scene, view, cfg, spp: int, mesh: Mesh, seed0=0):
    """The mean of ``spp`` sharded samples at seeds seed0, seed0 + 1, ..."""
    acc = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                      device=mesh.devices[0])
    for s in range(spp):
        acc = acc + render_path_sharded(scene, view, cfg, seed0 + s, mesh)
    return acc / spp


def render_gbuffer_sharded(scene, view, prev_view, cfg, mesh: Mesh):
    """First-hit G-buffer with the pixel rows sharded over ``mesh`` ->
    image-shaped buffers on ``mesh.devices[0]``."""
    from stratum_tpu_torch.render import aov as saov

    px, py = scamera.pixel_grid(cfg.width, cfg.height, scene.device)
    parts = []
    for dev, sl in _shards(cfg.width * cfg.height, mesh):
        parts.append(saov.gbuffer_flat(_replica(scene, dev, mesh), to_device(view, dev),
                                       to_device(prev_view, dev), cfg, px[sl].to(dev),
                                       py[sl].to(dev)))
    dev0 = mesh.devices[0]
    h, w = cfg.height, cfg.width
    flat = saov.GBuffer(*(_gather(field, dev0) for field in zip(*parts)))
    return saov.GBuffer(
        albedo=flat.albedo.reshape(h, w, 3),
        normal=flat.normal.reshape(h, w, 3),
        depth=flat.depth.reshape(h, w),
        instance=flat.instance.reshape(h, w),
        prev_uv=flat.prev_uv.reshape(h, w, 2),
    )


def _denoise_halo(dcfg) -> int:
    """Rows beyond its own that a pixel's denoised output reads: the 5x5
    variance fallback (2), the depth gradient (1), and per a-trous
    iteration its 3x3 variance prefilter or its taps at 2^i, the larger."""
    from stratum_tpu_torch.render import denoise as sdenoise

    reach = 3
    for it in range(dcfg.atrous_iterations):
        taps = sdenoise._filter_taps(dcfg.filter_type, it)
        reach += max(1, max(abs(dy) for dy, _, _ in taps) << it)
    return reach


def denoise_sharded(state, radiance, gbuf, dcfg, mesh: Mesh):
    """SVGF with the image rows split over ``mesh``: each device denoises
    its band of rows from the band widened by the filters' reach
    (:func:`_denoise_halo`) and the whole previous state (the temporal
    stage reprojects into any row), and keeps its band; the reference's
    row-sharded jit with halo exchanges. Every output pixel is the
    unsharded pass's bit for bit -> (new state, image) on
    ``mesh.devices[0]``."""
    from stratum_tpu_torch.render import aov as saov
    from stratum_tpu_torch.render import denoise as sdenoise

    h = radiance.shape[0]
    k = mesh.size
    halo = _denoise_halo(dcfg)
    dev0 = mesh.devices[0]
    states, images = [], []
    for i, dev in enumerate(mesh.devices):
        r0, r1 = h * i // k, h * (i + 1) // k
        s0, s1 = max(0, r0 - halo), min(h, r1 + halo)
        band = saov.GBuffer(*(x[s0:s1].to(dev) for x in gbuf))
        st, img = sdenoise.denoise(to_device(state, dev), radiance[s0:s1].to(dev), band, dcfg)
        keep = slice(r0 - s0, r1 - s0)
        states.append([x[keep] for x in st])
        images.append(img[keep])
    new_state = sdenoise.DenoiseState(*(_gather(f, dev0) for f in zip(*states)))
    return new_state, _gather(images, dev0)


def restir_di_sharded(scene, view, cfg, state, seed, mesh: Mesh, candidates: int = 4,
                      history_limit: float = 20.0, prev_view=None, spatial_taps: int = 0,
                      hash_jitter: bool = False):
    """ReSTIR DI (``render/restir.py``) with the per-pixel reservoir rows
    sharded over ``mesh``. Temporal reprojection may land in any shard, so
    every shard reads the whole packed reservoir table (the reference's
    all-gather). With ``spatial_taps`` > 0 the hash grid is built per
    shard, so neighbour candidates stay shard-local: a valid estimator,
    not bit-identical to the unsharded one; without taps it is. ->
    (new state, direct radiance [H, W, 3]) on ``mesh.devices[0]``."""
    from stratum_tpu_torch.render import restir as srestir

    px, py = scamera.pixel_grid(cfg.width, cfg.height, scene.device)
    hist = srestir._pack_state(state) if prev_view is not None else None
    states, directs = [], []
    for dev, sl in _shards(cfg.width * cfg.height, mesh):
        tile = type(state)(*(x[sl].to(dev) for x in state))
        new_tile, direct = srestir._restir_flat(
            _replica(scene, dev, mesh), to_device(view, dev), cfg, tile,
            None if hist is None else hist.to(dev), px[sl].to(dev), py[sl].to(dev), seed,
            candidates, history_limit, to_device(prev_view, dev), spatial_taps, hash_jitter)
        states.append(new_tile)
        directs.append(direct)
    dev0 = mesh.devices[0]
    new_state = type(state)(*(_gather(f, dev0) for f in zip(*states)))
    return new_state, _gather(directs, dev0).reshape(cfg.height, cfg.width, 3)


def adaptive_round_sharded(scene, view, cfg, accum, accum_sq, count, L, seed, mesh: Mesh):
    """One adaptive round (``render/adaptive._adaptive_round``) with the
    top-L trace sharded over ``mesh``. The per-pixel state stays whole on
    ``mesh.devices[0]``: the score and the top-L list are computed once
    there, each device traces its L / n slice of the list, the [L, 3]
    radiance is gathered back in shard order and added as the unsharded
    round adds it, so the state is that round's bit for bit."""
    from stratum_tpu_torch.render import adaptive as sadaptive

    dev0 = mesh.devices[0]
    accum, accum_sq, count = accum.to(dev0), accum_sq.to(dev0), count.to(dev0)
    idx, px, py = sadaptive._topk_pixels(cfg, accum, accum_sq, count, L)
    parts = []
    for dev, sl in _shards(L, mesh, "pixels of the round (L)"):
        rad, _ = sintegrator.trace_path(_replica(scene, dev, mesh), to_device(view, dev), cfg,
                                        seed, px[sl].to(dev), py[sl].to(dev))
        parts.append(rad)
    rad = _gather(parts, dev0)
    return (accum.index_add(0, idx, rad),
            accum_sq.index_add(0, idx, smath.luminance(rad) ** 2),
            count.index_add(0, idx, torch.ones_like(count[:L])))


def render_adaptive_sharded(scene, view, cfg, total_rays_budget_spp: float, mesh: Mesh,
                            pilot: int = 2, frac: float = 0.25, seed0: int = 0):
    """``render/adaptive.render_adaptive`` with every traced wave sharded
    over ``mesh``: the uniform pilot rounds through
    :func:`render_path_sharded`, the adaptive rounds through
    :func:`adaptive_round_sharded`, L rounded up to a multiple of the mesh
    size -> (image [H, W, 3], AdaptiveState), the unsharded render's bit
    for bit where the rounding leaves L unchanged."""
    from stratum_tpu_torch.render import adaptive as sadaptive

    n = cfg.width * cfg.height
    k = mesh.size
    st = sadaptive.init_state(n, mesh.devices[0])
    accum, accum_sq, count = st.accum, st.accum_sq, st.count
    spent = 0.0
    seed = seed0
    for _ in range(min(pilot, int(total_rays_budget_spp))):
        rad = render_path_sharded(scene, view, cfg, seed, mesh).reshape(n, 3)
        accum = accum + rad
        accum_sq = accum_sq + smath.luminance(rad) ** 2
        count = count + 1.0
        spent += 1.0
        seed += 1
    L = max(int(round(n * frac)), 1)
    L = max(-(-L // k) * k, k)  # a multiple of the mesh size
    while spent + L / n <= total_rays_budget_spp + 1e-6:
        accum, accum_sq, count = adaptive_round_sharded(scene, view, cfg, accum, accum_sq,
                                                        count, L, seed, mesh)
        spent += L / n
        seed += 1
    img = accum / torch.clamp(count, min=1.0)[:, None]
    return img.reshape(cfg.height, cfg.width, 3), sadaptive.AdaptiveState(accum, accum_sq,
                                                                          count)


def session_frame_sharded(scene, view, prev_view, cfg, dcfg, dstate, seed, mesh: Mesh):
    """One interactive frame, render + G-buffer + SVGF, every stage
    sharded over ``mesh`` -> (new denoise state, image)."""
    rad = render_path_sharded(scene, view, cfg, seed, mesh)
    gbuf = render_gbuffer_sharded(scene, view, prev_view, cfg, mesh)
    return denoise_sharded(dstate, rad, gbuf, dcfg, mesh)
