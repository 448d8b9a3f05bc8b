"""The wavefront entry points and schedules of the port (ROADMAP Queue 1
item 3 and ``wave_caps``): per-lane seeds, ``render_path_batched``,
``render_path_lanes``, ``slim_carry`` and the ``wave_caps`` stream
compaction, against the JAX reference and against the port's own
sequential renders.

Scene: the tiny atrium (``atrium(columns=1, stacks=6, slices=12)``), bridged
so both packages render the same arrays, at 32x32 on the block kernel
(``tracer="pallas"``; the reference's ``"packet"``, which sorts and defers
the same way), with the bench configuration cut to 3 bounces. At 1,024
lanes the caps ``(1, 1, 0.6, 0.082, 0.031)`` compact twice: to 768 lanes
after bounce 1 and to 256 after bounce 2 (budgets round up to 256 lanes).

Bounds: against the reference those of test_torch_slice.py (image mean
within 2 % relative, >= 97 % of pixels within 1e-3, n_rays within 1 %);
the port's own equalities at rtol 1e-5 / atol 1e-7 (the same samples
summed in another order), bit for bit where nothing is summed apart;
hash and compaction words bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.core import rng as jrng
from stratum_tpu.render import camera as jcamera
from stratum_tpu.render import integrator as jintegrator
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu_torch.render import camera, integrator
from stratum_tpu_torch.scene import bridge

torch.set_num_threads(2)

MEAN_REL = 0.02
PIXEL_SHARE = 0.97
RAYS_REL = 0.01
W = H = 32
BENCH = dict(width=W, height=H, max_bounces=3, bsdf="disney", presample_lights=4096,
             coherent_tiles=16)
CAPS = (1, 1, 0.6, 0.082, 0.031)  # the schedule the reference measured on its TPU


def _agree(img, ref, n, n_ref):
    img, ref = np.asarray(img), np.asarray(ref)
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert abs(img.mean() - ref.mean()) <= MEAN_REL * ref.mean(), (img.mean(), ref.mean())
    pix = np.all(np.abs(img - ref) <= 1e-3 * (1 + np.abs(ref)), axis=-1).mean()
    assert pix >= PIXEL_SHARE, pix
    assert abs(int(n) - int(n_ref)) <= RAYS_REL * int(n_ref), (int(n), int(n_ref))


@pytest.fixture(scope="module")
def case():
    g = jbuiltin.atrium(columns=1, stacks=6, slices=12)
    js, _ = jflatten.flatten(g.root)
    node, cam = jflatten.find_camera(g.root)
    c2w = np.asarray(node.to_world())
    return dict(
        js=js, jview=jcamera.make_view(c2w, cam.fovy, W, H),
        ps=bridge.scene_from_numpy(bridge.numpy_fields(js), "cpu"),
        pview=camera.make_view(c2w, cam.fovy, W, H, device="cpu"),
    )


def _jcfg(**kw):
    return jintegrator.RenderConfig(tracer="packet", **{**BENCH, **kw})


def _pcfg(**kw):
    return integrator.RenderConfig(tracer="pallas", **{**BENCH, **kw})


@pytest.mark.parametrize("b, seed", [(1, 0), (2, 7), (3, 123456)])
def test_compaction_pick_matches_reference(b, seed):
    """The lanes kept and dropped after bounce ``b`` for a given alive mask
    and seed: the reference's key (integrator.py:1423-1438) and stable
    argsort against :func:`integrator.compaction_order`, equal."""
    rng = np.random.default_rng(b)
    n = 3000
    pid = rng.permutation(5000)[:n].astype(np.int32)
    alive = rng.random(n) < 0.4
    bits = jrng.pcg4d(jnp.stack([
        jnp.asarray(pid, jnp.uint32), jnp.full((n,), np.uint32(b + 1), jnp.uint32),
        jnp.full((n,), np.uint32(seed), jnp.uint32), jnp.full((n,), np.uint32(0x5E1EC7)),
    ], axis=-1))[..., 0]
    ref = np.asarray(jnp.argsort(jnp.where(jnp.asarray(alive), jrng._bits_to_float(bits), 2.0)))
    got = integrator.compaction_order(torch.from_numpy(pid), b, seed, torch.from_numpy(alive))
    np.testing.assert_array_equal(got.numpy(), ref)
    keep = {2: 2048, 3: 256, 4: 256}[b + 1]  # 3,000 x cap, rounded up to 256
    assert integrator._budget(integrator.RenderConfig(wave_caps=CAPS), b + 1, n) == keep
    assert set(got[:keep].tolist()) == set(ref[:keep].tolist())


def test_granule_base_with_lane_seeds_matches_reference():
    """Per-lane seeds key each coherence granule by its first lane's seed,
    ``depth + seed * 131`` wrapped to uint32 (the reference's
    integrator.py:1036-1073, recomputed here with its rng)."""
    cfg = integrator.RenderConfig(presample_lights=4096, coherent_tiles=16, coherent_block=64)
    rng = np.random.default_rng(5)
    n = 1000
    px = rng.integers(0, 1920, n).astype(np.int32)
    py = rng.integers(0, 1080, n).astype(np.int32)
    seeds = np.repeat(np.asarray([3, 40_000_000, 2**31 + 5], np.int64), [400, 400, 200])
    depth = 2
    first = np.arange(0, n, 64)
    word = ((depth + seeds[first] * 131) & 0xFFFFFFFF).astype(np.uint32)
    bits = jrng.pcg4d(jnp.stack([
        jnp.asarray(px[first], jnp.uint32), jnp.asarray(py[first], jnp.uint32),
        jnp.asarray(word), jnp.full(first.shape, np.uint32(0x1D1E5)),
    ], axis=-1))[..., 0]
    groups = 4096 // 16
    base = np.minimum((np.asarray(jrng._bits_to_float(bits)) * groups).astype(np.int64), groups - 1)
    ref = np.repeat(base * 16, 64)[:n]
    got = integrator._granule_base(cfg, torch.from_numpy(px), torch.from_numpy(py),
                                   torch.from_numpy(seeds), depth)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_batched_matches_reference(case):
    jimg, jn = jintegrator.render_path_batched(case["js"], case["jview"], _jcfg(), 2, 1)
    pimg, pn = integrator.render_path_batched(case["ps"], case["pview"], _pcfg(), 2, 1)
    _agree(pimg.numpy(), jimg, pn, jn)


def test_lanes_match_reference(case):
    """Two samples as one 2,048-lane wave, per-lane seeds (the light tile
    from the first lane's seed, granules straddling the samples)."""
    jimg, jn = jintegrator.render_path_lanes(case["js"], case["jview"], _jcfg(), 2, 3)
    pimg, pn = integrator.render_path_lanes(case["ps"], case["pview"], _pcfg(), 2, 3)
    _agree(pimg.numpy(), jimg, pn, jn)


def test_binding_wave_caps_match_reference(case):
    jimg, jn = jintegrator.render_path_with_counts(case["js"], case["jview"],
                                                   _jcfg(wave_caps=CAPS), 2)
    pimg, pn = integrator.render_path_with_counts(case["ps"], case["pview"],
                                                  _pcfg(wave_caps=CAPS), 2)
    _agree(pimg.numpy(), jimg, pn, jn)


def test_batched_equals_progressive_and_counts_sum(case):
    cfg = _pcfg(max_bounces=2)
    img, rays = integrator.render_path_batched(case["ps"], case["pview"], cfg, 3, 5)
    ref = integrator.render_path_progressive(case["ps"], case["pview"], cfg, 3, 5)
    torch.testing.assert_close(img, ref, rtol=1e-5, atol=1e-7)
    counts = [int(integrator.render_path_with_counts(case["ps"], case["pview"], cfg, s)[1])
              for s in (5, 6, 7)]
    assert rays.dtype == torch.int64 and int(rays) == sum(counts)


def test_lanes_without_presample_equal_sequential(case):
    """Without the per-frame light tile, lane (s, p) is the single-sample
    estimator of pixel p at seed seed0 + s: the lanes' mean is the
    sequential mean, and the ray count their sum."""
    cfg = _pcfg(presample_lights=0, coherent_tiles=0, max_bounces=2)
    img, rays = integrator.render_path_lanes(case["ps"], case["pview"], cfg, 2, 4)
    ref = integrator.render_path_progressive(case["ps"], case["pview"], cfg, 2, 4)
    torch.testing.assert_close(img, ref, rtol=1e-5, atol=1e-7)
    counts = [int(integrator.render_path_with_counts(case["ps"], case["pview"], cfg, s)[1])
              for s in (4, 5)]
    assert int(rays) == sum(counts)


def test_non_binding_caps_equal_no_caps(case):
    """Caps of 1.0 never compact: the render is the uncapped one (up to the
    deferred wave's sum, taken part by part), its ray count equal."""
    img, n = integrator.render_path_with_counts(case["ps"], case["pview"],
                                                _pcfg(wave_caps=(1.0,)), 1)
    ref, n_ref = integrator.render_path_with_counts(case["ps"], case["pview"], _pcfg(), 1)
    torch.testing.assert_close(img, ref, rtol=1e-5, atol=1e-7)
    assert int(n) == int(n_ref)


def test_slim_carry_is_bit_identical(case):
    """``slim_carry`` is the reference's scan-carry layout: accepted and
    ignored, the render bit for bit the default's."""
    img, n = integrator.render_path_with_counts(case["ps"], case["pview"],
                                                _pcfg(slim_carry=True), 0)
    ref, n_ref = integrator.render_path_with_counts(case["ps"], case["pview"], _pcfg(), 0)
    assert torch.equal(img, ref) and int(n) == int(n_ref)


def test_lane_seeds_equal_their_int_seed(case):
    """A tensor of equal per-lane seeds traces what the int seed traces."""
    cfg = _pcfg(max_bounces=1)
    px, py = camera.pixel_grid(W, H, "cpu")
    rad, n = integrator.trace_path(case["ps"], case["pview"], cfg, 9, px, py)
    seeds = torch.full((W * H,), 9, dtype=torch.int64)
    rad_t, n_t = integrator.trace_path(case["ps"], case["pview"], cfg, seeds, px, py)
    assert torch.equal(rad, rad_t) and int(n) == int(n_t)
    with pytest.raises(ValueError, match="one seed per call"):
        integrator.trace_path(case["ps"], case["pview"], _pcfg(wave_caps=CAPS), seeds, px, py)
