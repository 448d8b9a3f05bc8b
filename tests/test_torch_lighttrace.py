"""Light tracing of the port (render/lighttrace.py, ROADMAP Queue 1 item 5)
against the JAX reference, the deterministic splat, and the reference's
estimator checks on the port alone.

Against the reference, on the Cornell box (bridged) at 12x12 with 3
bounces on the brute-force tracer of each package: the light paths' RNG
words bit for bit (path ids past 2^31 and wrapping at 2^32, the stream
word 0x9E3779B9); ``trace_light`` (Lambert) and ``render_lt`` (Disney)
within the BDPT tests' bounds (image mean within 1e-3 relative, >= 97 % of
pixels within 1e-3 x (1 + |ref|)).

The splat: ``splat_add`` against a float64 sum (1e-6 relative) and two
calls bit-equal. The ``"pallas"`` route (the block kernel's plain version
here) against ``"brute"`` on the tiny atrium, within the same bounds. On
the port alone (tests/test_lighttrace.py's bounds and
sizes): the light-traced mean against the path tracer's (8 %, regions
15 %), the emitter seen directly, two renders equal, and
``render_lt_progressive`` = the mean of ``render_lt`` (rtol 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.core import rng as jrng
from stratum_tpu.render import camera as jcamera
from stratum_tpu.render import integrator as jintegrator
from stratum_tpu.render import lighttrace as jlt
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu_torch.core import rng as prng
from stratum_tpu_torch.render import camera, integrator, lighttrace
from stratum_tpu_torch.scene import bridge, builtin, flatten

torch.set_num_threads(2)

W = H = 12
CFG = dict(width=W, height=H, max_bounces=3, tracer="brute")
MEAN_REL = 1e-3
PIXEL_SHARE = 0.97


@pytest.fixture(scope="module")
def case():
    g = jbuiltin.cornell_box()
    js, _ = jflatten.flatten(g.root)
    node, cam = jflatten.find_camera(g.root)
    c2w = np.asarray(node.to_world())
    return dict(
        js=js, jview=jcamera.make_view(c2w, cam.fovy, W, H),
        ps=bridge.scene_from_numpy(bridge.numpy_fields(js), "cpu"),
        pview=camera.make_view(c2w, cam.fovy, W, H, device="cpu"),
    )


@pytest.fixture(scope="module")
def cornell_small():
    g = builtin.cornell_box(boxes=False)
    scene, _ = flatten.flatten(g.root, device="cpu")
    node, cam = flatten.find_camera(g.root)
    return scene, camera.make_view(node.to_world(), cam.fovy, 32, 32, device="cpu")


def _close_image(img, ref):
    img, ref = np.asarray(img), np.asarray(ref)
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert abs(img.mean() - ref.mean()) <= MEAN_REL * abs(ref.mean()), (img.mean(), ref.mean())
    pix = np.all(np.abs(img - ref) <= 1e-3 * (1 + np.abs(ref)), axis=-1).mean()
    assert pix >= PIXEL_SHARE, pix


@pytest.mark.parametrize("lane0, seed", [(0, 0), (2**31 - 7, 3), (2**32 - 5, 0xFFFFFFFE)])
def test_light_path_rng_words_match_reference(lane0, seed):
    """rng_init(lane0 + path id, 0x9E3779B9, seed) and five draws: the
    words and the floats equal the reference's."""
    n = 64
    ids = (np.uint64(lane0) + np.arange(n, dtype=np.uint64)).astype(np.uint32)
    j = jrng.rng_init(jnp.asarray(ids), jlt._LIGHT_STREAM, np.uint32(seed))
    p = prng.rng_init(lane0 + torch.arange(n, dtype=torch.int64), lighttrace._LIGHT_STREAM,
                      seed)
    np.testing.assert_array_equal(p.numpy(), np.asarray(j).view(np.int32))
    ju, j = jrng.next_floats(j, 5)
    pu, p = prng.next_floats(p, 5)
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    jb, _ = jrng.next_uint(j)
    pb, _ = prng.next_uint(p)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb).view(np.int32))


def test_trace_light_matches_reference(case):
    """The splatted light paths of one sample (Lambert)."""
    want = jlt.trace_light(case["js"], case["jview"], jintegrator.RenderConfig(**CFG), 3)
    got = lighttrace.trace_light(case["ps"], case["pview"], integrator.RenderConfig(**CFG), 3)
    assert float(got.amax()) > 0
    _close_image(got.numpy(), np.asarray(want))


def test_render_lt_matches_reference(case):
    """A whole light-traced sample (Disney): splats and visible emission."""
    kw = dict(CFG, bsdf="disney")
    want = jlt.render_lt(case["js"], case["jview"], jintegrator.RenderConfig(**kw), 5)
    got = lighttrace.render_lt(case["ps"], case["pview"], integrator.RenderConfig(**kw), 5)
    _close_image(got.numpy(), np.asarray(want))


def test_splat_add_fixed_order():
    """The splat's sum per pixel against float64 (many terms a pixel, runs
    of every length), and two calls bit-equal."""
    rng = np.random.default_rng(0)
    m, pix = 5000, 300
    idx = rng.integers(0, pix, m) ** 2 % pix  # uneven runs
    val = rng.standard_normal((m, 3)).astype(np.float32)
    want = np.zeros((pix, 3))
    np.add.at(want, idx, val.astype(np.float64))
    base = torch.ones((pix, 3))
    a = lighttrace.splat_add(base, torch.from_numpy(idx), torch.from_numpy(val))
    b = lighttrace.splat_add(base, torch.from_numpy(idx), torch.from_numpy(val))
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), 1.0 + want, rtol=1e-6, atol=1e-5)


def test_pallas_route_matches_brute():
    """On the tiny atrium the block tracer's route (sorted closest waves,
    occlusion waves; the plain version on the CPU) against the brute-force
    tracer: the same light-traced sample."""
    g = builtin.atrium(columns=1, stacks=6, slices=12)
    scene, _ = flatten.flatten(g.root, device="cpu")
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, 16, 16, device="cpu")
    kw = dict(width=16, height=16, max_bounces=3, bsdf="disney")
    a = lighttrace.render_lt(scene, view, integrator.RenderConfig(tracer="pallas", **kw), 2)
    b = lighttrace.render_lt(scene, view, integrator.RenderConfig(tracer="brute", **kw), 2)
    _close_image(a.numpy(), b.numpy())


def test_lt_matches_pt_mean(cornell_small):
    """Light tracing and path tracing estimate one image
    (tests/test_lighttrace.py:22-42)."""
    scene, view = cornell_small
    cfg = integrator.RenderConfig(width=32, height=32, max_bounces=2, rr_depth=100)
    pt = integrator.render_path_progressive(scene, view, cfg, 48).numpy()
    lt = lighttrace.render_lt_progressive(scene, view, cfg, 48).numpy()
    assert lt.mean() == pytest.approx(pt.mean(), rel=0.08)
    for region in (np.s_[24:30, 8:24], np.s_[10:20, 8:24]):
        assert lt[region].mean() == pytest.approx(pt[region].mean(), rel=0.15)


def test_lt_direct_emission_visible(cornell_small):
    """The light quad seen directly (tests/test_lighttrace.py:45-52)."""
    scene, view = cornell_small
    cfg = integrator.RenderConfig(width=32, height=32, max_bounces=1)
    em = lighttrace.trace_emission_only(scene, view, cfg, 0)
    assert float(em.amax()) == pytest.approx(15.0, rel=1e-5)
    assert float(lighttrace.render_lt(scene, view, cfg, 0).amax()) >= 15.0


def test_lt_deterministic_and_progressive(cornell_small):
    """Two renders of one seed equal bit for bit; the progressive render is
    the mean of the samples."""
    scene, view = cornell_small
    cfg = integrator.RenderConfig(width=32, height=32, max_bounces=2)
    a = lighttrace.render_lt(scene, view, cfg, 3)
    assert torch.equal(a, lighttrace.render_lt(scene, view, cfg, 3))
    mean = (lighttrace.render_lt(scene, view, cfg, 2) + a) / 2
    np.testing.assert_allclose(lighttrace.render_lt_progressive(scene, view, cfg, 2, 2).numpy(),
                               mean.numpy(), rtol=1e-6, atol=1e-7)
