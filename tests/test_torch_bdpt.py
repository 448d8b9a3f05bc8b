"""BDPT of the port (render/bdpt.py, ROADMAP Queue 1 item 5) against the
JAX reference, and the reference's estimator checks on the port alone.

Against the reference, on the Cornell box (bridged, so both packages trace
the same arrays) at 12x12 with 3 bounces (4 vertices a subpath, Russian
roulette from vertex 2) on the brute-force tracer of each package, Lambert
(the MIS and connection code is the BSDF's caller only; the Disney
lobes are held in test_torch_slice.py): the MIS weights (static and
per-lane prefix) on seeded pdf arrays within 1e-6 relative; ``random_walk``
(valid and escape masks and RNG words equal, floats within 1e-4 relative
where valid); ``trace_bdpt`` radiance and splat at ``lvc_connections`` 0
and 4 and two frames of ``render_bdpt_reuse`` with their cache state
(image means within 1e-3 relative, >= 97 % of pixels within 1e-3 x (1 +
|ref|); state rows within 1e-4 relative on >= 99 % of rows).

On the port alone (the reference's tests/test_bdpt.py bounds, at its
sizes): chunked = unchunked (rtol 1e-4, atol 1e-6, > 90 % of pixels bit
for bit), the ``"pallas"`` route (the block kernel's plain version here)
against ``"brute"`` on the tiny atrium, BDPT's mean against the path
tracer's (5 %, regions 12 %), the LVC's against the paired one's (6 %),
cross-frame reuse against no reuse (6 %), two same-seed renders equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.core import rng as jrng
from stratum_tpu.render import bdpt as jbdpt
from stratum_tpu.render import camera as jcamera
from stratum_tpu.render import integrator as jintegrator
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu_torch.core import rng as prng
from stratum_tpu_torch.render import bdpt, camera, integrator
from stratum_tpu_torch.scene import bridge, builtin, flatten

torch.set_num_threads(2)

W = H = 12
CFG = dict(width=W, height=H, max_bounces=3, bsdf="lambert", tracer="brute")
MEAN_REL = 1e-3
PIXEL_SHARE = 0.97
ROW_SHARE = 0.99


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
def cornell_empty():
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


def _close_rows(a, b, rtol=1e-4):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    ok = np.all(np.abs(a - b) <= rtol * (1 + np.abs(b)), axis=-1).mean()
    assert ok >= ROW_SHARE, ok


@pytest.mark.parametrize("tsurf, s", [(1, 0), (2, 1), (3, 2), (0, 4), (4, 3)])
def test_mis_weights_match_reference(tsurf, s):
    """mis_weight_arrays on seeded pdf arrays (a quarter of them 0, which
    the ratio loop remaps to 1), and the per-lane prefix version at random
    light prefix lengths 0..5."""
    rng = np.random.default_rng(tsurf * 10 + s)
    n, d = 256, 6

    def pdfs():
        x = rng.random((n, d)).astype(np.float32) * 4
        return np.where(rng.random((n, d)) < 0.25, np.float32(0), x)

    zf, zr, yf, yr = pdfs(), pdfs(), pdfs(), pdfs()
    want = jbdpt.mis_weight_arrays(*map(jnp.asarray, (zf, zr, yf, yr)), tsurf, s)
    got = bdpt.mis_weight_arrays(*map(torch.from_numpy, (zf, zr, yf, yr)), tsurf, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    s_var = rng.integers(0, d, n).astype(np.int32)
    want = jbdpt.mis_weight_arrays_dynamic(*map(jnp.asarray, (zf, zr, yf, yr)), tsurf,
                                           jnp.asarray(s_var), d)
    got = bdpt.mis_weight_arrays_dynamic(*map(torch.from_numpy, (zf, zr, yf, yr)), tsurf,
                                         torch.from_numpy(s_var), d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_mis_weights_partition_of_unity():
    """The reference's check (tests/test_bdpt.py:63-84): the two strategies
    of a 2-vertex path, (s=0, t=2) and (s=1, t=1), weigh to 1; and the
    per-lane prefix version at s_var = s equals the static one."""
    n = 4
    rng = np.random.default_rng(0)
    p_cam = torch.from_numpy(rng.random(n).astype(np.float32) + 0.1)
    p_light = torch.from_numpy(rng.random(n).astype(np.float32) + 0.1)
    zero = torch.zeros((n, 1))
    w0 = bdpt.mis_weight_arrays(p_cam[:, None], p_light[:, None], zero, zero, 1, 0)
    w1 = bdpt.mis_weight_arrays(zero, zero, p_light[:, None], p_cam[:, None], 0, 1)
    np.testing.assert_allclose((w0 + w1).numpy(), 1.0, rtol=1e-5)
    y = torch.from_numpy(rng.random((n, 4)).astype(np.float32))
    for s in range(5):
        np.testing.assert_array_equal(
            bdpt.mis_weight_arrays_dynamic(zero, zero, y, y.flip(1), 0,
                                           torch.full((n,), s), 4).numpy(),
            bdpt.mis_weight_arrays(zero, zero, y, y.flip(1), 0, s).numpy())


def test_random_walk_matches_reference(case):
    """A camera subpath of 4 vertices from the same rays and RNG words:
    the masks and the RNG words after the walk equal, the floats of valid
    vertices and escapes within 1e-4 relative."""
    jcfg = jintegrator.RenderConfig(**CFG)
    pcfg = integrator.RenderConfig(**CFG)
    jpx, jpy = jcamera.pixel_grid(W, H)
    jst = jrng.rng_init(jpx, jpy, 5)
    u, jst = jrng.next_floats(jst, 2)
    o, d = jcamera.generate_rays(case["jview"], jpx, jpy, u, W, H)
    pdf = jbdpt._camera_dir_pdf_w(case["jview"], d, W, H)
    n = o.shape[0]
    jz, jesc, jst2, jrev = jbdpt.random_walk(case["js"], jcfg, jst, o, d,
                                             jnp.ones((n, 3)), pdf, 4)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    pst = t(np.asarray(jst).view(np.int32))
    pz, pesc, pst2, prev = bdpt.random_walk(case["ps"], pcfg, pst, t(o), t(d),
                                            torch.ones((n, 3)), t(pdf), 4)
    np.testing.assert_array_equal(pst2.numpy(), np.asarray(jst2).view(np.int32))
    np.testing.assert_array_equal(pz.valid.numpy(), np.asarray(jz.valid))
    np.testing.assert_array_equal(pesc.mask.numpy(), np.asarray(jesc.mask))
    valid = np.asarray(jz.valid)
    assert 0 < valid.sum() < valid.size
    for name in ("material", "light_row", "front"):
        np.testing.assert_array_equal(getattr(pz, name).numpy()[valid],
                                      np.asarray(getattr(jz, name))[valid], err_msg=name)
    for name in ("position", "ns", "ng", "wo", "beta", "pdf_fwd", "pdf_rev", "uv"):
        a, b = getattr(pz, name).numpy()[valid], np.asarray(getattr(jz, name))[valid]
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(), err_msg=name)
    m = np.asarray(jesc.mask)
    for name in ("direction", "beta", "pdf_w"):
        np.testing.assert_allclose(getattr(pesc, name).numpy()[m],
                                   np.asarray(getattr(jesc, name))[m], rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(prev.numpy(), np.asarray(jrev), rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("lvc", [0, 4])
def test_trace_bdpt_matches_reference(case, lvc):
    """One BDPT sample: the t >= 2 radiance and the t = 1 splat, paired
    connections and the light-vertex cache with 4 reservoir draws."""
    kw = dict(CFG, lvc_connections=lvc)
    jrad, jsplat = jbdpt.trace_bdpt(case["js"], case["jview"], jintegrator.RenderConfig(**kw), 3)
    prad, psplat = bdpt.trace_bdpt(case["ps"], case["pview"], integrator.RenderConfig(**kw), 3)
    _close_image(prad.numpy(), np.asarray(jrad))
    _close_image(psplat.numpy(), np.asarray(jsplat))


def test_render_bdpt_reuse_matches_reference(case):
    """Two frames with cross-frame light-cache reuse: each image, and the
    state the second frame returns (winners' camera-vertex positions and
    their packed cache rows with W and M)."""
    kw = dict(CFG, lvc_connections=4)
    jcfg, pcfg = jintegrator.RenderConfig(**kw), integrator.RenderConfig(**kw)
    jstate = pstate = None
    for seed in (0, 1):
        jrad, jsplat, jstate = jbdpt.trace_bdpt(case["js"], case["jview"], jcfg, seed,
                                                prev_lvc=jstate, want_lvc_state=True)
        pimg, pstate = bdpt.render_bdpt_reuse(case["ps"], case["pview"], pcfg, seed, pstate)
        _close_image(pimg.numpy(), np.asarray(jrad + jsplat).reshape(H, W, 3))
    assert pstate["packed"].shape == (4 * W * H, 37 + 2)
    _close_rows(pstate["pos"].numpy(), jstate["pos"])
    _close_rows(pstate["packed"].numpy(), jstate["packed"])


def test_prev_lvc_without_state_request(case):
    """A frame fed the previous cache without asking for its own: the
    reference raises (its grid's cell size reads the camera, which it
    passes only with ``want_lvc_state``, bdpt.py:1042-1043, 537-539); the
    port renders the frame the state-returning call renders."""
    kw = dict(CFG, lvc_connections=4)
    pcfg = integrator.RenderConfig(**kw)
    _, state = bdpt.render_bdpt_reuse(case["ps"], case["pview"], pcfg, 0)
    rad, splat = bdpt.trace_bdpt(case["ps"], case["pview"], pcfg, 1, prev_lvc=state)
    rad2, splat2, _ = bdpt.trace_bdpt(case["ps"], case["pview"], pcfg, 1, prev_lvc=state,
                                      want_lvc_state=True)
    assert torch.equal(rad, rad2) and torch.equal(splat, splat2)
    jcfg = jintegrator.RenderConfig(**kw)
    _, _, jstate = jbdpt.trace_bdpt(case["js"], case["jview"], jcfg, 0, want_lvc_state=True)
    with pytest.raises(TypeError):
        jbdpt.trace_bdpt(case["js"], case["jview"], jcfg, 1, prev_lvc=jstate)


def test_light_stream_words_past_2_31():
    """The light paths' stream word 0x9E3779B9 and path ids past 2^31
    (lane0 near 2^32 wraps) give the reference's words."""
    lane0, n = 2**32 - 100, 256
    j = jrng.rng_init(np.uint32(lane0) + jnp.arange(n, dtype=jnp.uint32), jbdpt._LIGHT_STREAM, 7)
    p = prng.rng_init(lane0 + torch.arange(n, dtype=torch.int64), bdpt._LIGHT_STREAM, 7)
    np.testing.assert_array_equal(p.numpy(), np.asarray(j).view(np.int32))
    ju, _ = jrng.next_floats(j, 5)
    pu, _ = prng.next_floats(p, 5)
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))


def test_bdpt_chunked_matches_unchunked():
    """render_bdpt_chunked = render_bdpt (tests/test_bdpt.py:190-207):
    every sampling decision is the same, only the splat's sums regroup."""
    g = builtin.cornell_box()
    scene, _ = flatten.flatten(g.root, device="cpu")
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, 32, 16, device="cpu")
    cfg = integrator.RenderConfig(width=32, height=16, max_bounces=2)
    full = bdpt.render_bdpt(scene, view, cfg, 3).numpy()
    chunked = bdpt.render_bdpt_chunked(scene, view, cfg, 3, 4).numpy()
    np.testing.assert_allclose(chunked, full, rtol=1e-4, atol=1e-6)
    assert (full.reshape(-1, 3) == chunked.reshape(-1, 3)).all(axis=-1).mean() > 0.9


@pytest.mark.parametrize("lvc", [0, 4])
def test_pallas_route_matches_brute(lvc):
    """On the tiny atrium (1,280 triangles) the block tracer's route (its
    sorted closest waves and batched occlusion waves, the plain version on
    the CPU) against the brute-force tracer: the same estimator."""
    g = builtin.atrium(columns=1, stacks=6, slices=12)
    scene, _ = flatten.flatten(g.root, device="cpu")
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, 16, 16, device="cpu")
    kw = dict(width=16, height=16, max_bounces=3, bsdf="disney", lvc_connections=lvc)
    a = bdpt.render_bdpt(scene, view, integrator.RenderConfig(tracer="pallas", **kw), 2)
    b = bdpt.render_bdpt(scene, view, integrator.RenderConfig(tracer="brute", **kw), 2)
    _close_image(a.numpy(), b.numpy())


def test_bdpt_matches_pt(cornell_empty):
    """BDPT and the path tracer estimate one image (tests/test_bdpt.py:22-34)."""
    scene, view = cornell_empty
    cfg = integrator.RenderConfig(width=32, height=32, max_bounces=2, rr_depth=100)
    pt = integrator.render_path_progressive(scene, view, cfg, 24).numpy()
    bd = bdpt.render_bdpt_progressive(scene, view, cfg, 24).numpy()
    assert bd.mean() == pytest.approx(pt.mean(), rel=0.05)
    for region in (np.s_[24:30, 8:24], np.s_[10:20, 8:24]):
        assert bd[region].mean() == pytest.approx(pt[region].mean(), rel=0.12)


def test_lvc_matches_paired(cornell_empty):
    """Light-cache connections against the paired ones (tests/test_bdpt.py:143-163)."""
    scene, view = cornell_empty
    kw = dict(width=32, height=32, max_bounces=2, rr_depth=100)
    paired = bdpt.render_bdpt_progressive(scene, view, integrator.RenderConfig(**kw), 24)
    lvc = bdpt.render_bdpt_progressive(
        scene, view, integrator.RenderConfig(lvc_connections=4, **kw), 24)
    assert bool(torch.isfinite(lvc).all())
    assert float(lvc.mean()) == pytest.approx(float(paired.mean()), rel=0.06)


def test_lvc_cross_frame_reuse_mean(cornell_empty):
    """Frames fed each other's cache state keep the mean (tests/test_bdpt.py:166-187)."""
    scene, view = cornell_empty
    cfg = integrator.RenderConfig(width=32, height=32, max_bounces=2, rr_depth=100,
                                  lvc_connections=4)
    base = bdpt.render_bdpt_progressive(scene, view, cfg, 24)
    acc, state = torch.zeros_like(base), None
    for s in range(24):
        img, state = bdpt.render_bdpt_reuse(scene, view, cfg, s, state)
        acc = acc + img
    reuse = acc / 24
    assert bool(torch.isfinite(reuse).all())
    assert float(reuse.mean()) == pytest.approx(float(base.mean()), rel=0.06)


def test_bdpt_deterministic(cornell_empty):
    """Two renders of one seed are equal bit for bit (tests/test_bdpt.py:54-60)."""
    scene, view = cornell_empty
    cfg = integrator.RenderConfig(width=32, height=32, max_bounces=2)
    a = bdpt.render_bdpt(scene, view, cfg, 9)
    assert torch.equal(a, bdpt.render_bdpt(scene, view, cfg, 9))
    assert bool(torch.isfinite(a).all())
