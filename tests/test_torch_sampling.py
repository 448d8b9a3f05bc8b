"""The samplers and sample allocation of the port (ROADMAP Queue 1 item 5):
the Kronecker lattice (``core/rng.QMC = "kron"``), ``indirect_only`` and
adaptive sampling (render/adaptive.py), against the JAX reference.

Bit for bit: the lattice's alpha table and its words (``next_uint``,
``next_floats``) over a sweep of pixels, seeds (past 2^31) and dimensions
(past the 512-entry table); ``_topk_pixels``' selection, on a score field
with ties and on a noisy one.

Renders, on the Cornell box (bridged) on the brute-force tracer of each
package (Lambert, 3 bounces), at the bounds of test_torch_slice.py (image
mean within 2 % relative, >= 97 % of pixels within 1e-3 x (1 + |ref|),
n_rays within 1 %): ``trace_path`` under the lattice (16x16);
``indirect_only`` (32x32: 1,024 lanes) on the plain path, under
``wave_caps=(1, 0.5, 0.3)`` (compacted to 512 lanes twice) and with
per-lane seeds (``render_path_lanes``, 2 spp); ``render_adaptive`` (16x16,
a 4 spp budget, pilot 2, frac 0.25): image and counts. On the port alone:
what ``indirect_only`` drops is the direct lighting (full - indirect at 3
bounces = full - indirect at 1, 1e-4 relative), and the adaptive budget
and counts (tests/test_adaptive.py).

``QMC`` is process-global: every test that sets it restores it (the
``kron`` fixture), so no later test in the worker sees the lattice.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.core import rng as jrng
from stratum_tpu.render import adaptive as jadaptive
from stratum_tpu.render import camera as jcamera
from stratum_tpu.render import integrator as jintegrator
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu_torch.core import rng as prng
from stratum_tpu_torch.render import adaptive, camera, integrator
from stratum_tpu_torch.scene import bridge

torch.set_num_threads(2)

MEAN_REL = 0.02
PIXEL_SHARE = 0.97
RAYS_REL = 0.01
CFG = dict(max_bounces=3, tracer="brute")


@pytest.fixture
def kron():
    """Both packages on the lattice for one test, then back to "rand"."""
    old = (jrng.QMC, prng.QMC)
    jrng.QMC = prng.QMC = "kron"
    try:
        yield
    finally:
        jrng.QMC, prng.QMC = old


@pytest.fixture(scope="module")
def cornell():
    g = jbuiltin.cornell_box()
    js, _ = jflatten.flatten(g.root)
    node, cam = jflatten.find_camera(g.root)
    c2w = np.asarray(node.to_world())
    views = {}
    for w in (16, 32):
        views[w] = (jcamera.make_view(c2w, cam.fovy, w, w),
                    camera.make_view(c2w, cam.fovy, w, w, device="cpu"))
    return dict(js=js, ps=bridge.scene_from_numpy(bridge.numpy_fields(js), "cpu"), views=views)


def _agree(img, ref, n=None, n_ref=None):
    img, ref = np.asarray(img), np.asarray(ref)
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert abs(img.mean() - ref.mean()) <= MEAN_REL * ref.mean(), (img.mean(), ref.mean())
    pix = np.all(np.abs(img - ref) <= 1e-3 * (1 + np.abs(ref)), axis=-1).mean()
    assert pix >= PIXEL_SHARE, pix
    if n is not None:
        assert abs(int(n) - int(n_ref)) <= RAYS_REL * int(n_ref), (int(n), int(n_ref))


def test_alpha_table_matches_reference():
    np.testing.assert_array_equal(prng._ALPHAS, np.asarray(jrng._ALPHAS).astype(np.int64))


@pytest.mark.parametrize("seed, offset", [
    (0, 0), (1, 7), (2**31 + 12345, 500), (0xFFFFFFFF, 509), (77, 1000), (2**32 - 2, 4094),
])
def test_kron_words_match_reference(kron, seed, offset):
    """Lattice words for 2,000 random pixels: 9 floats in one draw (which
    crosses the 512-entry table at offsets 500 and 509), then single
    uints; state words equal after each draw."""
    rng = np.random.default_rng(offset)
    px = rng.integers(0, 8192, 2000).astype(np.uint32)
    py = rng.integers(0, 8192, 2000).astype(np.uint32)
    j = jrng.rng_init(jnp.asarray(px), jnp.asarray(py), np.uint32(seed), offset)
    p = prng.rng_init(torch.from_numpy(px.astype(np.int64)), torch.from_numpy(py.astype(np.int64)),
                      seed, offset)
    ju, j = jrng.next_floats(j, 9)
    pu, p = prng.next_floats(p, 9)
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    for _ in range(3):
        jb, j = jrng.next_uint(j)
        pb, p = prng.next_uint(p)
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jb).view(np.int32))
        np.testing.assert_array_equal(p.numpy(), np.asarray(j).view(np.int32))
    jf, _ = jrng.next_float(j)
    pf, _ = prng.next_float(p)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))


def test_qmc_restored():
    """No test leaves the lattice on (this one runs after the kron tests
    in this file's worker)."""
    assert prng.QMC == "rand" and jrng.QMC == "rand"


def test_trace_path_kron_matches_reference(cornell, kron):
    jv, pv = cornell["views"][16]
    cfg = dict(CFG, width=16, height=16)
    jrad, jn = jintegrator.trace_path(cornell["js"], jv, jintegrator.RenderConfig(**cfg), 3)
    prad, pn = integrator.trace_path(cornell["ps"], pv, integrator.RenderConfig(**cfg), 3)
    _agree(prad.numpy(), np.asarray(jrad), pn, jn)


@pytest.mark.parametrize("path", ["plain", "wave_caps", "lanes"])
def test_indirect_only_matches_reference(cornell, path):
    """indirect_only on each path of trace_path: the plain bounce loop, the
    compacting loop and per-lane seeds."""
    jv, pv = cornell["views"][32]
    cfg = dict(CFG, width=32, height=32, indirect_only=True)
    if path == "wave_caps":
        cfg["wave_caps"] = (1, 0.5, 0.3)
    jcfg, pcfg = jintegrator.RenderConfig(**cfg), integrator.RenderConfig(**cfg)
    if path == "lanes":
        jimg, jn = jintegrator.render_path_lanes(cornell["js"], jv, jcfg, 2, 5)
        pimg, pn = integrator.render_path_lanes(cornell["ps"], pv, pcfg, 2, 5)
    else:
        jimg, jn = jintegrator.trace_path(cornell["js"], jv, jcfg, 5)
        pimg, pn = integrator.trace_path(cornell["ps"], pv, pcfg, 5)
    _agree(pimg.numpy(), np.asarray(jimg), pn, jn)


def test_indirect_plus_direct_is_full(cornell):
    """What indirect_only drops (emission and escapes at depths 0-1, NEE at
    depth 0) is exactly the direct lighting: with Russian roulette off, the
    first two vertices of a path are the same at 3 bounces and at 1, so
    full - indirect at 3 bounces equals full - indirect at 1 (means within
    1e-4 relative: the same terms, summed beside others); the emitter (15)
    is not seen directly."""
    _, pv = cornell["views"][32]
    kw = dict(width=32, height=32, rr_depth=100, tracer="brute")

    def img(**extra):
        return integrator.render_path_progressive(
            cornell["ps"], pv, integrator.RenderConfig(**kw, **extra), 4)

    full, ind = img(max_bounces=3), img(max_bounces=3, indirect_only=True)
    assert float(ind.amax()) < 15.0 <= float(full.amax())
    got = float((full - ind).mean())
    want = float((img(max_bounces=1) - img(max_bounces=1, indirect_only=True)).mean())
    assert got > 0 and got == pytest.approx(want, rel=1e-4)


def test_topk_pixels_match_reference():
    """_topk_pixels on a score field with ties (zero variance everywhere:
    the scores are 1e-8 / count^2, equal within each count) and on a
    noisy one: the same pixels in the same order as lax.top_k."""
    rng = np.random.default_rng(4)
    cfg = integrator.RenderConfig(width=16, height=12)
    jcfg = jintegrator.RenderConfig(width=16, height=12)
    n = 16 * 12
    count = rng.integers(1, 4, n).astype(np.float32)
    fields = [
        (np.zeros((n, 3), np.float32), np.zeros(n, np.float32)),
        (rng.random((n, 3)).astype(np.float32) * count[:, None],
         rng.random(n).astype(np.float32) * 3),
    ]
    for accum, accum_sq in fields:
        for L in (1, 48, 100):
            ji, jx, jy = jadaptive._topk_pixels(jcfg, *map(jnp.asarray, (accum, accum_sq, count)),
                                                L)
            pi_, px, py = adaptive._topk_pixels(cfg, *map(torch.from_numpy,
                                                          (accum, accum_sq, count)), L)
            np.testing.assert_array_equal(pi_.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(px.numpy(), np.asarray(jx).astype(np.int32))
            np.testing.assert_array_equal(py.numpy(), np.asarray(jy).astype(np.int32))


def test_render_adaptive_matches_reference(cornell):
    """A 4 spp budget: 2 uniform rounds, then rounds of the top quarter."""
    jv, pv = cornell["views"][16]
    cfg = dict(CFG, width=16, height=16)
    jimg, jst = jadaptive.render_adaptive(cornell["js"], jv, jintegrator.RenderConfig(**cfg), 4,
                                          pilot=2, frac=0.25, seed0=1)
    pimg, pst = adaptive.render_adaptive(cornell["ps"], pv, integrator.RenderConfig(**cfg), 4,
                                         pilot=2, frac=0.25, seed0=1)
    np.testing.assert_array_equal(pst.count.numpy(), np.asarray(jst.count))
    _agree(pimg.numpy(), np.asarray(jimg))


def test_budget_and_counts(cornell):
    """tests/test_adaptive.py:21-30 on the port: pilot coverage, the budget
    kept, an allocation that varies."""
    _, pv = cornell["views"][32]
    cfg = integrator.RenderConfig(width=32, height=32, max_bounces=3)
    img, st = adaptive.render_adaptive(cornell["ps"], pv, cfg, 8, pilot=4, frac=0.25, seed0=0)
    cnt = st.count.numpy()
    assert bool(torch.isfinite(img).all())
    assert cnt.min() >= 4 and cnt.max() > cnt.min()
    assert cnt.mean() == pytest.approx(8.0, abs=0.3)
