"""The port's tile split over devices (stratum_tpu_torch/parallel/mesh.py)
on ``make_mesh(["cpu"] * 8)``, the counterpart of the reference's 8
virtual CPU devices: every sharded variant against the port's unsharded
counterpart by the criterion of the matching test in tests/test_parallel.py
(allclose rtol 1e-4 / atol 1e-6, and where that test asks it more than 90 %
of pixels bit-equal; 75 % for lane batching; the session frame rtol 1e-4 /
atol 1e-5; spatial ReSTIR taps a mean within 15 %), ``render_path_sharded``
against the JAX package's on its own 8-device mesh (64x32 Cornell box,
allclose rtol 1e-4 / atol 1e-6), the sharded denoiser bit for bit with
bands narrower than the image, and ``RenderSession(mesh=...)``.
"""

import numpy as np
import pytest
import torch

from stratum_tpu_torch.parallel import mesh as pmesh
from stratum_tpu_torch.render import aov, camera, denoise, integrator, session
from stratum_tpu_torch.scene import builtin, flatten

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def cornell():
    out = {}
    for boxes in (True, False):
        g = builtin.cornell_box(boxes=boxes)
        scene, _ = flatten.flatten(g.root, device="cpu")
        node, cam = flatten.find_camera(g.root)
        out[boxes] = (scene, node.to_world(), cam.fovy)
    return out


@pytest.fixture(scope="module")
def mesh8():
    return pmesh.make_mesh(["cpu"] * 8)


def _view(c2w, fovy, w, h):
    return camera.make_view(c2w, fovy, w, h, device="cpu")


def _close(a, b, exact=None):
    a = np.asarray(a).reshape(-1, 3)
    b = np.asarray(b).reshape(-1, 3)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    if exact is not None:
        frac = (a == b).all(axis=-1).mean()
        assert frac > exact, frac


def test_make_mesh():
    m = pmesh.make_mesh(["cpu"] * 3, axis="rows")
    assert m.size == 3 and m.axis_names == ("rows",)
    assert all(d == torch.device("cpu") for d in m.devices)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.make_mesh()
    with pytest.raises(ValueError, match="not divisible"):
        pmesh._shards(10, m)


@pytest.mark.parametrize("case", ["plain", "presample_coherent", "kron"])
def test_sharded_render_bit_identical(cornell, mesh8, case):
    """tests/test_parallel.py's three bit-identity tests: the plain path,
    presampled coherent tiles (shards of 256 lanes are whole 128-lane
    granules) and the Kronecker lattice."""
    from stratum_tpu_torch.core import rng as srng

    scene, c2w, fovy = cornell[True]
    w, h = 64, 32
    view = _view(c2w, fovy, w, h)
    extra = (dict(presample_lights=256, coherent_tiles=16, coherent_block=128)
             if case == "presample_coherent" else {})
    cfg = integrator.RenderConfig(width=w, height=h, max_bounces=3, **extra)
    prev = srng.QMC
    srng.QMC = "kron" if case == "kron" else prev
    try:
        single = integrator.render_path(scene, view, cfg, 5)
        sharded = pmesh.render_path_sharded(scene, view, cfg, 5, mesh8)
    finally:
        srng.QMC = prev
    assert sharded.device.type == "cpu" and sharded.shape == (h, w, 3)
    _close(single, sharded, exact=0.9)


def test_sharded_shards_are_whole_granules(cornell):
    """1,536 pixels over 4 devices with 256-lane granules: the equal
    shards (384 lanes) would split granules and draw other light-tile
    groups; the boundaries rounded to whole granules keep the unsharded
    render's: the image bit for bit, and the rays add up."""
    scene, c2w, fovy = cornell[True]
    w, h = 48, 32
    view = _view(c2w, fovy, w, h)
    cfg = integrator.RenderConfig(width=w, height=h, max_bounces=3, presample_lights=256,
                                  coherent_tiles=16, coherent_block=256)
    m4 = pmesh.make_mesh(["cpu"] * 4)
    cuts = [sl.start for _, sl in pmesh._shards(w * h, m4, granule=pmesh._granule(cfg))]
    assert cuts == [0, 512, 768, 1280]
    single, n_single = integrator.render_path_with_counts(scene, view, cfg, 5)
    sharded, n_sharded = pmesh.render_path_sharded_with_counts(scene, view, cfg, 5, m4)
    assert torch.equal(single, sharded)
    assert int(n_single) == int(n_sharded)


def test_render_path_sharded_matches_jax(cornell, mesh8):
    """The port's sharded render against the JAX package's
    ``render_path_sharded`` on its 8-device mesh, same scene and seed."""
    import jax

    from stratum_tpu.parallel import mesh as jmesh
    from stratum_tpu.render import camera as jcamera
    from stratum_tpu.render import integrator as jintegrator
    from stratum_tpu.scene import builtin as jbuiltin
    from stratum_tpu.scene import flatten as jflatten

    assert len(jax.devices()) == 8
    g = jbuiltin.cornell_box()
    jscene, _ = jflatten.flatten(g.root)
    node, cam = jflatten.find_camera(g.root)
    w, h = 64, 32
    jcfg = jintegrator.RenderConfig(width=w, height=h, max_bounces=3)
    want = np.asarray(jmesh.render_path_sharded(
        jscene, jcamera.make_view(node.to_world(), cam.fovy, w, h), jcfg, 5,
        jmesh.make_mesh()))
    scene, c2w, fovy = cornell[True]
    got = pmesh.render_path_sharded(scene, _view(c2w, fovy, w, h),
                                    integrator.RenderConfig(width=w, height=h, max_bounces=3),
                                    5, mesh8)
    _close(got, want)


def test_sharded_progressive(cornell, mesh8):
    scene, c2w, fovy = cornell[True]
    view = _view(c2w, fovy, 32, 32)
    cfg = integrator.RenderConfig(width=32, height=32, max_bounces=2)
    img = pmesh.render_path_progressive_sharded(scene, view, cfg, 2, mesh8)
    _close(img, integrator.render_path_progressive(scene, view, cfg, 2))


def test_sharded_lane_batch_matches_unsharded(cornell, mesh8):
    scene, c2w, fovy = cornell[True]
    w, h = 64, 32
    view = _view(c2w, fovy, w, h)
    cfg = integrator.RenderConfig(width=w, height=h, max_bounces=3, presample_lights=256,
                                  coherent_tiles=16, coherent_block=128)
    single, n_single = integrator.render_path_lanes(scene, view, cfg, 2, 7)
    sharded, n_sharded = pmesh.render_path_lanes_sharded(scene, view, cfg, 2, 7, mesh8)
    _close(single, sharded, exact=0.75)
    assert int(n_single) == int(n_sharded)


def test_sharded_lt_matches_unsharded(cornell, mesh8):
    from stratum_tpu_torch.render import lighttrace

    scene, c2w, fovy = cornell[False]
    view = _view(c2w, fovy, 32, 32)
    cfg = integrator.RenderConfig(width=32, height=32, max_bounces=2)
    _close(pmesh.render_lt_sharded(scene, view, cfg, 3, mesh8),
           lighttrace.render_lt(scene, view, cfg, 3))


@pytest.mark.slow
def test_sharded_bdpt_matches_unsharded(cornell, mesh8):
    from stratum_tpu_torch.render import bdpt

    scene, c2w, fovy = cornell[False]
    view = _view(c2w, fovy, 16, 16)
    cfg = integrator.RenderConfig(width=16, height=16, max_bounces=1, rr_depth=100)
    _close(pmesh.render_bdpt_sharded(scene, view, cfg, 3, mesh8),
           bdpt.render_bdpt(scene, view, cfg, 3))


def test_sharded_session_frame(cornell, mesh8):
    """Render + G-buffer + SVGF sharded equals the unsharded frame."""
    scene, c2w, fovy = cornell[True]
    w, h = 64, 32
    view = _view(c2w, fovy, w, h)
    cfg = integrator.RenderConfig(width=w, height=h, max_bounces=2)
    dcfg = denoise.DenoiseConfig()
    rad = integrator.render_path(scene, view, cfg, 3)
    gb = aov.render_gbuffer(scene, view, view, cfg)
    st1, img1 = denoise.denoise(denoise.init_state(h, w, "cpu"), rad, gb, dcfg)
    gb_s = pmesh.render_gbuffer_sharded(scene, view, view, cfg, mesh8)
    np.testing.assert_allclose(gb.depth.numpy(), gb_s.depth.numpy(), rtol=1e-5, atol=1e-6)
    assert torch.equal(gb.instance, gb_s.instance)
    st2, img2 = pmesh.session_frame_sharded(scene, view, view, cfg, dcfg,
                                            denoise.init_state(h, w, "cpu"), 3, mesh8)
    np.testing.assert_allclose(img1.numpy(), img2.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(st1.color.numpy(), st2.color.numpy(), rtol=1e-4, atol=1e-5)


def test_denoise_sharded_bands_bit_for_bit(cornell):
    """Bands narrower than the image (4 devices over 64 rows, 2 a-trous
    iterations: a halo of 9 rows) over two frames with a camera move, so
    the second frame reprojects across bands: state and image equal the
    unsharded pass's bit for bit, ``history_tap`` included."""
    scene, c2w, fovy = cornell[True]
    w, h = 32, 64
    moved = c2w.copy()
    moved[0, 3] += 40.0
    views = [_view(c2w, fovy, w, h), _view(moved, fovy, w, h)]
    cfg = integrator.RenderConfig(width=w, height=h, max_bounces=2)
    dcfg = denoise.DenoiseConfig(atrous_iterations=2, history_tap=1)
    assert pmesh._denoise_halo(dcfg) == 9
    m4 = pmesh.make_mesh(["cpu"] * 4)
    st_a = st_b = denoise.init_state(h, w, "cpu")
    prev = views[0]
    for i, view in enumerate(views):
        rad = integrator.render_path(scene, view, cfg, i)
        gb = aov.render_gbuffer(scene, view, prev, cfg)
        st_a, img_a = denoise.denoise(st_a, rad, gb, dcfg)
        st_b, img_b = pmesh.denoise_sharded(st_b, rad, gb, dcfg, m4)
        assert torch.equal(img_a, img_b)
        for x, y in zip(st_a, st_b):
            assert torch.equal(x, y)
        prev = view
    assert bool((gb.prev_uv[..., 0] >= 0).any())


def test_sharded_restir(cornell, mesh8):
    """The temporal path across a camera move equals the unsharded
    estimator; spatial taps stay shard-local, finite and close in mean."""
    from stratum_tpu_torch.render import restir

    scene, c2w, fovy = cornell[True]
    w, h = 64, 32
    view0 = _view(c2w, fovy, w, h)
    moved = c2w.copy()
    moved[0, 3] += 0.08
    view1 = _view(moved, fovy, w, h)
    cfg = integrator.RenderConfig(width=w, height=h, max_bounces=1)
    st0 = restir.init_restir(w * h, "cpu")
    st1, img1 = restir.restir_di(scene, view0, cfg, st0, 3)
    st2, img2 = restir.restir_di(scene, view1, cfg, st1, 4, prev_view=view0)
    sst1, simg1 = pmesh.restir_di_sharded(scene, view0, cfg, st0, 3, mesh8)
    sst2, simg2 = pmesh.restir_di_sharded(scene, view1, cfg, sst1, 4, mesh8, prev_view=view0)
    _close(simg1, img1)
    _close(simg2, img2)
    for a, b in zip(sst2, st2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)
    assert float(sst2.m.max()) > float(sst1.m.max())
    _, img = restir.restir_di(scene, view0, cfg, st0, 7, spatial_taps=2)
    _, simg = pmesh.restir_di_sharded(scene, view0, cfg, st0, 7, mesh8, spatial_taps=2)
    a, b = img.numpy(), simg.numpy()
    assert np.isfinite(b).all()
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-9) < 0.15


def test_sharded_adaptive_bit_identical(cornell, mesh8):
    from stratum_tpu_torch.render import adaptive

    scene, c2w, fovy = cornell[True]
    w, h = 32, 16  # n = 512; L = 128 divides 8 devices
    view = _view(c2w, fovy, w, h)
    cfg = integrator.RenderConfig(width=w, height=h, max_bounces=2)
    img, st = adaptive.render_adaptive(scene, view, cfg, 3.0, pilot=2, frac=0.25, seed0=11)
    simg, sst = pmesh.render_adaptive_sharded(scene, view, cfg, 3.0, mesh8, pilot=2,
                                              frac=0.25, seed0=11)
    _close(simg, img)
    assert torch.equal(sst.count, st.count)


def test_session_with_mesh(cornell, mesh8):
    """``RenderSession(mesh=...)``: samples, the G-buffer and the denoiser
    sharded; two denoised frames equal the unsharded session's."""
    scene, c2w, fovy = cornell[True]
    w, h = 64, 32
    view = _view(c2w, fovy, w, h)
    cfg = integrator.RenderConfig(width=w, height=h, max_bounces=2)
    plain = session.RenderSession(scene, view, cfg, denoise=True)
    sharded = session.RenderSession(scene, view, cfg, denoise=True, mesh=mesh8)
    for _ in range(2):
        a, b = plain.frame(), sharded.frame()
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=1e-5)
    assert sharded.spp == 2
    np.testing.assert_allclose(sharded.step(2).numpy(), plain.step(2).numpy(), rtol=1e-4,
                               atol=1e-5)
