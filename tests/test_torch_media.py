"""Participating media in the port (render/medium.py and the integrator's
media branch, ROADMAP Queue 1 item 4) against the JAX reference.

Units on seeded numpy inputs: the density bricks ``build_media`` makes (and
the bridge carries), ``density_at``, ``hg_phase`` and ``sample_hg`` (within
1e-6), and delta-tracked free flight and ratio-tracked transmittance from
the same RNG state through the smoky Cornell box's plume (scatter slots
equal, t and weights within 1e-5 relative, the RNG words after the walk
equal). Render: ``smoky_cornell(sigma=0.05)`` through the port's own
flatten against the stored ``cornell_smoke`` golden (48x48, 8 spp, 3
bounces: tests/update_goldens.py:67-68) within test_torch_slice.py's
bounds (image mean 2 %, >= 97 % of pixels within 1e-3).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.core import rng as jrng
from stratum_tpu.render import medium as jmedium
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu_torch.render import camera, integrator
from stratum_tpu_torch.render import medium as pmedium
from stratum_tpu_torch.scene import bridge, builtin, flatten

torch.set_num_threads(2)

GOLDEN = Path(__file__).resolve().parent / "golden" / "cornell_smoke.npy"
MEAN_REL = 0.02
PIXEL_SHARE = 0.97


@pytest.fixture(scope="module")
def media():
    """The smoky Cornell box's media: the reference's (JAX) and the port's
    from its own flatten of its own builtin."""
    js, _ = jflatten.flatten(jbuiltin.smoky_cornell(sigma=0.05).root)
    ps, _ = flatten.flatten(builtin.smoky_cornell(sigma=0.05).root, device="cpu")
    return js, ps


def test_media_build_and_bridge_match_reference(media):
    js, ps = media
    bridged = bridge.scene_from_numpy(bridge.numpy_fields(js), "cpu")
    for scene in (ps, bridged):
        for f in ("density", "albedo", "g", "box_lo", "box_hi", "majorant"):
            np.testing.assert_array_equal(getattr(scene.media, f).numpy(),
                                          np.asarray(getattr(js.media, f)))
        assert scene.media.slots_used == 1
    vols = [dict(density=np.random.default_rng(0).random((5, 300, 7)), box_lo=np.zeros(3),
                 box_hi=np.ones(3), albedo=(0.5, 0.6, 0.7), g=-0.2)] * 2
    jm, pm = jmedium.build_media(vols), pmedium.build_media(vols)
    for f in ("density", "albedo", "g", "box_lo", "box_hi", "majorant"):
        np.testing.assert_array_equal(getattr(pm, f), np.asarray(getattr(jm, f)))
    assert pm.density.shape == (8, 128, 128, 128) and pm.slots_used == 2
    assert pmedium.empty_media().slots_used == 0


def _rays(n, seed):
    """Rays through and beside the plume's box [80, 475] x [0, 460] x [80, 475]."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([0, -50, 0], [555, 500, 555], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(10, 900, n).astype(np.float32)
    st = np.array(jrng.rng_init(np.arange(n, dtype=np.uint32), np.uint32(7), np.uint32(seed), 3))
    return o, d, t, st


def test_density_and_phase_match_reference(media):
    js, ps = media
    rng = np.random.default_rng(1)
    p = rng.uniform(50, 500, (4096, 3)).astype(np.float32)
    slot = rng.integers(0, 2, 4096).astype(np.int32)
    np.testing.assert_allclose(
        pmedium.density_at(ps.media, torch.from_numpy(slot), torch.from_numpy(p)).numpy(),
        np.asarray(jmedium.density_at(js.media, jnp.asarray(slot), jnp.asarray(p))), rtol=1e-6)
    np.testing.assert_allclose(
        pmedium.density_at(ps.media, 0, torch.from_numpy(p)).numpy(),
        np.asarray(jmedium.density_at(js.media, jnp.zeros(4096, jnp.int32), jnp.asarray(p))),
        rtol=1e-6)
    g = rng.uniform(-0.9, 0.9, 4096).astype(np.float32)
    g[::5] = 0.0  # the isotropic branch
    cos = rng.uniform(-1, 1, 4096).astype(np.float32)
    np.testing.assert_allclose(pmedium.hg_phase(torch.from_numpy(g), torch.from_numpy(cos)).numpy(),
                               np.asarray(jmedium.hg_phase(g, cos)), rtol=1e-6)
    wo = rng.normal(size=(4096, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    u1, u2 = rng.random((2, 4096), dtype=np.float32)
    pw, pp = pmedium.sample_hg(*(torch.from_numpy(x) for x in (g, wo, u1, u2)))
    jw, jp = jmedium.sample_hg(g, wo, u1, u2)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=1e-6)


def test_free_flight_and_transmittance_match_reference(media):
    js, ps = media
    o, d, t, st = _rays(4096, 2)
    pt, pslot, pw, pst = pmedium.sample_free_flight(
        ps.media, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t),
        torch.from_numpy(st.view(np.int32)))
    jt, jslot, jw, jst = jmedium.sample_free_flight(js.media, o, d, t, st)
    jt = np.asarray(jt)
    np.testing.assert_array_equal(pslot.numpy(), np.asarray(jslot))
    assert 0.05 < np.isfinite(jt).mean() < 0.95  # some lanes scatter, some pass
    np.testing.assert_array_equal(np.isfinite(pt.numpy()), np.isfinite(jt))
    fin = np.isfinite(jt)
    np.testing.assert_allclose(pt.numpy()[fin], jt[fin], rtol=1e-5)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-5)
    np.testing.assert_array_equal(pst.numpy().view(np.uint32), np.asarray(jst))
    ptr, pst = pmedium.transmittance(ps.media, torch.from_numpy(o), torch.from_numpy(d),
                                     torch.from_numpy(t), torch.from_numpy(st.view(np.int32)))
    jtr, jst = jmedium.transmittance(js.media, o, d, t, st)
    np.testing.assert_allclose(ptr.numpy(), np.asarray(jtr), rtol=1e-5, atol=1e-6)
    assert (np.asarray(jtr) < 1).mean() > 0.05
    np.testing.assert_array_equal(pst.numpy().view(np.uint32), np.asarray(jst))


def test_smoky_cornell_matches_golden():
    g = builtin.smoky_cornell(sigma=0.05)
    scene, _ = flatten.flatten(g.root, device="cpu")
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, 48, 48, device="cpu")
    cfg = integrator.RenderConfig(width=48, height=48, rr_depth=100, max_bounces=3)
    assert integrator.resolved_tracer(scene, cfg) == "mxu"
    img = integrator.render_path_progressive(scene, view, cfg, 8).numpy()
    ref = np.load(GOLDEN)
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert abs(img.mean() - ref.mean()) <= MEAN_REL * ref.mean(), (img.mean(), ref.mean())
    pix = np.all(np.abs(img - ref) <= 1e-3 * (1 + np.abs(ref)), axis=-1).mean()
    assert pix >= PIXEL_SHARE, pix
