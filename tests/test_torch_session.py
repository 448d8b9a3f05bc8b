"""The port's frame loop against the JAX reference (ROADMAP Queue 1 item 6):
``render/session.py``, ``render/debug.py`` with ``debug_path_edges``,
``render/flycamera.py`` and the animated ``flatten(time=, prev_time=)``.

Bit for bit: the animated Cornell box's flattened positions and
``instance_motion`` (a static scene's rows ``np.eye(3, 4)``); the fly
camera's matrices; ``_hash_colors``; a checkpoint written by the JAX
session and loaded by the port's, and the reverse (uniform and adaptive
state, so ``spp`` comes back an int and a float).

Renders on the Cornell box (bridged, ``"brute"`` in both packages,
Lambert, 2 bounces, 16x16) at the bounds of test_torch_slice.py (image
mean within 2 % relative, >= 97 % of pixels within 1e-3 x (1 + |ref|)):
``trace_path`` with ``debug_path_edges`` on the plain path, under
``wave_caps=(1, 0.5, 0.3)`` and with per-lane seeds; every mode of
``DEBUG_MODES`` (G-buffer views within 1e-5); ``RenderSession``
sequential, batched, with ``spp_lanes``, with ReSTIR, adaptive after a
pilot, and ``frame()`` with the denoiser over a camera move.

On the port alone: the ``path_length_N`` images for N = 1..max_bounces+2
sum to the full render (rtol 1e-4, as the reference's
test_path_length_views_sum_to_full); batched ``step(4)`` equals four
``step(1)`` (rtol 1e-5); ``set_view`` restarts the accumulation and keeps
the denoiser's history; a device mesh renders the sequential session's
samples (rtol 1e-5) and ``step_adaptive`` refuses it.
"""

import numpy as np
import pytest
import torch

from stratum_tpu.render import camera as jcamera
from stratum_tpu.render import debug as jdebug
from stratum_tpu.render import flycamera as jfly
from stratum_tpu.render import integrator as jintegrator
from stratum_tpu.render import session as jsession
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu.scene import graph as jgraph
from stratum_tpu_torch.render import camera, debug, flycamera, integrator, session
from stratum_tpu_torch.scene import bridge, builtin, flatten, graph

torch.set_num_threads(2)

MEAN_REL = 0.02
PIXEL_SHARE = 0.97
N = 16
CFG = dict(width=N, height=N, max_bounces=2, tracer="brute")


@pytest.fixture(scope="module")
def cornell():
    g = jbuiltin.cornell_box()
    js, _ = jflatten.flatten(g.root)
    node, cam = jflatten.find_camera(g.root)
    c2w = np.asarray(node.to_world())
    moved = c2w.copy()
    moved[:, 3] += (20.0, 0.0, 0.0)
    views = [(jcamera.make_view(m, cam.fovy, N, N), camera.make_view(m, cam.fovy, N, N,
                                                                      device="cpu"))
             for m in (c2w, moved)]
    return dict(js=js, ps=bridge.scene_from_numpy(bridge.numpy_fields(js), "cpu"),
                jv=views[0][0], pv=views[0][1], jv2=views[1][0], pv2=views[1][1])


def _agree(img, ref):
    img, ref = np.asarray(img), np.asarray(ref)
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert abs(img.mean() - ref.mean()) <= MEAN_REL * abs(ref.mean()) + 1e-7, (
        img.mean(), ref.mean())
    pix = np.all(np.abs(img - ref) <= 1e-3 * (1 + np.abs(ref)), axis=-1).mean()
    assert pix >= PIXEL_SHARE, pix


# -- animation, fly camera ---------------------------------------------------

def _animate(g, gmod):
    for n in g.root.descendants():
        if n.name == "tall_box":
            m0 = n.find(gmod.TransformComponent).matrix.copy()
            m1 = m0.copy()
            c, s = np.cos(np.radians(25.0)), np.sin(np.radians(25.0))
            m1[:, :3] = m0[:, :3] @ np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
            m1[:, 3] += (-100.0, 20.0, 30.0)
            n.make_component(gmod.AnimationComponent(
                times=np.asarray([0.0, 1.0], np.float32), matrices=np.stack([m0, m1])))
    return g


@pytest.mark.parametrize("times", [dict(), dict(time=0.5), dict(time=0.7, prev_time=0.25)])
def test_flatten_animated_matches_reference(times):
    js, jstats = jflatten.flatten(_animate(jbuiltin.cornell_box(), jgraph).root, **times)
    ps, pstats = flatten.flatten(_animate(builtin.cornell_box(), graph).root, device="cpu",
                                 **times)
    np.testing.assert_array_equal(ps.geo.positions.numpy(), np.asarray(js.geo.positions))
    np.testing.assert_array_equal(ps.instance_motion.numpy(), np.asarray(js.instance_motion))
    assert pstats.instance_names == jstats.instance_names
    moving = np.abs(ps.instance_motion.numpy() - np.eye(3, 4)).max(axis=(1, 2)) > 1e-3
    assert moving.sum() == (1 if "prev_time" in times else 0)


def test_flycamera_matches_reference():
    jg, pg = jgraph.NodeGraph(), graph.NodeGraph()
    jc = jfly.FlyCamera(node=jg.root.add_child("cam"), speed=3.0)
    pc = flycamera.FlyCamera(node=pg.root.add_child("cam"), speed=3.0)
    script = [dict(dt=0.1, keys=["w"]), dict(dt=0.2, keys=["a", "e"], mouse_delta=(30, -12)),
              dict(dt=0.0, scroll=2.0), dict(dt=0.5, keys=["s", "d", "q"],
                                             mouse_delta=(-5e5, 9e5)),
              dict(dt=0.3, mouse_delta=(40, 40), rotating=False)]
    for step in script:
        np.testing.assert_array_equal(pc.update(**step), jc.update(**step))
    np.testing.assert_array_equal(pc.node.find(graph.TransformComponent).matrix,
                                  jc.node.find(jgraph.TransformComponent).matrix)
    assert (pc.yaw, pc.pitch, pc.speed) == (jc.yaw, jc.pitch, jc.speed)


# -- debug views -------------------------------------------------------------

def test_hash_colors_match_reference():
    import jax.numpy as jnp

    ids = np.concatenate([np.arange(4096), [2**20 + 7, 2**31 - 1]]).astype(np.int32)
    np.testing.assert_array_equal(debug._hash_colors(torch.from_numpy(ids)).numpy(),
                                  np.asarray(jdebug._hash_colors(jnp.asarray(ids))))


@pytest.mark.parametrize("mode", [m.replace("_N", "_2") for m in jdebug.DEBUG_MODES])
def test_render_debug_matches_reference(cornell, mode):
    assert debug.DEBUG_MODES == jdebug.DEBUG_MODES
    j = np.asarray(jdebug.render_debug(cornell["js"], cornell["jv"],
                                       jintegrator.RenderConfig(**CFG), mode, 3, 2))
    p = debug.render_debug(cornell["ps"], cornell["pv"], integrator.RenderConfig(**CFG),
                           mode, 3, 2)
    assert p.shape == (N, N, 3) and p.device.type == "cpu"
    if mode in ("path_length_2", "reservoir_w"):
        _agree(p, j)
        assert j.max() > 0
    elif mode == "instance":
        np.testing.assert_array_equal(p.numpy(), j)
    else:
        np.testing.assert_allclose(p.numpy(), j, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("path", ["plain", "wave_caps", "lanes"])
@pytest.mark.parametrize("edges", [2, 3])
def test_debug_path_edges_matches_reference(cornell, path, edges):
    cfg = dict(CFG, debug_path_edges=edges)
    if path == "wave_caps":
        cfg["wave_caps"] = (1.0, 0.5, 0.3)
    if path == "lanes":
        jimg, jn = jintegrator.render_path_lanes(cornell["js"], cornell["jv"],
                                                 jintegrator.RenderConfig(**cfg), 2, 5)
        pimg, pn = integrator.render_path_lanes(cornell["ps"], cornell["pv"],
                                                integrator.RenderConfig(**cfg), 2, 5)
    else:
        jimg, jn = jintegrator.render_path_with_counts(cornell["js"], cornell["jv"],
                                                       jintegrator.RenderConfig(**cfg), 5)
        pimg, pn = integrator.render_path_with_counts(cornell["ps"], cornell["pv"],
                                                      integrator.RenderConfig(**cfg), 5)
    _agree(pimg, jimg)
    assert abs(int(pn) - int(jn)) <= 0.01 * int(jn)


def test_path_length_views_sum_to_full(cornell):
    """The per-edge-count images sum to the full render: the masks only
    drop terms and leave every draw (and n_rays' other bounces) alone."""
    cfg = integrator.RenderConfig(**CFG)
    full = integrator.render_path_progressive(cornell["ps"], cornell["pv"], cfg, 4)
    parts = [debug.render_debug(cornell["ps"], cornell["pv"], cfg, f"path_length_{e}", spp=4)
             for e in range(1, cfg.max_bounces + 3)]
    assert all(float(x.amax()) > 0 for x in parts[1:])
    np.testing.assert_allclose(sum(parts).numpy(), full.numpy(), rtol=1e-4, atol=1e-5)


# -- the session -------------------------------------------------------------

def _drive(mod, scene, view, view2, cfg, kind):
    if kind == "sequential":
        s = mod.RenderSession(scene, view, cfg, seed0=3)
        s.step(1)
        return s.step(1)
    if kind == "batched":
        return mod.RenderSession(scene, view, cfg, seed0=3).step(3)
    if kind == "lanes":
        return mod.RenderSession(scene, view, cfg, spp_lanes=2, seed0=3).step(4)
    if kind == "restir":
        s = mod.RenderSession(scene, view, cfg, use_restir=True, restir_candidates=2,
                              restir_spatial_taps=1, seed0=3)
        s.step(1)
        return s.step(1)
    if kind == "adaptive":
        s = mod.RenderSession(scene, view, cfg, seed0=3)
        s.step(2)
        return s.step_adaptive(2)
    s = mod.RenderSession(scene, view, cfg, denoise=True, seed0=3)
    s.frame()
    s.set_view(view2)
    return s.frame()


@pytest.mark.parametrize("kind", ["sequential", "batched", "lanes", "restir", "adaptive",
                                  "denoised_frame"])
def test_session_matches_reference(cornell, kind):
    c = cornell
    j = _drive(jsession, c["js"], c["jv"], c["jv2"], jintegrator.RenderConfig(**CFG), kind)
    p = _drive(session, c["ps"], c["pv"], c["pv2"], integrator.RenderConfig(**CFG), kind)
    _agree(p, j)


def test_batched_step_equals_sequential(cornell):
    cfg = integrator.RenderConfig(**CFG)
    a = session.RenderSession(cornell["ps"], cornell["pv"], cfg)
    img_a = a.step(4)
    b = session.RenderSession(cornell["ps"], cornell["pv"], cfg)
    for _ in range(4):
        img_b = b.step(1)
    np.testing.assert_allclose(img_a.numpy(), img_b.numpy(), rtol=1e-5, atol=1e-7)
    assert a.spp == b.spp == 4 and a._seeds_used == b._seeds_used == 4


def test_set_view_resets_accumulation_keeps_history(cornell):
    s = session.RenderSession(cornell["ps"], cornell["pv"], integrator.RenderConfig(**CFG),
                              denoise=True)
    s.frame()
    s.frame()
    hist = s.denoise_state.history.clone()
    assert float(hist.max()) == 2.0
    s.set_view(cornell["pv2"])
    assert s.spp == 0 and float(s.accum.abs().max()) == 0.0 and s._gbuffer is None
    assert s.prev_view is cornell["pv"]
    assert torch.equal(s.denoise_state.history, hist)
    s.frame()
    # reprojected pixels carry their history on
    assert float(s.denoise_state.history.max()) == 3.0
    assert s._seeds_used == 3


def _checkpoint_state(s):
    return dict(accum=np.asarray(s.accum), spp=s.spp, seed0=s.seed0, used=s._seeds_used,
                count=None if s.sample_count is None else np.asarray(s.sample_count))


@pytest.mark.parametrize("adaptive", [False, True])
def test_checkpoint_crosses_packages(cornell, tmp_path, adaptive):
    c = cornell
    jcfg, pcfg = jintegrator.RenderConfig(**CFG), integrator.RenderConfig(**CFG)
    js = jsession.RenderSession(c["js"], c["jv"], jcfg, seed0=7)
    js.step(2)
    if adaptive:
        js.step_adaptive(1)
    js.save_checkpoint(tmp_path / "j.npz")
    ps = session.RenderSession(c["ps"], c["pv"], pcfg)
    ps.load_checkpoint(tmp_path / "j.npz")
    a, b = _checkpoint_state(ps), _checkpoint_state(js)
    np.testing.assert_array_equal(a.pop("accum"), b.pop("accum"))
    ca, cb = a.pop("count"), b.pop("count")
    assert (ca is None) == (cb is None) == (not adaptive)
    if adaptive:
        np.testing.assert_array_equal(ca, cb)
        np.testing.assert_array_equal(ps._accum_sq.numpy(), np.asarray(js._accum_sq))
    assert a == b and type(ps.spp) is type(js.spp)
    # the port's checkpoint back into the reference
    ps.step(1)
    ps.save_checkpoint(tmp_path / "p")
    js2 = jsession.RenderSession(c["js"], c["jv"], jcfg)
    js2.load_checkpoint(tmp_path / "p")
    a, b = _checkpoint_state(ps), _checkpoint_state(js2)
    np.testing.assert_array_equal(a.pop("accum"), b.pop("accum"))
    ca, cb = a.pop("count"), b.pop("count")
    if adaptive:
        np.testing.assert_array_equal(ca, cb)
    assert a == b
    # resuming continues the seed sequence of an uninterrupted session
    whole = session.RenderSession(c["ps"], c["pv"], pcfg, seed0=7)
    whole.step(2)
    if adaptive:
        whole.step_adaptive(1)
    whole.step(1)
    np.testing.assert_allclose(ps.radiance().numpy(), whole.radiance().numpy(), rtol=1e-5,
                               atol=1e-7)


def test_session_mesh_raises(cornell):
    """A device mesh is accepted and renders (it raised before the port
    had one); ``step_adaptive`` refuses it, as the reference's session
    does, and refuses a session without a pilot."""
    from stratum_tpu_torch.parallel import mesh as pmesh

    cfg = integrator.RenderConfig(**CFG)
    m = session.RenderSession(cornell["ps"], cornell["pv"], cfg,
                              mesh=pmesh.make_mesh(["cpu"] * 4))
    img = m.step(2)
    ref = session.RenderSession(cornell["ps"], cornell["pv"], cfg)
    for _ in range(2):
        want = ref.step(1)
    np.testing.assert_allclose(img.numpy(), want.numpy(), rtol=1e-5, atol=1e-7)
    with pytest.raises(RuntimeError, match="device mesh"):
        m.step_adaptive(1)
    s = session.RenderSession(cornell["ps"], cornell["pv"], integrator.RenderConfig(**CFG))
    with pytest.raises(RuntimeError, match="pilot"):
        s.step_adaptive(1)
    assert s.tonemapped().shape == (N, N, 3)
