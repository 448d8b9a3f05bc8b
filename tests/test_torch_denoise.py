"""The port's G-buffer, pick and SVGF denoiser against the JAX reference
(ROADMAP Queue 1 item 6): ``render/aov.py`` and ``render/denoise.py``.

Scenes are the reference's, flattened by JAX and carried across
(``bridge.scene_from_numpy``): the Cornell box seen through a lens 1.25
times wider (so some pixels miss), the same box with an analytic sphere, and the
box with its tall block animated (``flatten(time=0.5, prev_time=0.4)``).
The reference traces with ``"brute"``; the port with ``"brute"`` and the
block tracer (``"pallas"``, its plain version on the CPU), whose hits carry
the fused slot payload (sphere scenes: triangle ids and ``tri_payload``
rows).

Held: the G-buffer's ``instance`` and miss masks bit for bit; albedo,
normal and ``prev_uv`` within 1e-5, depth within 1e-5 relative (2e-4 on
the sphere scene: the sphere's uv goes through atan2 / acos, whose f32
results differ between XLA and torch); static camera, a moved camera and
the animated block (whose pixels alone move in ``prev_uv``); ``pick`` on
24 pixels at the same bounds.

The denoiser runs on the same inputs in both packages: a numpy-seeded
noisy radiance and the reference's G-buffers. ``_filter_taps`` bit for
bit; ``estimate_variance`` within 1e-6; ``temporal_accumulate`` over
three frames, each package's state fed back (1e-5 relative); ``_shift``
exact; ``atrous_filter`` for every filter type and with ``history_tap``,
``denoise`` and its three debug views within 1e-5 relative + 1e-6
(``DEN_TOL``). On this CPU the two agree to 1e-6 relative, the filter's
``max(n.n', 0) ** 128`` included; the bound leaves room for f32 ``exp`` /
``pow`` ulps of other builds, which 5 iterations carry into the weights.
The card's denoiser is held to the CPU port at twice ``DEN_TOL``
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 16).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.render import aov as jaov
from stratum_tpu.render import camera as jcamera
from stratum_tpu.render import denoise as jdenoise
from stratum_tpu.render import integrator as jintegrator
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu.scene import graph as jgraph
from stratum_tpu_torch.render import aov, camera, denoise, integrator
from stratum_tpu_torch.scene import bridge

torch.set_num_threads(2)

W = H = 32
DEN_TOL = dict(rtol=1e-5, atol=1e-6)


def _animate_tall_box(g):
    """Key the tall block's transform: it slides 100 units in -x and turns
    10 degrees over one second."""
    for n in g.root.descendants():
        if n.name == "tall_box":
            m0 = n.find(jgraph.TransformComponent).matrix.copy()
            m1 = m0.copy()
            c, s = np.cos(np.radians(10.0)), np.sin(np.radians(10.0))
            m1[:, :3] = m0[:, :3] @ np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
            m1[:, 3] += (-100.0, 0.0, 0.0)
            n.make_component(jgraph.AnimationComponent(
                times=np.asarray([0.0, 1.0], np.float32), matrices=np.stack([m0, m1])))
    return g


def _case(g, fov_scale=1.0, **flat_kw):
    js, stats = jflatten.flatten(g.root, **flat_kw)
    node, cam = jflatten.find_camera(g.root)
    c2w = np.asarray(node.to_world())
    moved = c2w.copy()
    moved[:, 3] += (25.0, 10.0, 0.0)
    fovy = cam.fovy * fov_scale
    views = [(jcamera.make_view(m, fovy, W, H), camera.make_view(m, fovy, W, H, device="cpu"))
             for m in (c2w, moved)]
    return dict(js=js, ps=bridge.scene_from_numpy(bridge.numpy_fields(js), "cpu"),
                views=views, names=stats.instance_names)


@pytest.fixture(scope="module")
def cases():
    sph = jbuiltin.cornell_box()
    from stratum_tpu.scene.material import Material

    node = sph.root.add_child("ball")
    m = np.eye(3, 4, dtype=np.float32)
    m[:, 3] = (400.0, 90.0, 150.0)
    node.make_component(jgraph.TransformComponent(matrix=m))
    node.make_component(jgraph.SpherePrimitive(
        radius=90.0, material=Material(base_color=np.asarray([0.2, 0.5, 0.9], np.float32)),
        analytic=True))
    return {
        "wide": _case(jbuiltin.cornell_box(), fov_scale=1.25),
        "spheres": _case(sph),
        "animated": _case(_animate_tall_box(jbuiltin.cornell_box()), time=0.5, prev_time=0.4),
    }


def _cfg(mod, tracer):
    return mod.RenderConfig(width=W, height=H, max_bounces=3, tracer=tracer)


def _jgbuf(case, cur, prev):
    return jaov.render_gbuffer(case["js"], case["views"][cur][0], case["views"][prev][0],
                               _cfg(jintegrator, "brute"))


def _to_port(gb):
    return aov.GBuffer(*(torch.from_numpy(np.array(x)) for x in gb))


def _gbuf_agree(p, j, tol):
    p = [x.numpy() for x in p]
    j = [np.asarray(x) for x in j]
    np.testing.assert_array_equal(p[3], j[3])  # instance
    miss = j[3] < 0
    np.testing.assert_array_equal(~np.isfinite(p[2]), miss)
    np.testing.assert_allclose(p[2][~miss], j[2][~miss], rtol=tol)
    for k in (0, 1, 4):  # albedo, normal, prev_uv
        np.testing.assert_allclose(p[k], j[k], atol=tol, rtol=0)
    return miss


@pytest.mark.parametrize("name", ["wide", "spheres", "animated"])
@pytest.mark.parametrize("tracer", ["brute", "pallas"])
@pytest.mark.parametrize("move", [(0, 0), (1, 0)], ids=["static", "moved"])
def test_gbuffer_matches_reference(cases, name, tracer, move):
    case = cases[name]
    cur, prev = move
    j = _jgbuf(case, cur, prev)
    p = aov.render_gbuffer(case["ps"], case["views"][cur][1], case["views"][prev][1],
                           _cfg(integrator, tracer))
    assert p.albedo.shape == (H, W, 3) and p.instance.dtype == torch.int32
    miss = _gbuf_agree(p, j, 2e-4 if name == "spheres" else 1e-5)
    if cur == 0:
        assert miss.any() == (name == "wide")


def test_gbuffer_object_motion(cases):
    """With a static camera only the animated block's pixels move in
    prev_uv; a static scene's motion rows are identity."""
    case = cases["animated"]
    p = aov.render_gbuffer(case["ps"], case["views"][0][1], case["views"][0][1],
                           _cfg(integrator, "brute"))
    box = p.instance.numpy() == case["names"].index("tall_box")
    centre = np.stack(np.meshgrid((np.arange(W) + 0.5) / W, (np.arange(H) + 0.5) / H), -1)
    shift = np.abs(p.prev_uv.numpy() - centre).max(-1)
    assert box.sum() > 20
    assert shift[box].min() > 1e-3 and shift[~box].max() < 1e-4
    np.testing.assert_array_equal(cases["wide"]["ps"].instance_motion.numpy(),
                                  np.tile(np.eye(3, 4, dtype=np.float32), (8, 1, 1)))


@pytest.mark.parametrize("name", ["wide", "spheres"])
@pytest.mark.parametrize("tracer", ["brute", "pallas"])
def test_pick_matches_reference(cases, name, tracer):
    case = cases[name]
    rng = np.random.default_rng(11)
    px = rng.integers(0, W, 24)
    py = rng.integers(0, H, 24)
    px[:2], py[:2] = (0, W - 1), (0, H - 1)  # corners: misses on the wide view
    j = jaov.pick(case["js"], case["views"][0][0], _cfg(jintegrator, "brute"), px, py)
    p = aov.pick(case["ps"], case["views"][0][1], _cfg(integrator, tracer), px, py)
    for f in ("instance", "prim", "material"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f)), f)
    hit = np.asarray(j.instance) >= 0
    np.testing.assert_allclose(p.depth.numpy()[hit], np.asarray(j.depth)[hit], rtol=1e-5)
    # positions within 1e-5 of the box's 552-unit extent
    np.testing.assert_allclose(p.position.numpy(), np.asarray(j.position), atol=5.5e-3)
    for f in ("uv", "normal"):
        np.testing.assert_allclose(getattr(p, f).numpy(), np.asarray(getattr(j, f)),
                                   atol=2e-4 if name == "spheres" else 1e-5, err_msg=f)
    pint = aov.pick(case["ps"], case["views"][0][1], _cfg(integrator, tracer), 5, 7)
    assert pint.depth.shape == (1,)


# -- the denoiser ------------------------------------------------------------

@pytest.fixture(scope="module")
def frames(cases):
    """Three frames of the wide Cornell view: the JAX G-buffers (frame 2
    after a camera move) and numpy-seeded noisy radiance."""
    case = cases["wide"]
    gbs = [_jgbuf(case, 0, 0), _jgbuf(case, 0, 0), _jgbuf(case, 1, 0)]
    rng = np.random.default_rng(21)
    rads = []
    for gb in gbs:
        base = np.asarray(gb.albedo) * 0.6
        noise = rng.exponential(1.0, (H, W, 3)).astype(np.float32)
        rads.append((base * noise * (rng.random((H, W, 1)) < 0.7)).astype(np.float32))
    return gbs, rads


def _jstate():
    return jdenoise.init_state(H, W)


def _close(p, j, **tol):
    np.testing.assert_allclose(p.numpy(), np.asarray(j), **(tol or DEN_TOL))


@pytest.mark.parametrize("ft", ["atrous", "box3", "box5", "subsampled",
                                "box3_subsampled", "box5_subsampled"])
def test_filter_taps_match_reference(ft):
    for it in range(5):
        assert denoise._filter_taps(ft, it) == jdenoise._filter_taps(ft, it)


def test_shift_is_edge_padded_copy():
    img = np.random.default_rng(3).random((7, 9, 2)).astype(np.float32)
    for dy in (-4, -1, 0, 2, 8):
        for dx in (-9, -2, 0, 1, 5):
            np.testing.assert_array_equal(denoise._shift(torch.from_numpy(img), dy, dx).numpy(),
                                          np.asarray(jdenoise._shift(jnp.asarray(img), dy, dx)))


def test_estimate_variance_matches_reference(frames):
    rng = np.random.default_rng(5)
    lum = rng.random((H, W)).astype(np.float32)
    mom = np.stack([lum, lum * lum + rng.random((H, W)).astype(np.float32)], -1)
    hist = rng.integers(1, 8, (H, W)).astype(np.float32)
    cfg = jdenoise.DenoiseConfig()
    j = jdenoise.estimate_variance(jnp.asarray(mom), jnp.asarray(hist), jnp.asarray(lum), cfg)
    p = denoise.estimate_variance(torch.from_numpy(mom), torch.from_numpy(hist),
                                  torch.from_numpy(lum), denoise.DenoiseConfig())
    _close(p, j, rtol=1e-6, atol=1e-7)


def test_temporal_accumulate_three_frames(frames):
    gbs, rads = frames
    js, ps = _jstate(), denoise.init_state(H, W, "cpu")
    cfg_j, cfg_p = jdenoise.DenoiseConfig(), denoise.DenoiseConfig()
    for gb, rad in zip(gbs, rads):
        js, jc, jv, jaux = jdenoise.temporal_accumulate(js, jnp.asarray(rad), gb, cfg_j,
                                                        with_aux=True)
        ps, pc, pv, paux = denoise.temporal_accumulate(ps, torch.from_numpy(rad), _to_port(gb),
                                                       cfg_p, with_aux=True)
        _close(pc, jc, rtol=1e-5, atol=1e-7)
        _close(pv, jv, rtol=1e-5, atol=1e-7)
        for k in ("weight_sum", "history"):
            _close(paux[k], jaux[k], rtol=1e-6, atol=1e-7)
        for a, b in zip(ps, js):
            _close(a, b, rtol=1e-5, atol=1e-7)
    # the moved frame reprojects most of its pixels
    assert (paux["history"].numpy() > 2.5).mean() > 0.5


@pytest.mark.parametrize("ft", ["atrous", "box3", "box5", "subsampled",
                                "box3_subsampled", "box5_subsampled"])
@pytest.mark.parametrize("tap", [0, 2])
def test_atrous_filter_matches_reference(frames, ft, tap):
    gbs, rads = frames
    gb = gbs[2]
    rng = np.random.default_rng(9)
    color = rads[2] + 0.01
    var = rng.random((H, W)).astype(np.float32) * 0.5
    jc = jdenoise.DenoiseConfig(filter_type=ft, history_tap=tap)
    pc = denoise.DenoiseConfig(filter_type=ft, history_tap=tap)
    jf, jt = jdenoise.atrous_filter(jnp.asarray(color), jnp.asarray(var), gb, jc)
    pf, pt = denoise.atrous_filter(torch.from_numpy(color), torch.from_numpy(var),
                                   _to_port(gb), pc)
    _close(pf, jf)
    assert (pt is None) == (jt is None) == (tap == 0)
    if tap:
        _close(pt, jt)


@pytest.mark.parametrize("debug", ["none", "sample_count", "variance", "weight_sum"])
def test_denoise_matches_reference(frames, debug):
    gbs, rads = frames
    js, ps = _jstate(), denoise.init_state(H, W, "cpu")
    cfg_j = jdenoise.DenoiseConfig(debug_mode=debug, history_tap=1)
    cfg_p = denoise.DenoiseConfig(debug_mode=debug, history_tap=1)
    for gb, rad in zip(gbs, rads):
        js, jout = jdenoise.denoise(js, jnp.asarray(rad), gb, cfg_j)
        ps, pout = denoise.denoise(ps, torch.from_numpy(rad), _to_port(gb), cfg_p)
        _close(pout, jout)
        _close(ps.color, js.color)
    assert pout.shape == (H, W, 3) and torch.isfinite(pout).all()


def test_denoise_reduces_noise(frames):
    """The filtered frame is smoother than its input on the foreground."""
    gbs, rads = frames
    _, out = denoise.denoise(denoise.init_state(H, W, "cpu"), torch.from_numpy(rads[0]),
                             _to_port(gbs[0]))
    fg = np.isfinite(np.asarray(gbs[0].depth))

    def rough(img):
        return np.abs(np.diff(img, axis=1))[fg[:, 1:]].mean()

    assert rough(out.numpy()) < 0.5 * rough(rads[0])


def test_init_state_device_and_types():
    s = denoise.init_state(4, 6, "cpu")
    j = jdenoise.init_state(4, 6)
    for a, b in zip(s, j):
        assert tuple(a.shape) == b.shape and str(a.dtype).split(".")[1] == str(b.dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert dataclasses.asdict(denoise.DenoiseConfig()) == dataclasses.asdict(
        jdenoise.DenoiseConfig())
