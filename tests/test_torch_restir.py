"""ReSTIR DI and the hash grid of the port (render/restir.py,
ops/hashgrid.py; ROADMAP Queue 1 item 5) against the JAX reference, and the
reference's estimator checks on the port alone.

The hash grid bit for bit: ``_cell_key`` (cells on both sides of the
origin, keys past 2^31), ``build_hashgrid``'s sorted keys and order (the
unsigned order of the keys; a stable sort) and ``query``'s ids and valid
flags; ``cell_size_for`` within 1e-6 relative.

ReSTIR against the reference, on the Cornell box (bridged) at 12x12 on the
brute-force tracer, two frames each with the state fed back: without
``prev_view``, with ``prev_view`` (the camera moved between the frames),
with ``spatial_taps=2`` and with ``hash_jitter``: the direct image (mean
within 1e-3 relative, >= 97 % of pixels within 1e-3 x (1 + |ref|)) and
the packed state (>= 99 % of rows within 1e-4 relative); the ``"pallas"``
route against ``"brute"`` on the tiny atrium within the image bounds. On
the port alone (tests/test_restir.py's bound and size): 24 frames against
``render_direct_progressive`` at 96 spp (6 %), and ``restir_di_jit`` =
``restir_di``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.ops import hashgrid as jhg
from stratum_tpu.render import camera as jcamera
from stratum_tpu.render import integrator as jintegrator
from stratum_tpu.render import restir as jrestir
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu_torch.ops import hashgrid
from stratum_tpu_torch.render import camera, integrator, restir
from stratum_tpu_torch.scene import bridge, builtin, flatten

torch.set_num_threads(2)

W = H = 12
CFG = dict(width=W, height=H, tracer="brute")
MEAN_REL = 1e-3
PIXEL_SHARE = 0.97
ROW_SHARE = 0.99


@pytest.fixture(scope="module")
def case():
    g = jbuiltin.cornell_box()
    js, _ = jflatten.flatten(g.root)
    node, cam = jflatten.find_camera(g.root)
    c2w = np.asarray(node.to_world())
    moved = c2w.copy()
    moved[:, 3] += np.asarray([6.0, -4.0, 10.0], np.float32)
    return dict(
        js=js, ps=bridge.scene_from_numpy(bridge.numpy_fields(js), "cpu"),
        jviews=[jcamera.make_view(m, cam.fovy, W, H) for m in (c2w, moved)],
        pviews=[camera.make_view(m, cam.fovy, W, H, device="cpu") for m in (c2w, moved)],
    )


def _points(seed, n=600):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)) * 7).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_hashgrid_matches_reference(seed):
    """Cell keys, the grid's order and the queries, bit for bit, with the
    origin inside the cloud (negative cell coordinates) and at its minimum."""
    pts = _points(seed)
    qry = np.concatenate([pts[::3], _points(seed + 10, 100)])
    origin = np.asarray([0.5, -1.0, 2.0], np.float32)
    keys = hashgrid._cell_key(torch.from_numpy(pts), torch.from_numpy(origin), 1.5)
    jkeys = np.asarray(jhg._cell_key(jnp.asarray(pts), jnp.asarray(origin), 1.5))
    np.testing.assert_array_equal(keys.numpy(), jkeys.astype(np.int64))
    assert (jkeys >= 2**31).any() and (jkeys < 2**31).any()
    for org in (origin, None):
        jg = jhg.build_hashgrid(jnp.asarray(pts), 1.5,
                                None if org is None else jnp.asarray(org))
        pg = hashgrid.build_hashgrid(torch.from_numpy(pts), 1.5,
                                     None if org is None else torch.from_numpy(org))
        np.testing.assert_array_equal(pg.sorted_keys.numpy(),
                                      np.asarray(jg.sorted_keys).astype(np.int64))
        np.testing.assert_array_equal(pg.order.numpy(), np.asarray(jg.order))
        for r in (4, 8):
            jids, jvalid = jhg.query(jg, jnp.asarray(qry), max_results=r)
            pids, pvalid = hashgrid.query(pg, torch.from_numpy(qry), max_results=r)
            np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
            np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    cam = np.asarray([1.0, 2.0, -30.0], np.float32)
    np.testing.assert_allclose(
        float(hashgrid.cell_size_for(torch.from_numpy(cam), torch.from_numpy(pts), 2e-3)),
        float(jhg.cell_size_for(jnp.asarray(cam), jnp.asarray(pts), 2e-3)), rtol=1e-6)


def test_hashgrid_roundtrip():
    """Points find themselves in their own cell (tests/test_anim_hashgrid.py:47-66)."""
    pts = torch.from_numpy(np.random.default_rng(1234).random((500, 3)).astype(np.float32) * 10)
    grid = hashgrid.build_hashgrid(pts, cell_size=1.0)
    ids, valid = hashgrid.query(grid, pts, max_results=16)
    found = [(ids[i][valid[i]] == i).any() for i in range(500)]
    assert np.mean(found) > 0.99
    assert bool(((ids >= 0) & (ids < 500))[valid].all())


def _close_image(img, ref):
    img, ref = np.asarray(img), np.asarray(ref)
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert abs(img.mean() - ref.mean()) <= MEAN_REL * abs(ref.mean()), (img.mean(), ref.mean())
    pix = np.all(np.abs(img - ref) <= 1e-3 * (1 + np.abs(ref)), axis=-1).mean()
    assert pix >= PIXEL_SHARE, pix


@pytest.mark.parametrize("mode", ["temporal", "prev_view", "spatial", "jitter"])
def test_restir_di_matches_reference(case, mode):
    """Two frames, the first's state fed to the second: each frame's direct
    image and the state it returns."""
    kw = dict(candidates=4)
    if mode == "spatial":
        kw.update(spatial_taps=2)
    if mode == "jitter":
        kw.update(spatial_taps=2, hash_jitter=True)
    jcfg, pcfg = jintegrator.RenderConfig(**CFG), integrator.RenderConfig(**CFG)
    jstate = jrestir.init_restir(W * H)
    pstate = restir.init_restir(W * H, device="cpu")
    for frame in (0, 1):
        v = 1 if mode == "prev_view" and frame == 1 else 0
        prev = dict(prev_view=case["jviews"][0]) if mode == "prev_view" and frame else {}
        jstate, jimg = jrestir.restir_di(case["js"], case["jviews"][v], jcfg, jstate, frame + 7,
                                         **kw, **prev)
        prev = dict(prev_view=case["pviews"][0]) if mode == "prev_view" and frame else {}
        pstate, pimg = restir.restir_di(case["ps"], case["pviews"][v], pcfg, pstate, frame + 7,
                                        **kw, **prev)
        _close_image(pimg.numpy(), np.asarray(jimg))
        got = restir._pack_state(pstate).numpy()
        want = np.asarray(jrestir._pack_state(jstate))
        assert np.isfinite(got).all()
        ok = np.all(np.abs(got - want) <= 1e-4 * (1 + np.abs(want)), axis=-1).mean()
        assert ok >= ROW_SHARE, (frame, ok)
    assert float(pstate.m.max()) > 4  # history merged in


def test_pallas_route_matches_brute():
    """On the tiny atrium the block tracer's route (the plain version on
    the CPU) against the brute-force tracer: the same two frames."""
    g = builtin.atrium(columns=1, stacks=6, slices=12)
    scene, _ = flatten.flatten(g.root, device="cpu")
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, 16, 16, device="cpu")
    imgs = []
    for tracer in ("pallas", "brute"):
        cfg = integrator.RenderConfig(width=16, height=16, tracer=tracer)
        state = restir.init_restir(256, device="cpu")
        for frame in range(2):
            state, img = restir.restir_di(scene, view, cfg, state, frame, spatial_taps=2)
        imgs.append(img.numpy())
    _close_image(*imgs)


def test_pack_state_roundtrip():
    """_pack_state / _unpack_state: [N, 16] rows and back, the reference's
    columns."""
    rng = np.random.default_rng(3)
    n = 32
    f = lambda *s: rng.random((n,) + s).astype(np.float32)  # noqa: E731
    vals = (f(3), f(3), f(3), rng.random(n) < 0.5, f(), f(), f())
    p = restir._pack_state(restir.RestirState(*map(torch.from_numpy, vals)))
    j = jrestir._pack_state(jrestir.RestirState(*map(jnp.asarray, vals)))
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    for a, b in zip(restir._unpack_state(p), vals):
        np.testing.assert_array_equal(a.numpy(), b)


def test_restir_matches_direct():
    """24 frames of ReSTIR against 96 spp of direct lighting away from the
    emitter (tests/test_restir.py:22-37), and the reference's jit name."""
    g = builtin.cornell_box()
    scene, _ = flatten.flatten(g.root, device="cpu")
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, 32, 32, device="cpu")
    cfg = integrator.RenderConfig(width=32, height=32)
    ref = integrator.render_direct_progressive(scene, view, cfg, 96).numpy()
    state = restir.init_restir(32 * 32, device="cpu")
    acc = 0.0
    for s in range(24):
        state, img = restir.restir_di_jit(scene, view, cfg, state, s)
        acc = acc + img.numpy()
    mean = acc / 24
    mask = ref.max(axis=-1) < 2.0
    assert mean[mask].mean() == pytest.approx(ref[mask].mean(), rel=0.06)
    s2, img2 = restir.restir_di(scene, view, cfg, state, 3, spatial_taps=1)
    s3, img3 = restir.restir_di_jit(scene, view, cfg, state, 3, spatial_taps=1)
    assert torch.equal(img2, img3) and torch.equal(s2.m, s3.m)
