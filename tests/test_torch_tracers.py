"""The packet tracer, the LBVH and the null tracer of the port
(stratum_tpu_torch/ops/packet.py, ops/bvh.py; ``tracer="packet"``,
``"bvh"``, ``"null"`` in render/integrator.py) against the JAX reference
and the brute-force oracle, on rays and scenes made from a seed.

The port's scene is the reference's, bridged (the same triangles, SAH fat
leaves and LBVH), so traversal is compared on identical structures.

Bounds. ``build_bvh``: order, boxes, links and corners bit for bit. Hits:
the same triangle as the reference and as ``intersect_brute_force`` on
every non-degenerate hit (barycentrics more than 1e-4 inside), t within
2^-12 relative; the packet tracer's products run in another summation
order than Moller-Trumbore's, so against brute force a tie or a hit within
1e-4 of an edge may go the other way: >= 99.5 % of rays agree. Occlusion
flags: equal to the reference's on >= 99.9 % of rays and to brute force's
on >= 99.5 %. Renders: Cornell ``render_direct`` with ``bvh`` equal to
``brute`` within rtol 1e-5 / atol 1e-6 and with ``packet`` on all but
0.5 % of pixels (the reference's own tests/test_bvh.py:66 and
tests/test_packet.py:46); path renders against the reference with the same
tracer within test_torch_slice.py's bounds (mean 2 %, >= 97 % of pixels
within 1e-3, n_rays 1 %).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.ops import bvh as jbvh
from stratum_tpu.ops import packet as jpacket
from stratum_tpu.render import camera as jcamera
from stratum_tpu.render import integrator as jintegrator
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu_torch.ops import bvh, packet
from stratum_tpu_torch.ops.intersect import intersect_brute_force, occluded_brute_force
from stratum_tpu_torch.render import camera, integrator
from stratum_tpu_torch.scene import bridge, builtin, flatten

torch.set_num_threads(2)

T_REL = 2.0 ** -12
EDGE = 1e-4
AGREE_REF = 0.999
AGREE_BRUTE = 0.995
MEAN_REL = 0.02
PIXEL_SHARE = 0.97
RAYS_REL = 0.01


def _soup(rng, n, n_valid):
    pos = rng.uniform(-1.0, 1.0, (n * 3, 3)).astype(np.float32)
    pos += np.repeat(rng.uniform(-4.0, 4.0, (n, 3)), 3, axis=0).astype(np.float32)
    idx = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    return pos, idx, np.arange(n) < n_valid


@pytest.mark.parametrize("case", ["soup", "atrium"])
def test_build_bvh_matches_reference(case):
    if case == "soup":
        pos, idx, valid = _soup(np.random.default_rng(0), 300, 260)
    else:
        s, _ = jflatten.flatten(jbuiltin.atrium(columns=1, stacks=6, slices=12).root)
        pos, idx = np.asarray(s.geo.positions), np.asarray(s.geo.indices)
        valid = np.asarray(s.geo.tri_material) >= 0
    want = jbvh.build_bvh(jnp.asarray(pos), jnp.asarray(idx), jnp.asarray(valid))
    got = bvh.build_bvh(pos, idx, valid)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)


@pytest.fixture(scope="module")
def atrium():
    """The tiny atrium (the reference's flatten, bridged) and 3,000 rays:
    camera rays, rays from inside the hall, every 9th lane dead, bounded
    segments."""
    g = jbuiltin.atrium(columns=1, stacks=6, slices=12)
    js, _ = jflatten.flatten(g.root)
    ps = bridge.scene_from_numpy(bridge.numpy_fields(js), "cpu")
    rng = np.random.default_rng(1)
    n = 3000
    lo, hi = np.asarray(js.geo.positions).min(0), np.asarray(js.geo.positions).max(0)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.where(rng.random(n) < 0.3, rng.uniform(0.5, 20.0, n), 3.4e38).astype(np.float32)
    tm[::9] = 0.0
    return dict(g=g, js=js, ps=ps, o=o, d=d, tm=tm)


def _brute(a):
    return intersect_brute_force(torch.from_numpy(a["o"]), torch.from_numpy(a["d"]),
                                 a["ps"].geo.positions, a["ps"].geo.indices,
                                 t_max=torch.from_numpy(a["tm"]))


def _check_closest(got, want, clean, agree_min):
    """Same tri on clean hits (t within T_REL); >= agree_min of all rays
    agree (same tri, or a tie at the same t)."""
    tri, t = got.tri.numpy(), got.t.numpy()
    wtri, wt = np.asarray(want.tri), np.asarray(want.t)
    rel = np.abs(t - wt) / np.maximum(np.abs(wt), 1e-30)
    assert (tri[clean] == wtri[clean]).all()
    assert (rel[clean] <= T_REL).all(), rel[clean].max()
    agree = ((tri == wtri) | ((tri >= 0) & (wtri >= 0) & (rel <= T_REL))).mean()
    assert agree >= agree_min, agree


@pytest.mark.parametrize("tracer", ["bvh", "packet"])
def test_closest_matches_reference_and_brute(atrium, tracer):
    a = atrium
    o, d, tm = (torch.from_numpy(a[k]) for k in ("o", "d", "tm"))
    jo, jd, jt = (jnp.asarray(a[k]) for k in ("o", "d", "tm"))
    if tracer == "bvh":
        got = bvh.traverse_closest(a["ps"].bvh, o, d, t_max=tm)
        want = jbvh.traverse_closest(a["js"].bvh, jo, jd, t_max=jt)
    else:
        got = packet.packet_closest(a["ps"].fat_bvh, o, d, t_max=tm, block=256, group=4)
        want = jpacket.packet_closest(a["js"].fat_bvh, jo, jd, t_max=jt, block=256, group=4)
    hb = _brute(a)
    bary = hb.bary.numpy()
    clean = (hb.tri.numpy() >= 0) & (bary.min(1) > EDGE) & (1.0 - bary.sum(1) > EDGE)
    assert int((hb.tri >= 0).sum()) > 500
    _check_closest(got, want, clean, AGREE_REF)
    _check_closest(got, hb, clean, AGREE_BRUTE)
    np.testing.assert_allclose(got.bary.numpy()[clean], np.asarray(want.bary)[clean], atol=1e-4)


@pytest.mark.parametrize("tracer", ["bvh", "packet"])
def test_occluded_matches_reference_and_brute(atrium, tracer):
    a = atrium
    o, d = torch.from_numpy(a["o"]), torch.from_numpy(a["d"])
    tm = np.where(a["tm"] > 1e30, 8.0, a["tm"]).astype(np.float32)
    if tracer == "bvh":
        got = bvh.traverse_occluded(a["ps"].bvh, o, d, torch.from_numpy(tm)).numpy()
        want = np.asarray(jbvh.traverse_occluded(a["js"].bvh, jnp.asarray(a["o"]),
                                                 jnp.asarray(a["d"]), jnp.asarray(tm)))
    else:
        got = packet.packet_occluded(a["ps"].fat_bvh, o, d, torch.from_numpy(tm),
                                     block=256, group=4).numpy()
        want = np.asarray(jpacket.packet_occluded(
            a["js"].fat_bvh, jnp.asarray(a["o"]), jnp.asarray(a["d"]), jnp.asarray(tm),
            block=256, group=4))
    brute = occluded_brute_force(o, d, torch.from_numpy(tm), a["ps"].geo.positions,
                                 a["ps"].geo.indices).numpy()
    assert 0.05 < got.mean() < 0.95
    assert (got == want).mean() >= AGREE_REF
    assert (got == brute).mean() >= AGREE_BRUTE
    assert not got[::9].any()  # dead lanes


def test_padding_triangles_are_never_hit():
    pos, idx, valid = _soup(np.random.default_rng(2), 64, 40)
    b = bvh.build_bvh(pos, idx, valid)
    b = type(b)(*(torch.from_numpy(x) for x in b))
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.uniform(-6, 6, (512, 3)).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((512, 3)).astype(np.float32))
    h = bvh.traverse_closest(b, o, d)
    assert (h.tri < 40).all() and (h.tri >= 0).any()


@pytest.fixture(scope="module")
def cornell():
    g = builtin.cornell_box()
    scene, _ = flatten.flatten(g.root, device="cpu")
    node, cam = flatten.find_camera(g.root)
    return scene, camera.make_view(node.to_world(), cam.fovy, 48, 48, device="cpu")


@pytest.mark.parametrize("tracer", ["bvh", "packet"])
def test_cornell_direct_render_equals_brute(cornell, tracer):
    scene, view = cornell
    a = integrator.render_direct(scene, view, integrator.RenderConfig(48, 48, tracer=tracer),
                                 3).numpy()
    b = integrator.render_direct(scene, view, integrator.RenderConfig(48, 48, tracer="brute"),
                                 3).numpy()
    if tracer == "bvh":
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    else:
        assert (np.abs(a - b) > 1e-3 * (1 + np.abs(b))).mean() < 0.005


@pytest.mark.parametrize("tracer", ["packet", "bvh", "null"])
def test_path_render_matches_reference(atrium, tracer):
    """render_path_with_counts on the tiny atrium at 32x16 (Disney, 2
    bounces, presample 256) with the same tracer in both packages: packet
    tiles, sorts and defers, bvh and null trace untiled per bounce."""
    js, ps = atrium["js"], atrium["ps"]
    node, cam = jflatten.find_camera(atrium["g"].root)
    w, h = 32, 16
    cfg = dict(width=w, height=h, max_bounces=2, bsdf="disney", presample_lights=256,
               coherent_tiles=16, tracer=tracer)
    jimg, jn = jintegrator.render_path_with_counts(
        js, jcamera.make_view(node.to_world(), cam.fovy, w, h), jintegrator.RenderConfig(**cfg), 1)
    pview = camera.make_view(node.to_world(), cam.fovy, w, h, device="cpu")
    waves = {}
    pimg, pn = integrator.render_path_with_counts(ps, pview, integrator.RenderConfig(**cfg), 1,
                                                  capture=waves)
    pimg, jimg = pimg.numpy(), np.asarray(jimg)
    assert np.isfinite(pimg).all() and pimg.shape == jimg.shape
    assert abs(pimg.mean() - jimg.mean()) <= MEAN_REL * jimg.mean()
    pix = np.all(np.abs(pimg - jimg) <= 1e-3 * (1 + np.abs(jimg)), axis=-1).mean()
    assert pix >= PIXEL_SHARE, pix
    assert abs(int(pn) - int(jn)) <= RAYS_REL * int(jn)
    shadow = [o.shape[0] for o, _, _ in waves["occluded"]]
    assert shadow == ([3 * w * h] if tracer == "packet" else [w * h] * 3)
