"""The estimator options of the port's path tracer (ROADMAP Queue 1 item
4): the reservoir (core/reservoir.py) and RIS NEE, NEE or MIS off, and the
alpha test, against the JAX reference.

Units: reservoir streams and merges on seeded numpy inputs; the kept
candidates equal, the floats within 1e-6 relative. Renders: the tiny
atrium (bridged, so both packages trace the same arrays) at 32x32 on the
block kernel (the reference's ``"packet"``), the bench configuration cut to
3 bounces, and the reference's masked-quad scene (tests/test_texture.py:
143-205) built by each package's own flatten, at 16x16. Bounds of
test_torch_slice.py: image mean within 2 % relative, >= 97 % of pixels
within 1e-3, n_rays within 1 %.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.core import reservoir as jres
from stratum_tpu.render import camera as jcamera
from stratum_tpu.render import integrator as jintegrator
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu.scene import graph as jgraph
from stratum_tpu.scene import material as jmaterial
from stratum_tpu_torch.core import reservoir as pres
from stratum_tpu_torch.core.transform import look_at
from stratum_tpu_torch.render import camera, integrator
from stratum_tpu_torch.scene import bridge, flatten, graph, material

torch.set_num_threads(2)

MEAN_REL = 0.02
PIXEL_SHARE = 0.97
RAYS_REL = 0.01
W = H = 32
BENCH = dict(width=W, height=H, max_bounces=3, bsdf="disney", presample_lights=4096,
             coherent_tiles=16)


def _agree(img, ref, n=None, n_ref=None):
    img, ref = np.asarray(img), np.asarray(ref)
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert abs(img.mean() - ref.mean()) <= MEAN_REL * ref.mean(), (img.mean(), ref.mean())
    pix = np.all(np.abs(img - ref) <= 1e-3 * (1 + np.abs(ref)), axis=-1).mean()
    assert pix >= PIXEL_SHARE, pix
    if n is not None:
        assert abs(int(n) - int(n_ref)) <= RAYS_REL * int(n_ref), (int(n), int(n_ref))


def _stream(mod, to, cands, p_hats, us):
    n = p_hats.shape[1]
    zero = {k: to(np.zeros_like(v[0])) for k, v in cands.items()}
    res = mod.init_reservoir(zero, n)
    for m in range(p_hats.shape[0]):
        cand = {k: to(v[m]) for k, v in cands.items()}
        res = mod.update(res, cand, to(p_hats[m]), to(p_hats[m]), to(us[m]))
    return res


def _check_reservoir(p, j):
    for k in j.sample:
        np.testing.assert_array_equal(p.sample[k].numpy(), np.asarray(j.sample[k]))
    for f in ("target_pdf", "total_weight", "m"):
        np.testing.assert_allclose(getattr(p, f).numpy(), np.asarray(getattr(j, f)), rtol=1e-6)
    np.testing.assert_allclose(pres.contribution_weight(p).numpy(),
                               np.asarray(jres.contribution_weight(j)), rtol=1e-6)


def test_reservoir_update_and_merge_match_reference():
    """Eight candidates streamed through 4,096 lanes (a quarter with
    zero weight), then one reservoir merged into another."""
    rng = np.random.default_rng(3)
    m, n = 8, 4096
    p_hats = (rng.random((m, n)) * (rng.random((m, n)) > 0.25)).astype(np.float32)
    cands = dict(wi=rng.normal(size=(m, n, 3)).astype(np.float32),
                 dist=rng.random((m, n)).astype(np.float32))
    us = rng.random((2, m, n)).astype(np.float32)
    to_p = torch.from_numpy
    pa = _stream(pres, to_p, cands, p_hats, us[0])
    ja = _stream(jres, jnp.asarray, cands, p_hats, us[0])
    _check_reservoir(pa, ja)
    pb = _stream(pres, to_p, cands, p_hats[::-1].copy(), us[1])
    jb = _stream(jres, jnp.asarray, cands, p_hats[::-1].copy(), us[1])
    u = rng.random(n).astype(np.float32)
    _check_reservoir(pres.merge(pa, pb, to_p(u)), jres.merge(ja, jb, jnp.asarray(u)))


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


@pytest.mark.parametrize("option", [
    dict(ris_candidates=4),
    dict(ris_candidates=3, presample_lights=0, coherent_tiles=0, bsdf="lambert"),
    dict(use_nee=False), dict(use_mis=False),
])
def test_estimator_options_match_reference(case, option):
    """RIS from the light tile (4 candidates of 4 draws each) and from
    per-lane light samples; NEE off (BSDF sampling alone, no shadow wave);
    NEE without MIS."""
    cfg = {**BENCH, **option}
    jimg, jn = jintegrator.render_path_with_counts(
        case["js"], case["jview"], jintegrator.RenderConfig(tracer="packet", **cfg), 1)
    pimg, pn = integrator.render_path_with_counts(
        case["ps"], case["pview"], integrator.RenderConfig(tracer="pallas", **cfg), 1)
    _agree(pimg.numpy(), jimg, pn, jn)


def test_nee_off_traces_no_shadow_ray(case):
    """``use_nee=False`` counts closest rays only and traces no occlusion
    wave; without MIS the light still gets its NEE shadow rays."""
    waves = {}
    _, n = integrator.render_path_with_counts(
        case["ps"], case["pview"], integrator.RenderConfig(tracer="pallas", use_nee=False, **BENCH),
        1, capture=waves)
    assert "occluded" not in waves
    assert int(n) == sum(int((t > 0).sum()) for _, _, t in waves["closest"])
    waves = {}
    integrator.render_path_with_counts(
        case["ps"], case["pview"], integrator.RenderConfig(tracer="pallas", use_mis=False, **BENCH),
        1, capture=waves)
    assert len(waves["occluded"]) == 1


def _masked_quad(g_mod, m_mod):
    """The reference's alpha-test scene: a quad whose left half is cut out
    (alpha 0) in front of a larger emitter facing the camera."""
    mask = np.ones((8, 8, 4), np.float32)
    mask[:, :4, 3] = 0.0
    quad = np.asarray([[-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32)
    uvq = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    g = g_mod.NodeGraph()
    g.root.add_child("masked").make_component(g_mod.MeshPrimitive(
        positions=quad, indices=idx, uvs=uvq, material=m_mod.Material(alpha_image=mask)))
    g.root.add_child("emitter").make_component(g_mod.MeshPrimitive(
        positions=quad * np.asarray([3, 3, 1], np.float32) + np.asarray([0, 0, 2], np.float32),
        indices=idx[:, ::-1].copy(),
        material=m_mod.Material(base_color=np.zeros(3, np.float32),
                                emission=np.full(3, 5.0, np.float32))))
    return g


@pytest.mark.parametrize("tracer", ["auto", "pallas"])
def test_alpha_test_passes_the_cut_out_half(tracer):
    """With the alpha test the transparent (left) half sees the emitter, the
    opaque half does not, and without it neither does; on the dense tracer
    and on the block kernel (whose re-traces merge the fused payload)."""
    scene, _ = flatten.flatten(_masked_quad(graph, material).root, device="cpu")
    view = camera.make_view(look_at((0, 0, -2), (0, 0, 1)), np.radians(40), 16, 16, device="cpu")
    imgs = {at: integrator.render_path(scene, view, integrator.RenderConfig(
        16, 16, max_bounces=1, alpha_test=at, tracer=tracer), 0).numpy() for at in (True, False)}
    left, right = np.s_[3:13, 2:7], np.s_[3:13, 9:14]
    assert imgs[True][left].max() >= 4.0
    assert imgs[False][left].max() < 4.0
    assert imgs[True][right].max() < 4.0


def test_alpha_test_matches_reference():
    """The masked-quad scene through each package's own flatten, 2
    bounces, against the reference."""
    jg = _masked_quad(jgraph, jmaterial)
    js, _ = jflatten.flatten(jg.root)
    c2w = np.asarray(look_at((0, 0, -2), (0, 0, 1)))
    fovy = float(np.radians(40))
    ps, _ = flatten.flatten(_masked_quad(graph, material).root, device="cpu")
    cfg = dict(width=16, height=16, max_bounces=2, alpha_test=True)
    jimg = jintegrator.render_path(js, jcamera.make_view(c2w, fovy, 16, 16),
                                   jintegrator.RenderConfig(**cfg), 2)
    pimg = integrator.render_path(ps, camera.make_view(c2w, fovy, 16, 16, device="cpu"),
                                  integrator.RenderConfig(**cfg), 2)
    _agree(pimg.numpy(), jimg)
