"""The Cornell dense-tracer path and the plain entry points of the port
(stratum_tpu_torch/render/integrator.py: resolved_tracer, trace_direct,
render_direct(_progressive), render_path(_progressive)) against the JAX
reference, the reference's golden images, and the white furnace.

Both packages build the same builtin scenes (Cornell box: 36 triangles, so
``tracer="auto"`` resolves to the dense MXU tracer in both) and the same
camera; the RNG streams are bit-exact, so the images differ only where f32
sums taken in another order move a discrete decision (a near-tie hit, a
roulette or lobe draw) to its other side.

Bounds, those of test_torch_slice.py: image mean within 2 % relative,
>= 97 % of pixels within 1e-3 (abs + rel), n_rays within 1 %. Measured on
the first run: means equal to 3e-7 relative, 100 % of pixels within 1e-3
(largest pixel difference 4.3e-6 against JAX at 32x32, 2.0e-4 against the
spheres golden), n_rays equal. The goldens (tests/golden/*.npy, 48x48,
configurations of tests/update_goldens.py:41-52) are held to the same
bounds; chip_smoke.py holds the card's renders to twice them. The furnace:
environment pixels equal the radiance 0.5 exactly; the sphere (albedo 0.8,
a convex sphere sees only the environment) averages 0.8 x 0.5 within 4 %
over its pixels at 8 spp (measured 0.3955: the tessellated sphere's
shading normals and the shadow-terminator term take ~1.1 %).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from stratum_tpu.render import camera as jcamera
from stratum_tpu.render import integrator as jintegrator
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu_torch.ops import block_trace
from stratum_tpu_torch.render import camera, integrator
from stratum_tpu_torch.scene import builtin, flatten

torch.set_num_threads(2)

MEAN_REL = 0.02
PIXEL_SHARE = 0.97
RAYS_REL = 0.01
W = H = 32
GOLDEN = Path(__file__).resolve().parent / "golden"
GOLDENS = {  # tests/update_goldens.py:41-52
    "cornell_path": ("cornell_box", {}, 16, dict(max_bounces=3)),
    "cornell_disney": ("cornell_box", {}, 16, dict(max_bounces=3, bsdf="disney")),
    "spheres_disney": ("material_spheres", dict(stacks=12, slices=24), 8,
                       dict(max_bounces=4, bsdf="disney")),
}
FURNACE_REL = 0.04


def _agree(img, ref, n=None, n_ref=None):
    img, ref = np.asarray(img), np.asarray(ref)
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert abs(img.mean() - ref.mean()) <= MEAN_REL * ref.mean(), (img.mean(), ref.mean())
    pix = np.all(np.abs(img - ref) <= 1e-3 * (1 + np.abs(ref)), axis=-1).mean()
    assert pix >= PIXEL_SHARE, pix
    if n is not None:
        assert abs(int(n) - int(n_ref)) <= RAYS_REL * int(n_ref), (int(n), int(n_ref))


def _port(name, w, h, **kw):
    g = getattr(builtin, name)(**kw)
    scene, _ = flatten.flatten(g.root, device="cpu")
    node, cam = flatten.find_camera(g.root)
    return scene, camera.make_view(node.to_world(), cam.fovy, w, h, device="cpu")


@pytest.fixture(scope="module")
def cornell():
    g = jbuiltin.cornell_box()
    js, _ = jflatten.flatten(g.root)
    node, cam = jflatten.find_camera(g.root)
    ps, pview = _port("cornell_box", W, H)
    return dict(js=js, jview=jcamera.make_view(node.to_world(), cam.fovy, W, H),
                ps=ps, pview=pview)


@pytest.mark.parametrize("cfg", [
    dict(max_bounces=3),
    dict(max_bounces=4, presample_lights=4096),  # bench.py's cornell_e2e cfg2
    dict(max_bounces=3, bsdf="disney"),
])
def test_render_path_matches_reference(cornell, cfg):
    jimg, jn = jintegrator.render_path_with_counts(
        cornell["js"], cornell["jview"], jintegrator.RenderConfig(width=W, height=H, **cfg), 1)
    pcfg = integrator.RenderConfig(width=W, height=H, **cfg)
    assert integrator.resolved_tracer(cornell["ps"], pcfg) == "mxu"
    pimg, pn = integrator.render_path_with_counts(cornell["ps"], cornell["pview"], pcfg, 1)
    _agree(pimg.numpy(), jimg, pn, jn)
    assert torch.equal(integrator.render_path(cornell["ps"], cornell["pview"], pcfg, 1), pimg)


def test_direct_lighting_matches_reference(cornell):
    """trace_direct / render_direct (NEE-only Lambert) and their progressive
    mean over 2 seeds, against the reference."""
    jcfg = jintegrator.RenderConfig(width=W, height=H)
    pcfg = integrator.RenderConfig(width=W, height=H)
    for seed in (0, 1):
        jimg = jintegrator.render_direct(cornell["js"], cornell["jview"], jcfg, seed)
        pimg = integrator.render_direct(cornell["ps"], cornell["pview"], pcfg, seed)
        _agree(pimg.numpy(), jimg)
        rad = integrator.trace_direct(cornell["ps"], cornell["pview"], pcfg, seed)
        assert torch.equal(rad.view(H, W, 3), pimg)
    jimg = jintegrator.render_direct_progressive(cornell["js"], cornell["jview"], jcfg, 2)
    pimg = integrator.render_direct_progressive(cornell["ps"], cornell["pview"], pcfg, 2)
    _agree(pimg.numpy(), jimg)


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden_images(name):
    scene_fn, kw, spp, cfg = GOLDENS[name]
    scene, view = _port(scene_fn, 48, 48, **kw)
    img = integrator.render_path_progressive(
        scene, view, integrator.RenderConfig(width=48, height=48, rr_depth=100, **cfg), spp)
    _agree(img.numpy(), np.load(GOLDEN / f"{name}.npy"))


def test_white_furnace():
    """Environment pixels see exactly the radiance; the sphere's pixels
    average albedo x radiance (one bounce reaches the environment)."""
    scene, view = _port("furnace", 48, 48)
    img = integrator.render_path_progressive(
        scene, view, integrator.RenderConfig(width=48, height=48, max_bounces=2), 8).numpy()
    px, py = np.meshgrid(np.arange(48) + 0.5, np.arange(48) + 0.5)
    # tangent of each pixel's angle off the axis; the sphere (radius 1, 4
    # away) subtends tan(asin(1 / 4)) = 0.258
    tan = np.hypot(px - 24, py - 24) / 24 * np.tan(np.radians(22.5))
    env, sphere = tan > 0.3, tan < 0.2
    assert np.all(img[env] == np.float32(0.5))
    assert abs(img[sphere].mean() - 0.4) <= FURNACE_REL * 0.4, img[sphere].mean()


def test_render_config_is_the_references_field_for_field():
    ours = [(f.name, f.default) for f in dataclasses.fields(integrator.RenderConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(jintegrator.RenderConfig)]
    assert ours == ref


@pytest.mark.parametrize("option, item", [
    (dict(lvc_connections=2), "item 5"), (dict(tex_filter="stochastic"), "item 2"),
])
def test_unported_fields_name_their_item(cornell, option, item):
    """The two fields restored to match the reference refused non-defaults,
    naming the ROADMAP item that ports them, until it was ported: item 2
    ported ``tex_filter`` and item 5 ``lvc_connections``. Neither changes a
    path-traced render here: on an untextured scene the stochastic filter
    takes no draw, and ``lvc_connections`` is BDPT's (render/bdpt.py; the
    path tracer reads it nowhere, as in the reference), so the render
    equals the default one bit for bit."""
    cfg = integrator.RenderConfig(width=W, height=H, **option)
    default = integrator.RenderConfig(width=W, height=H)
    assert torch.equal(integrator.render_path(cornell["ps"], cornell["pview"], cfg, 0),
                       integrator.render_path(cornell["ps"], cornell["pview"], default, 0))


def test_tracer_resolution(cornell, monkeypatch):
    """auto: the dense tracer at <= MXU_TRI_THRESHOLD (padded) triangles,
    the block kernel above; explicit tracers stand; an unknown one raises."""
    ps = cornell["ps"]
    assert ps.geo.num_triangles == 128
    resolve = integrator.resolved_tracer
    assert resolve(ps, integrator.RenderConfig()) == "mxu"
    for t in ("mxu", "pallas", "brute"):
        assert resolve(ps, integrator.RenderConfig(tracer=t)) == t
    monkeypatch.setattr(integrator, "MXU_TRI_THRESHOLD", 127)
    assert resolve(ps, integrator.RenderConfig()) == "pallas"
    with pytest.raises(ValueError, match="unknown tracer"):
        integrator.render_path(ps, cornell["pview"], integrator.RenderConfig(tracer="x"), 0)


def test_dense_path_traces_every_wave_unsorted_and_shadows_per_bounce(cornell, monkeypatch):
    """On the dense tracer: no block-kernel wrapper or sort is called, every
    bounce traces one closest wave and its own shadow wave of W x H lanes
    (``defer_shadows`` holds only for "pallas"), the pixel grid is untiled,
    and "brute" renders what "mxu" renders."""
    def refuse(*a, **k):
        raise AssertionError("the block tracer was called")

    monkeypatch.setattr(block_trace, "block_closest", refuse)
    monkeypatch.setattr(block_trace, "block_occluded", refuse)
    monkeypatch.setattr(integrator.raysort, "sorted_closest", refuse)
    cfg = integrator.RenderConfig(width=W, height=H, max_bounces=3, presample_lights=256)
    waves = {}
    img, n = integrator.render_path_with_counts(cornell["ps"], cornell["pview"], cfg, 2,
                                                capture=waves)
    assert [o.shape[0] for o, _, _ in waves["closest"]] == [W * H] * 4
    assert [o.shape[0] for o, _, _ in waves["occluded"]] == [W * H] * 4
    rad, n2 = integrator.trace_path(cornell["ps"], cornell["pview"], cfg, 2)
    assert torch.equal(rad.view(H, W, 3), img) and int(n) == int(n2)
    brute = integrator.render_path(cornell["ps"], cornell["pview"],
                                   dataclasses.replace(cfg, tracer="brute"), 2)
    _agree(brute.numpy(), img.numpy())
