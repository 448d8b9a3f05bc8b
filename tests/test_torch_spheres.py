"""Analytic spheres in the port (ops/spheres.py, the sphere rows of
scene/schema.py, shading and the light table, the cone sampler of sphere
lights and the integrator's sphere branches; ROADMAP Queue 1 item 4)
against the JAX reference.

Units on seeded numpy inputs: closest and any-hit sphere tests (the same
sphere, t within 2^-12 relative, its uv within 2^-12, occlusion flags
equal), the sphere-light
cone sampler and its pdf, uniform sampling of sphere lights, shading of
sphere rows, and what ``flatten`` builds (sphere SoA, shading rows, light
table) against the reference's build of the same scene. Renders: the white
furnace with an analytic sphere (environment pixels exactly the radiance
0.5, the sphere within 4 % of albedo x radiance 0.4, and the reference's
render) and the reference's sphere-light box (tests/test_spheres.py:
60-120) at 32x32 on the dense tracer and on the block kernel, within
test_torch_slice.py's bounds (image mean 2 %, >= 97 % of pixels within
1e-3, n_rays 1 %).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.core import transform as jxform
from stratum_tpu.ops import spheres as jspheres
from stratum_tpu.render import camera as jcamera
from stratum_tpu.render import integrator as jintegrator
from stratum_tpu.render import lights as jlights
from stratum_tpu.render import shading as jshading
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu.scene import graph as jgraph
from stratum_tpu.scene import material as jmaterial
from stratum_tpu_torch.core import transform as pxform
from stratum_tpu_torch.ops import spheres as pspheres
from stratum_tpu_torch.render import camera, integrator
from stratum_tpu_torch.render import lights as plights
from stratum_tpu_torch.render import shading as pshading
from stratum_tpu_torch.scene import bridge, builtin, flatten, graph, material

torch.set_num_threads(2)

MEAN_REL = 0.02
PIXEL_SHARE = 0.97
RAYS_REL = 0.01
FURNACE_REL = 0.04
W = H = 32


def _agree(img, ref, n=None, n_ref=None):
    img, ref = np.asarray(img), np.asarray(ref)
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert abs(img.mean() - ref.mean()) <= MEAN_REL * ref.mean(), (img.mean(), ref.mean())
    pix = np.all(np.abs(img - ref) <= 1e-3 * (1 + np.abs(ref)), axis=-1).mean()
    assert pix >= PIXEL_SHARE, pix
    if n is not None:
        assert abs(int(n) - int(n_ref)) <= RAYS_REL * int(n_ref), (int(n), int(n_ref))


def _sphere_light_box(g_mod, m_mod, look_at, analytic=True):
    """The reference's gray floor lit by one emissive sphere (radius 0.5,
    emission 40), plus an analytic blocker sphere half way up."""
    g = g_mod.NodeGraph()
    s = 10.0
    floor = g.root.add_child("floor")
    floor.make_component(g_mod.MeshPrimitive(
        positions=np.asarray([[-s, 0, -s], [-s, 0, s], [s, 0, s], [s, 0, -s]], np.float32),
        indices=np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
        material=m_mod.Material(base_color=np.full(3, 0.6, np.float32))))
    for name, y, x, radius, mat in (
        ("lamp", 4.0, 0.0, 0.5, m_mod.Material(base_color=np.zeros(3, np.float32),
                                               emission=np.full(3, 40.0, np.float32))),
        ("blocker", 2.0, 1.5, 0.6, m_mod.Material(base_color=np.full(3, 0.2, np.float32))),
    ):
        t = np.eye(3, 4, dtype=np.float32)
        t[:, 3] = (x, y, 0.0)
        n = g.root.add_child(name)
        n.make_component(g_mod.TransformComponent(matrix=t))
        n.make_component(g_mod.SpherePrimitive(radius=radius, material=mat, analytic=analytic,
                                               stacks=24, slices=48))
    cam = g.root.add_child("camera")
    cam.make_component(g_mod.TransformComponent(
        matrix=np.asarray(look_at((0.0, 3.0, -8.0), (0.0, 1.0, 0.0)), np.float32)))
    cam.make_component(g_mod.CameraComponent(fovy=np.radians(45.0)))
    return g


@pytest.fixture(scope="module")
def box():
    jg = _sphere_light_box(jgraph, jmaterial, jxform.look_at)
    js, _ = jflatten.flatten(jg.root)
    ps, _ = flatten.flatten(_sphere_light_box(graph, material, pxform.look_at).root,
                            device="cpu")
    node, cam = jflatten.find_camera(jg.root)
    c2w = np.asarray(node.to_world())
    return dict(js=js, ps=ps, bridged=bridge.scene_from_numpy(bridge.numpy_fields(js), "cpu"),
                jview=jcamera.make_view(c2w, cam.fovy, W, H),
                pview=camera.make_view(c2w, cam.fovy, W, H, device="cpu"))


def test_flatten_matches_reference(box):
    """Sphere SoA, the shading rows (spheres after the padded triangles),
    the light table (the lamp a sphere light) and the dense payload."""
    js = box["js"]
    for scene in (box["ps"], box["bridged"]):
        for f in ("center", "radius", "material", "light", "instance"):
            np.testing.assert_array_equal(getattr(scene.spheres, f).numpy(),
                                          np.asarray(getattr(js.spheres, f)))
        np.testing.assert_array_equal(scene.geo.packed_tri.numpy(), np.asarray(js.geo.packed_tri))
        np.testing.assert_array_equal(scene.lights.packed.numpy(), np.asarray(js.lights.packed))
        assert scene.lights.num_lights == int(js.lights.num_lights) == 1
    assert box["ps"].tri_payload.shape[0] == box["ps"].geo.num_triangles + 2
    np.testing.assert_array_equal(box["ps"].tri_payload.numpy(), box["bridged"].tri_payload.numpy())


def test_sphere_intersection_matches_reference():
    rng = np.random.default_rng(4)
    center = rng.uniform(-5, 5, (5, 3)).astype(np.float32)
    radius = np.asarray([1.0, 0.5, 2.0, 0.0, 1.5], np.float32)  # row 3 is padding
    o = rng.uniform(-8, 8, (4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:1024] = center[rng.integers(0, 5, 1024)] - o[:1024]  # rays aimed at centers
    d[:1024] /= np.linalg.norm(d[:1024], axis=1, keepdims=True)
    tm = rng.uniform(0.5, 30, 4096).astype(np.float32)
    pt, psid, puv = pspheres.intersect_spheres(*(torch.from_numpy(x) for x in (center, radius, o, d)),
                                               t_max=torch.from_numpy(tm))
    jt, jsid, juv = jspheres.intersect_spheres(center, radius, o, d, t_max=tm)
    jsid = np.asarray(jsid)
    np.testing.assert_array_equal(psid.numpy(), jsid)
    assert 0.15 < (jsid >= 0).mean() < 0.9 and not (jsid == 3).any()
    hit = jsid >= 0
    np.testing.assert_allclose(pt.numpy()[hit], np.asarray(jt)[hit], rtol=2.0 ** -12)
    np.testing.assert_allclose(puv.numpy(), np.asarray(juv), atol=2.0 ** -12)
    occ = pspheres.occluded_spheres(*(torch.from_numpy(x) for x in (center, radius, o, d, tm)))
    np.testing.assert_array_equal(occ.numpy(),
                                  np.asarray(jspheres.occluded_spheres(center, radius, o, d, tm)))


def test_sphere_light_sampling_matches_reference(box):
    """The cone sampler from points on the floor and inside the lamp, its
    MIS pdf, uniform area samples of the sphere light and the shading of
    sphere hits."""
    js, ps = box["js"], box["ps"]
    rng = np.random.default_rng(8)
    n = 4096
    ref = np.stack([rng.uniform(-9, 9, n), np.zeros(n), rng.uniform(-9, 9, n)], 1).astype(np.float32)
    ref[:64] = [0.0, 4.1, 0.0]  # inside the lamp: the area sampler
    u = rng.random((3, n), dtype=np.float32)
    prec, pcone = plights.sample_sphere_light_cone(ps, torch.from_numpy(ref),
                                                   *(torch.from_numpy(x) for x in u))
    jrec, jcone = jlights.sample_sphere_light_cone(js, jnp.asarray(ref), *u)
    np.testing.assert_array_equal(pcone.numpy(), np.asarray(jcone))
    assert np.asarray(jcone)[64:].all() and not np.asarray(jcone)[:64].any()
    # the near root of a direction grazing the lamp cancels, and so does
    # 1 - cos of a far point's narrow cone: 1e-4 there
    for f, tol in (("position", dict(atol=1e-4)), ("normal", dict(atol=1e-4)),
                   ("radiance", dict(rtol=0)), ("pdf_area", dict(rtol=1e-4))):
        np.testing.assert_allclose(getattr(prec, f).numpy(), np.asarray(getattr(jrec, f)),
                                   **tol, err_msg=f)
    light_row = np.where(rng.random(n) < 0.8, 0, -1).astype(np.int32)
    pp, pok = plights.sphere_cone_pdf_w(ps, torch.from_numpy(ref), torch.from_numpy(light_row))
    jp, jok = jlights.sphere_cone_pdf_w(js, jnp.asarray(ref), jnp.asarray(light_row))
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=1e-4)
    prec = plights.sample_light(ps, *(torch.from_numpy(x) for x in u))
    jrec = jlights.sample_light(js, *u)
    for f in ("position", "normal", "pdf_area"):
        np.testing.assert_allclose(getattr(prec, f).numpy(), np.asarray(getattr(jrec, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    # shading rows of sphere hits: tri T + sid, bary the spherical uv
    t_off = ps.geo.num_triangles
    tri = np.where(rng.random(n) < 0.5, t_off + rng.integers(0, 2, n), 0).astype(np.int32)
    bary = rng.random((n, 2), dtype=np.float32) * 0.5
    d = rng.normal(size=(n, 3)).astype(np.float32)
    row = ps.geo.packed_tri[torch.from_numpy(tri).long()]
    psp = pshading.shading_point_from_row(row, torch.from_numpy(tri), torch.from_numpy(bary),
                                          torch.from_numpy(d), textured=True, spheres=True)
    jsp = jshading.shading_point_from_row(np.asarray(js.geo.packed_tri)[tri], tri, bary, d)
    for f in ("position", "geom_normal", "shading_normal", "uv", "tangent", "uv_area",
              "light", "front_face", "material"):
        np.testing.assert_allclose(np.asarray(getattr(psp, f), np.float32),
                                   np.asarray(getattr(jsp, f), np.float32),
                                   rtol=1e-5, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("tracer", ["auto", "pallas"])
def test_sphere_light_box_matches_reference(box, tracer):
    """Per-lane cone NEE with sphere-light MIS on the dense tracer; the
    presampled tile (area samples) on the block kernel, where the sphere
    test is merged into the sorted closest waves and the deferred wave."""
    cfg = dict(width=W, height=H, max_bounces=2)
    if tracer == "pallas":
        cfg.update(presample_lights=256)
    jimg, jn = jintegrator.render_path_with_counts(
        box["js"], box["jview"],
        jintegrator.RenderConfig(tracer="packet" if tracer == "pallas" else tracer, **cfg), 3)
    pimg, pn = integrator.render_path_with_counts(
        box["ps"], box["pview"], integrator.RenderConfig(tracer=tracer, **cfg), 3)
    _agree(pimg.numpy(), jimg, pn, jn)


def test_direct_lighting_matches_reference(box):
    """``render_direct`` shades sphere hits from their rows (the lamp seen
    directly, the blocker's shadow on the floor)."""
    cfg = dict(width=W, height=H)
    jimg = jintegrator.render_direct(box["js"], box["jview"], jintegrator.RenderConfig(**cfg), 4)
    pimg = integrator.render_direct(box["ps"], box["pview"], integrator.RenderConfig(**cfg), 4)
    _agree(pimg.numpy(), jimg)


def test_analytic_furnace():
    """The white furnace with its sphere analytic (an all-sphere scene):
    environment pixels exactly 0.5, the sphere within 4 % of 0.4, and the
    reference's render."""
    jg = jbuiltin.furnace()
    for _, prim in jg.root.find_in_descendants(jgraph.SpherePrimitive):
        prim.analytic = True
    js, _ = jflatten.flatten(jg.root)
    g = builtin.furnace()
    for _, prim in g.root.find_in_descendants(graph.SpherePrimitive):
        prim.analytic = True
    ps, _ = flatten.flatten(g.root, device="cpu")
    assert ps.spheres.num_spheres == 1 and integrator.resolved_tracer(
        ps, integrator.RenderConfig()) == "mxu"
    node, cam = flatten.find_camera(g.root)
    n = 48
    cfg = dict(width=n, height=n, max_bounces=8, rr_depth=99)
    img = integrator.render_path_progressive(
        ps, camera.make_view(node.to_world(), cam.fovy, n, n, device="cpu"),
        integrator.RenderConfig(**cfg), 8).numpy()
    ref = jintegrator.render_path_progressive(
        js, jcamera.make_view(np.asarray(node.to_world()), cam.fovy, n, n),
        jintegrator.RenderConfig(**cfg), 8)
    _agree(img, ref)
    px, py = np.meshgrid(np.arange(n) + 0.5, np.arange(n) + 0.5)
    tan = np.hypot(px - n / 2, py - n / 2) / (n / 2) * np.tan(np.radians(22.5))
    assert np.all(img[tan > 0.3] == np.float32(0.5))
    assert abs(img[tan < 0.2].mean() - 0.4) <= FURNACE_REL * 0.4, img[tan < 0.2].mean()
