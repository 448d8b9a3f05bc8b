"""The port's image I/O, texture stack and samplers, environment tables and
samplers, and texture shading terms (stratum_tpu_torch/io/image.py,
render/texture.py, core/distribution.py, scene/schema.py env tables,
render/lights.py, render/shading.py) against the JAX reference, on inputs
made from a seed with numpy.

Bounds. Writers, readers, atlases and the mip sum pyramid are copies of the
reference's numpy and must be equal byte for byte or bit for bit. The 2D
env tables' sums run in numpy here and in XLA there (another summation
order): within 1e-6. Samples gather the same f16 texels and blend them in
f32 in the reference's order: within 1e-6. The ray-cone LOD (a log2) and
the environment samplers and pdfs (trigonometry, a descent over f32 sums)
within 1e-5 relative, directions within 1e-5; the texture shading terms
within 1e-5.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.core import distribution as jdist
from stratum_tpu.io import image as jimage
from stratum_tpu.render import lights as jlights
from stratum_tpu.render import shading as jshading
from stratum_tpu.render import texture as jtex
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu.scene import graph as jgraph
from stratum_tpu.scene import material as jmaterial
from stratum_tpu.scene import schema as jschema
from stratum_tpu_torch.core import distribution as pdist
from stratum_tpu_torch.io import image as pimage
from stratum_tpu_torch.render import lights as plights
from stratum_tpu_torch.render import shading as pshading
from stratum_tpu_torch.render import texture as ptex
from stratum_tpu_torch.scene import bridge, builtin, flatten, graph, material, schema

torch.set_num_threads(2)

SAMPLE_ATOL = 1e-6
TABLE_ATOL = 1e-6
REL = 1e-5


def _images(rng):
    """Three 16x16 sources: RGB, RGBA and grey."""
    return [rng.random((16, 16, 3), dtype=np.float32),
            rng.random((16, 16, 4), dtype=np.float32),
            rng.random((16, 16), dtype=np.float32)]


@pytest.mark.parametrize("ext", ["png", "hdr", "pfm", "exr"])
def test_image_files_match_reference(tmp_path, ext):
    """The port writes the reference's bytes, and each reader reads both
    files to the same arrays; load_image too (PNG: sRGB decode, RGBA)."""
    rng = np.random.default_rng(7)
    img = (rng.random((9, 13, 3), dtype=np.float32) * (3.0 if ext != "png" else 1.0))
    img[0, 0] = 0.0
    ours, ref = tmp_path / f"port.{ext}", tmp_path / f"ref.{ext}"
    pimage.save_image(ours, img)
    jimage.save_image(ref, img)
    assert ours.read_bytes() == ref.read_bytes()
    read = {"png": "read_png", "hdr": "read_hdr", "pfm": "read_pfm", "exr": "read_exr"}[ext]
    np.testing.assert_array_equal(getattr(pimage, read)(ours), getattr(jimage, read)(ref))
    np.testing.assert_array_equal(pimage.load_image(ours), jimage.load_image(ref))


def test_linear_to_srgb_matches_reference():
    """The port's numpy sRGB encode (the power in float64, rounded to f32)
    against the reference's XLA f32 power: within 2 f32 ulps (4e-7
    relative; measured 3.9e-7). Quantised to 8 bits the two differ by at
    most 1 and only where a value lies within that of a rounding boundary
    (measured: 1 of 200,000 random values); the sample assets' PNGs are
    equal byte for byte (test_torch_colonnade.py)."""
    from stratum_tpu.core import math as jmath

    x = np.random.default_rng(3).random(200_000, dtype=np.float32) * 1.2 - 0.1
    got, want = pimage.linear_to_srgb(x), np.asarray(jmath.linear_to_srgb(x))
    np.testing.assert_allclose(got, want, rtol=4e-7, atol=1e-9)
    q = lambda a: (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.int32)  # noqa: E731
    diff = np.abs(q(got) - q(want))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4


def _assert_stacks_equal(js, ps):
    assert (ps.base_res, ps.num_levels, ps.num_tex) == (js.base_res, js.num_levels, js.num_tex)
    assert ps.level_offsets() == js.level_offsets()
    np.testing.assert_array_equal(ps.flat.view(np.uint16), np.asarray(js.flat).view(np.uint16))
    np.testing.assert_array_equal(ps.quad.view(np.uint16), np.asarray(js.quad).view(np.uint16))


@pytest.mark.parametrize("res", [16, 8])
def test_texture_stack_bit_for_bit(monkeypatch, res):
    """flat and quad atlases equal bit for bit without PIL; at res 8 the
    sources are resampled by both packages' nearest-rows branch."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    imgs = _images(np.random.default_rng(1))
    _assert_stacks_equal(jtex.build_texture_stack(imgs, res=res),
                         ptex.build_texture_stack(imgs, res=res))
    empty = ptex.build_texture_stack([])
    assert empty.resolution == 1 and empty.flat.shape == (1, 4)


@pytest.mark.parametrize("shapes", [((16, 16), (13, 21), (5, 7)), ((8, 8), (9, 30), (40, 3))])
def test_texture_stack_resampled_with_pil(shapes):
    """With PIL importable both packages resample each channel by PIL's
    LANCZOS (mode F): at res 8, from sources of other sizes (down and up,
    square or not, RGB, RGBA and grey), the atlases are equal bit for
    bit."""
    pytest.importorskip("PIL")
    rng = np.random.default_rng(11)
    imgs = [rng.random(shapes[0] + (3,), dtype=np.float32),
            rng.random(shapes[1] + (4,), dtype=np.float32),
            rng.random(shapes[2], dtype=np.float32)]
    ps = ptex.build_texture_stack(imgs, res=8)
    _assert_stacks_equal(jtex.build_texture_stack(imgs, res=8), ps)
    nearest = [im[np.linspace(0, im.shape[0] - 1, 8).astype(np.int32)]
               [:, np.linspace(0, im.shape[1] - 1, 8).astype(np.int32)] for im in imgs]
    assert not np.array_equal(ps.flat, ptex.build_texture_stack(nearest, res=8).flat)


@pytest.fixture(scope="module")
def stacks():
    imgs = _images(np.random.default_rng(2))
    js = jtex.build_texture_stack(imgs, res=16)
    ps = schema.to_device(ptex.build_texture_stack(imgs, res=16), "cpu")
    return js, ps


@pytest.mark.parametrize("mode", ["nearest", "bilinear_int", "trilinear", "stochastic"])
def test_samples_match_reference(stacks, mode):
    """uvs in [-3, 17) (wrapped, x reaches 17 x 16 texels), tex ids -1..2,
    LODs below 0 and past the last level."""
    js, ps = stacks
    rng = np.random.default_rng(4)
    n = 4096
    uv = rng.uniform(-3.0, 17.0, (n, 2)).astype(np.float32)
    tid = rng.integers(-1, 3, n).astype(np.int32)
    if mode in ("nearest", "bilinear_int"):
        lod = rng.integers(-1, 7, n).astype(np.int32)
    else:
        lod = rng.uniform(-0.5, 5.5, n).astype(np.float32)
    u_lod = rng.random(n, dtype=np.float32) if mode == "stochastic" else None
    if mode == "nearest":
        want = jtex.sample_nearest(js, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(lod))
        got = ptex.sample_nearest(ps, torch.from_numpy(tid), torch.from_numpy(uv),
                                  torch.from_numpy(lod))
    else:
        want = jtex.sample_bilinear(js, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(lod),
                                    None if u_lod is None else jnp.asarray(u_lod))
        got = ptex.sample_bilinear(ps, torch.from_numpy(tid), torch.from_numpy(uv),
                                   torch.from_numpy(lod),
                                   None if u_lod is None else torch.from_numpy(u_lod))
    assert got.dtype == torch.float32 and got.shape == (n, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=SAMPLE_ATOL)
    assert (got[torch.from_numpy(tid) < 0] == 1.0).all()


def test_ray_cone_lod_matches_reference(stacks):
    js, ps = stacks
    size = np.random.default_rng(5).uniform(0.0, 2.0, 4096).astype(np.float32)
    size[:4] = (0.0, 1.0 / 16, 1.0, 100.0)
    for fractional in (True, False):
        want = np.asarray(jtex.ray_cone_lod(js, jnp.asarray(size), fractional))
        got = ptex.ray_cone_lod(ps, torch.from_numpy(size), fractional).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=REL, atol=REL)


def test_env_tables_match_reference():
    """build_env_dist2d within 1e-6, the mip sum pyramid bit for bit,
    env_mip_dims equal, on a non-power-of-2 map with a hot spot."""
    rng = np.random.default_rng(6)
    lum = rng.random((12, 20), dtype=np.float32)
    lum[3, 7] = 500.0
    jd, pd = jdist.build_env_dist2d(lum), pdist.build_env_dist2d(lum)
    for a, b in ((pd.marginal.pdf, jd.marginal.pdf), (pd.marginal.cdf, jd.marginal.cdf),
                 (pd.cond_pdf, jd.cond_pdf), (pd.cond_cdf, jd.cond_cdf)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TABLE_ATOL, atol=TABLE_ATOL)
    assert schema.env_mip_dims(12, 20) == jschema.env_mip_dims(12, 20)
    np.testing.assert_array_equal(schema.build_env_mips(lum), jschema.build_env_mips(lum))


def _env_scenes():
    """The Cornell box without its light under an equirect image (the
    port's and the reference's graph from the same numpy image) -> (the
    reference's scene, the port's flatten of it, the port's scene bridged
    from the reference's, with the reference's tables)."""
    img = np.random.default_rng(8).random((16, 32, 3), dtype=np.float32) * 2.0
    img[4, 9] = 300.0
    out = []
    for bmod, fmod, gmod in ((jbuiltin, jflatten, jgraph), (builtin, flatten, graph)):
        g = bmod.cornell_box(light_scale=0.0)
        g.root.add_child("sky").make_component(
            gmod.EnvironmentComponent(color=np.ones(3, np.float32), image=img))
        kw = {} if fmod is jflatten else dict(device="cpu")
        out.append(fmod.flatten(g.root, **kw)[0])
    return out + [bridge.scene_from_numpy(bridge.numpy_fields(out[0]), "cpu")]


@pytest.fixture(scope="module")
def env_scenes():
    return _env_scenes()


def test_flattened_env_tables_match_reference(env_scenes):
    """The port's flatten of an environment image: radiance and the mip sum
    pyramid equal, the 2D tables and the fused emission+pdf rows within
    1e-6."""
    js, ps, _ = env_scenes
    np.testing.assert_array_equal(ps.env.emission.numpy(), np.asarray(js.env.emission))
    np.testing.assert_array_equal(ps.env.lum_mips.numpy(), np.asarray(js.env.lum_mips))
    for a, b in ((ps.env.dist.marginal.cdf, js.env.dist.marginal.cdf),
                 (ps.env.dist.cond_cdf, js.env.dist.cond_cdf),
                 (ps.env.emission_pdf, js.env.emission_pdf)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TABLE_ATOL, atol=TABLE_ATOL)
    assert ps.lights.num_lights == 0 and ps.lights.env_probability == float(
        js.lights.env_probability)


@pytest.mark.parametrize("sampler", ["dist2d", "mip"])
def test_environment_sampling_matches_reference(env_scenes, monkeypatch, sampler):
    """Samples, solid-angle pdfs and the escape path's (radiance, MIS pdf)
    under both samplers, on the reference's own tables (bridged): tables
    that differ by 1e-6 would move a sample whose u lies that close to a
    CDF step into the neighbouring texel."""
    js, _, ps = env_scenes
    monkeypatch.setattr(jlights, "ENV_SAMPLER", sampler)
    monkeypatch.setattr(plights, "ENV_SAMPLER", sampler)
def _textured_scenes():
    """A quad with base color, emission, ORM and normal maps beside the
    Cornell box, its uvs reaching 4; both packages flatten it. The sources
    are 64 square, the stack's least resolution, so neither package
    resamples them."""
    rng = np.random.default_rng(10)
    imgs = [rng.random((64, 64, 3), dtype=np.float32) for _ in range(4)]
    pos = np.asarray([[0, 0, 0], [2, 0, 0], [2, 2, 0.5], [0, 2, 0]], np.float32)
    uv = np.asarray([[0, 0], [4, 0], [4, 3], [0, 3]], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    out = []
    for bmod, fmod, gmod, mmod in ((jbuiltin, jflatten, jgraph, jmaterial),
                                   (builtin, flatten, graph, material)):
        g = bmod.cornell_box()
        m = mmod.Material(base_color=np.ones(3, np.float32), emission=np.full(3, 0.5, np.float32),
                          roughness=0.7, metallic=0.4, base_color_image=imgs[0],
                          emission_image=imgs[1], rough_metal_image=imgs[2],
                          normal_image=imgs[3])
        g.root.add_child("tex").make_component(
            gmod.MeshPrimitive(positions=pos, indices=idx, uvs=uv, material=m))
        kw = {} if fmod is jflatten else dict(device="cpu")
        out.append(fmod.flatten(g.root, **kw)[0])
    return out


def test_texture_shading_terms_match_reference():
    """shading_point_from_row's texture inputs, apply_textures (with and
    without the gathered material rows) and apply_normal_map on hits of
    the textured quad and untextured walls, at float LODs."""
    js, ps = _textured_scenes()
    assert ps.textures.slot_mask == js.textures.slot_mask == 15
    np.testing.assert_array_equal(ps.textures.flat.numpy().view(np.uint16),
                                  np.asarray(js.textures.flat).view(np.uint16))
    rng = np.random.default_rng(11)
    n = 2048
    real = int((ps.geo.tri_material >= 0).sum())
    tri = rng.integers(real - 8, real, n).astype(np.int32)  # the quad and walls
    bary = rng.dirichlet((1, 1, 1), n)[:, :2].astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    lod = rng.uniform(0.0, 4.0, n).astype(np.float32)
    jsp = jshading.make_shading_point(js.geo, jnp.asarray(tri), jnp.asarray(bary), jnp.asarray(d))
    rows = ps.geo.packed_tri[torch.from_numpy(tri).long()]
    psp = pshading.shading_point_from_row(rows, torch.from_numpy(tri), torch.from_numpy(bary),
                                          torch.from_numpy(d), textured=True)
    for f in ("uv", "tangent", "uv_area", "shading_normal"):
        np.testing.assert_allclose(getattr(psp, f).numpy(), np.asarray(getattr(jsp, f)),
                                   rtol=REL, atol=REL, err_msg=f)
    np.testing.assert_array_equal(psp.material.numpy(), np.asarray(jsp.material))
    jm = jshading.load_material(js.materials, jsp.material)
    jt = jshading.apply_textures(jm, js.materials, js.textures, jsp.material, jsp.uv,
                                 jnp.asarray(lod))
    mrow = ps.materials.packed[torch.clamp(psp.material, min=0).long()]
    pm = pshading.material_from_row(mrow)
    for mat_row in (None, mrow):
        pt = pshading.apply_textures(pm, ps.materials, ps.textures, psp.material, psp.uv,
                                     torch.from_numpy(lod), mat_row=mat_row)
        for f in pt._fields:
            np.testing.assert_allclose(getattr(pt, f).numpy(), np.asarray(getattr(jt, f)),
                                       rtol=REL, atol=REL, err_msg=f)
    jn = jshading.apply_normal_map(jsp, js.materials, js.textures, jnp.asarray(lod))
    ntex = ps.materials.normal_tex[torch.clamp(psp.material, min=0).long()]
    for tex_id in (None, ntex.to(torch.float32)):
        pn = pshading.apply_normal_map(psp, ps.materials, ps.textures, torch.from_numpy(lod),
                                       tex_id=tex_id)
        np.testing.assert_allclose(pn.numpy(), np.asarray(jn), rtol=REL, atol=REL)


@pytest.mark.parametrize("budget", [None, 2 * 256 * 256 * 53])
def test_stack_resolution_and_budget_match_reference(monkeypatch, budget):
    """The stack's resolution (the largest source side, 300 -> 512) and its
    clamp under TEX_BUDGET_BYTES (two textures at 512^2 pass a budget of
    two 256^2 stacks: clamped to 256 with a warning) as the reference
    decides them."""
    rng = np.random.default_rng(13)
    imgs = [rng.random((300, 200, 3), dtype=np.float32), rng.random((64, 64, 3), dtype=np.float32)]
    if budget is not None:
        monkeypatch.setattr(jflatten, "TEX_BUDGET_BYTES", budget)
        monkeypatch.setattr(flatten, "TEX_BUDGET_BYTES", budget)
    res = []
    for bmod, fmod, gmod, mmod in ((jbuiltin, jflatten, jgraph, jmaterial),
                                   (builtin, flatten, graph, material)):
        g = bmod.cornell_box(boxes=False)
        for i, img in enumerate(imgs):
            g.root.add_child(f"tex{i}").make_component(gmod.MeshPrimitive(
                positions=np.eye(3, dtype=np.float32), indices=np.asarray([[0, 1, 2]], np.int32),
                material=mmod.Material(base_color_image=img)))
        kw = {} if fmod is jflatten else dict(device="cpu")
        if budget is None:
            res.append(fmod.flatten(g.root, **kw)[0].textures.resolution)
        else:
            with pytest.warns(UserWarning, match="texture stack clamped to 256"):
                res.append(fmod.flatten(g.root, **kw)[0].textures.resolution)
    assert res[0] == res[1] == (512 if budget is None else 256)
