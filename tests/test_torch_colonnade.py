"""The textured colonnade (bench.py's config 4 at test size) through the
port: the sample-asset writer, the OBJ + MTL loader, flatten's texture stack
and environment tables, and textured renders (stratum_tpu_torch/scene/
sample_assets.py, scene/loaders/obj.py, scene/flatten.py, render/
integrator.py) against the JAX reference and its golden image.

The asset is the golden's (tests/update_goldens.py:57-64): 3 columns, seg
12, rings 6, 64-texel textures and a 64-wide sky, 1,208 triangles (1,280
padded, so ``auto`` resolves to the dense tracer in both packages). Every
package writes into its own ``tmp_path`` directory, so neither reads the
other's ``sky.hdr.dists.npz`` cache.

Bounds. Written files equal byte for byte; loaded meshes and material
images equal; flattened tables equal bit for bit except the 2D env tables
(numpy against XLA sums: within 1e-6). Renders, those of
test_torch_dense_path.py: image mean within 2 % relative, >= 97 % of pixels
within 1e-3 (abs + rel). Measured on the first run: the golden's mean to
8.5e-8 relative with every pixel within 1e-3 (auto), the block kernel's
plain version against the dense tracer the same; the stochastic filter's
mean 8.2e-4 from the trilinear one at 8 spp.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from stratum_tpu.scene import flatten as jflatten
from stratum_tpu.scene import sample_assets as jassets
from stratum_tpu.scene.loaders import obj as jobj
from stratum_tpu_torch.render import camera, integrator
from stratum_tpu_torch.scene import flatten, sample_assets
from stratum_tpu_torch.scene.loaders import obj

torch.set_num_threads(2)

ASSET = dict(columns=3, seg=12, rings=6, tex_res=64, env_res=64)
GOLDEN_CFG = dict(width=48, height=48, rr_depth=100, max_bounces=2, bsdf="disney",
                  presample_lights=256)
GOLDEN_SPP = 8
MEAN_REL = 0.02
PIXEL_SHARE = 0.97
TABLE_ATOL = 1e-6
FILES = ("colonnade.obj", "colonnade.mtl", "floor.png", "wall.png", "column.png", "sky.hdr")


def _agree(img, ref):
    img, ref = np.asarray(img), np.asarray(ref)
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert abs(img.mean() - ref.mean()) <= MEAN_REL * ref.mean(), (img.mean(), ref.mean())
    pix = np.all(np.abs(img - ref) <= 1e-3 * (1 + np.abs(ref)), axis=-1).mean()
    assert pix >= PIXEL_SHARE, pix


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Both packages' asset directories, written and loaded."""
    root = tmp_path_factory.mktemp("colonnade")
    jg, jinfo = jassets.load_colonnade(root / "ref", **ASSET)
    pg, pinfo = sample_assets.load_colonnade(root / "port", **ASSET)
    return dict(root=root, jg=jg, jinfo=jinfo, pg=pg, pinfo=pinfo)


@pytest.fixture(scope="module")
def scenes(assets):
    from stratum_tpu.render import camera as jcamera

    js, jstats = jflatten.flatten(assets["jg"].root)
    ps, pstats = flatten.flatten(assets["pg"].root, device="cpu")
    node, cam = flatten.find_camera(assets["pg"].root)
    view = camera.make_view(node.to_world(), cam.fovy, 48, 48, device="cpu")
    jnode, jcam = jflatten.find_camera(assets["jg"].root)
    jview = jcamera.make_view(jnode.to_world(), jcam.fovy, 48, 48)
    return dict(js=js, jstats=jstats, ps=ps, pstats=pstats, view=view, jview=jview)


def test_written_files_are_the_references(assets):
    root = assets["root"]
    for name in FILES:
        assert (root / "port" / name).read_bytes() == (root / "ref" / name).read_bytes(), name
    j, p = assets["jinfo"], assets["pinfo"]
    assert p["num_triangles"] == j["num_triangles"] == 1208
    for k in ("eye", "target", "fovy"):
        np.testing.assert_array_equal(p[k], j[k])


def test_obj_load_matches_reference(assets):
    """Meshes from the same file: positions, indices, uvs, normals and
    material fields (the decoded textures: sRGB to linear, as RGBA)."""
    path = assets["root"] / "ref" / "colonnade.obj"
    jm, pm = jobj.load_obj_meshes(path), obj.load_obj_meshes(path)
    assert [m.name for m in pm] == [m.name for m in jm] == ["floor", "wall", "column"]
    for a, b in zip(pm, jm):
        for f in ("positions", "normals", "uvs", "indices"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert a.material.name == b.material.name
        for f in ("base_color", "emission", "roughness", "eta"):
            np.testing.assert_array_equal(getattr(a.material, f), getattr(b.material, f))
        np.testing.assert_array_equal(a.material.base_color_image, b.material.base_color_image)
        assert a.material.base_color_image.shape == (64, 64, 4)


def test_flatten_matches_reference(scenes):
    """The texture stack (count, resolution, levels, slot mask, both f16
    atlases), the geometry and material tables, the LBVH and the
    environment tables of the two flattens."""
    js, ps = scenes["js"], scenes["ps"]
    jt, pt = js.textures, ps.textures
    assert (pt.num_tex, pt.base_res, pt.num_levels, pt.slot_mask) == (
        jt.num_tex, jt.base_res, jt.num_levels, jt.slot_mask) == (3, 64, 7, 1)
    for a in ("flat", "quad"):
        np.testing.assert_array_equal(getattr(pt, a).numpy().view(np.uint16),
                                      np.asarray(getattr(jt, a)).view(np.uint16))
    for f in ("positions", "normals", "uvs", "indices", "tri_material", "packed_tri"):
        np.testing.assert_array_equal(getattr(ps.geo, f).numpy(), np.asarray(getattr(js.geo, f)))
    np.testing.assert_array_equal(ps.materials.packed.numpy(), np.asarray(js.materials.packed))
    for f in ps.bvh._fields:
        np.testing.assert_array_equal(getattr(ps.bvh, f).numpy(), np.asarray(getattr(js.bvh, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(ps.env.emission.numpy(), np.asarray(js.env.emission))
    np.testing.assert_array_equal(ps.env.lum_mips.numpy(), np.asarray(js.env.lum_mips))
    np.testing.assert_allclose(ps.env.emission_pdf.numpy(), np.asarray(js.env.emission_pdf),
                               rtol=TABLE_ATOL, atol=TABLE_ATOL)
    assert ps.lights.env_probability == float(js.lights.env_probability)


def test_env_cache_is_written_and_read(assets, tmp_path):
    """flatten caches the env tables beside the HDR and reads them back; a
    stale cache (another image) is rebuilt."""
    sky = tmp_path / "sky.hdr"
    sky.write_bytes((assets["root"] / "port" / "sky.hdr").read_bytes())
    lum = np.random.default_rng(0).random((32, 64), dtype=np.float32)
    d1, m1 = flatten.env_tables(lum, sky)
    assert (tmp_path / "sky.hdr.dists.npz").exists()
    d2, m2 = flatten.env_tables(lum, sky)
    np.testing.assert_array_equal(d1.cond_cdf, d2.cond_cdf)
    np.testing.assert_array_equal(m1, m2)
    d3, _ = flatten.env_tables(lum * 2 + 1, sky)
    assert not np.array_equal(d3.cond_pdf, d1.cond_pdf)


@pytest.fixture(scope="module")
def golden_render(scenes):
    """The golden's configuration rendered by the port (auto)."""
    cfg = integrator.RenderConfig(**GOLDEN_CFG)
    assert integrator.resolved_tracer(scenes["ps"], cfg) == "mxu"
    return integrator.render_path_progressive(scenes["ps"], scenes["view"], cfg, GOLDEN_SPP)


def test_golden_image(golden_render):
    """The reference's colonnade_textured golden (48x48, 8 spp, auto ->
    the dense tracer; the tri_payload texture path)."""
    _agree(golden_render.numpy(),
           np.load(Path(__file__).parent / "golden" / "colonnade_textured.npy"))


def test_block_kernel_path_matches_dense(scenes):
    """The block kernel's plain version (``tracer="pallas"``: tiled pixels,
    sorted waves, the slot payload's texture columns 63-87) against the
    dense tracer, 4 spp."""
    ps, view = scenes["ps"], scenes["view"]
    cfg = integrator.RenderConfig(**GOLDEN_CFG)
    dense = integrator.render_path_progressive(ps, view, cfg, 4)
    block = integrator.render_path_progressive(
        ps, view, integrator.RenderConfig(**dict(GOLDEN_CFG, tracer="pallas")), 4)
    _agree(block.numpy(), dense.numpy())


def test_stochastic_filter_matches_trilinear(scenes, golden_render):
    """tex_filter="stochastic" takes one extra draw per bounce; its image
    mean stays within the golden bound of the trilinear render's."""
    tri = golden_render
    sto = integrator.render_path_progressive(
        scenes["ps"], scenes["view"],
        integrator.RenderConfig(**dict(GOLDEN_CFG, tex_filter="stochastic")), GOLDEN_SPP)
    assert np.isfinite(sto.numpy()).all()
    assert abs(float(sto.mean()) - float(tri.mean())) <= MEAN_REL * float(tri.mean())
    assert not torch.equal(sto, tri)


@pytest.mark.parametrize("tex_filter", ["trilinear", "stochastic"])
def test_render_matches_reference_per_sample(scenes, tex_filter):
    """One sample of render_path_with_counts on each package (seed 3, each
    package's own flatten and camera): the image and n_rays. A stochastic
    texture draw taken at another point of the RNG stream would shift every
    later draw and fail the pixel bound."""
    from stratum_tpu.render import integrator as jintegrator

    cfg = dict(GOLDEN_CFG, tex_filter=tex_filter)
    jimg, jn = jintegrator.render_path_with_counts(
        scenes["js"], scenes["jview"], jintegrator.RenderConfig(**cfg), 3)
    pimg, pn = integrator.render_path_with_counts(
        scenes["ps"], scenes["view"], integrator.RenderConfig(**cfg), 3)
    _agree(pimg.numpy(), jimg)
    assert abs(int(pn) - int(jn)) <= 0.01 * int(jn)
