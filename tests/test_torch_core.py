"""The port's core math, transforms, camera, distributions, microfacet
terms and BSDFs against the JAX reference on the same numpy inputs.

Tolerance: both sides run the same f32 formulas, but XLA's CPU
transcendentals (sin, cos, atan2, acos, log, pow) differ from torch's by an
ulp or two and XLA may contract products into FMAs, so results agree to a
few ulps: rtol 1e-5 / atol 1e-6 where values are O(1); rtol 1e-4 / atol
1e-5 for the BSDF and pdf values, whose formulas divide by small cosines
and amplify those ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.core import distribution as jdist
from stratum_tpu.core import math as jmath
from stratum_tpu.core import microfacet as jmf
from stratum_tpu.core import transform as jxf
from stratum_tpu.render import bsdf as jbsdf
from stratum_tpu.render import camera as jcam
from stratum_tpu.render import disney as jdisney
from stratum_tpu.render import shading as jshading
from stratum_tpu_torch.core import distribution as pdist
from stratum_tpu_torch.core import math as pmath
from stratum_tpu_torch.core import microfacet as pmf
from stratum_tpu_torch.core import transform as pxf
from stratum_tpu_torch.ops import intersect as pintersect
from stratum_tpu_torch.render import bsdf as pbsdf
from stratum_tpu_torch.render import camera as pcam
from stratum_tpu_torch.render import disney as pdisney
from stratum_tpu_torch.render import shading as pshading

torch.set_num_threads(2)

TIGHT = dict(rtol=1e-5, atol=1e-6)
LOOSE = dict(rtol=1e-4, atol=1e-5)
N = 4096


def _close(p, j, tol=TIGHT):
    np.testing.assert_allclose(np.asarray(p), np.asarray(j), **tol)


def _unit(rng, n, upper=False):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    if upper:
        v[:, 2] = np.abs(v[:, 2]) + 1e-3
        v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.fixture
def rng():
    return np.random.default_rng(11)


@pytest.mark.parametrize("fn", [
    "normalize", "to_local", "to_world", "cartesian_to_spherical_uv",
    "make_orthonormal", "cross",
])
def test_vector_math(rng, fn):
    a = _unit(rng, N) * rng.uniform(0.1, 10, (N, 1)).astype(np.float32)
    n = _unit(rng, N)
    args = {"normalize": (a,), "to_local": (a, n), "to_world": (a, n),
            "cartesian_to_spherical_uv": (n,), "make_orthonormal": (n,),
            "cross": (a, n)}[fn]
    p = getattr(pmath, fn)(*map(_t, args))
    j = getattr(jmath, fn)(*map(jnp.asarray, args))
    for x, y in zip(p if isinstance(p, tuple) else (p,), j if isinstance(j, tuple) else (j,)):
        _close(x, y)


def test_sampling_math(rng):
    u = rng.random((N, 2), dtype=np.float32)
    _close(pmath.spherical_uv_to_cartesian(_t(u)), jmath.spherical_uv_to_cartesian(u))
    _close(pmath.sample_cos_hemisphere(_t(u[:, 0]), _t(u[:, 1])),
           jmath.sample_cos_hemisphere(u[:, 0], u[:, 1]))
    for x, y in zip(pmath.sample_uniform_triangle(_t(u[:, 0]), _t(u[:, 1])),
                    jmath.sample_uniform_triangle(u[:, 0], u[:, 1])):
        _close(x, y)
    b = rng.normal(size=N).astype(np.float32) * 1e-19
    _close(pmath.safe_div(_t(u[:, 0]), _t(b)), jmath.safe_div(u[:, 0], b))
    rgb = rng.random((N, 3), dtype=np.float32)
    _close(pmath.luminance(_t(rgb)), jmath.luminance(jnp.asarray(rgb)))


def test_transform_and_camera(rng):
    eye, target = (0.5, 4.0, -38.0), (1.0, 3.0, 40.0)
    c2w_p = pxf.look_at(eye, target)
    c2w_j = np.asarray(jxf.look_at(eye, target))
    _close(c2w_p, c2w_j)
    d = _unit(rng, N)
    _close(pxf.transform_vector(_t(c2w_j), _t(d)), jxf.transform_vector(c2w_j, d))
    w, h = 128, 64
    vp = pcam.make_view(c2w_j, 0.9, w, h, device="cpu")
    vj = jcam.make_view(c2w_j, 0.9, w, h)
    for field in ("scale", "offset", "near_plane", "sensor_area", "vertical_fov"):
        _close(getattr(vp.projection, field), getattr(vj.projection, field))
    th, tw = pcam.tile_dims(w, h)
    assert (th, tw) == jcam.tile_dims(w, h)
    ppx, ppy = pcam.pixel_grid_tiled(w, h, th, tw)
    jpx, jpy = jcam.pixel_grid_tiled(w, h, th, tw)
    np.testing.assert_array_equal(ppx.numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(ppy.numpy(), np.asarray(jpy))
    jit = rng.random((w * h, 2), dtype=np.float32)
    op, dp = pcam.generate_rays(vp, ppx, ppy, _t(jit), w, h)
    oj, dj = jcam.generate_rays(vj, jpx, jpy, jnp.asarray(jit), w, h)
    _close(op, oj)
    _close(dp, dj)
    img = rng.random((w * h, 3), dtype=np.float32)
    np.testing.assert_array_equal(
        pcam.untile_image(_t(img), w, h, th, tw).numpy(),
        np.asarray(jcam.untile_image(jnp.asarray(img), w, h, th, tw)),
    )


def test_ray_offset_bit_exact(rng):
    from stratum_tpu.ops.intersect import ray_offset as jray_offset

    p = (rng.normal(size=(N, 3)) * rng.choice([1e-3, 1.0, 30.0], (N, 1))).astype(np.float32)
    n = _unit(rng, N)
    np.testing.assert_array_equal(
        pintersect.ray_offset(_t(p), _t(n)).numpy(), np.asarray(jray_offset(p, n))
    )


@pytest.mark.parametrize("shape", [(7,), (16, 9), (1, 1)])
def test_distributions(rng, shape):
    w = rng.random(shape, dtype=np.float32) ** 3
    u = rng.random((N, 2), dtype=np.float32)
    if len(shape) == 1:
        dp, dj = pdist.build_dist1d(w), jdist.build_dist1d(w)
        _close(dp.pdf, dj.pdf)
        _close(dp.cdf, dj.cdf)
        dpt = pdist.Dist1D(_t(dp.pdf), _t(dp.cdf))
        for x, y in zip(pdist.sample_dist1d(dpt, _t(u[:, 0])),
                        jdist.sample_dist1d(dj, jnp.asarray(u[:, 0]))):
            _close(x, y)
        return
    dp, dj = pdist.build_dist2d(w), jdist.build_dist2d(w)
    dpt = pdist.Dist2D(pdist.Dist1D(_t(dp.marginal.pdf), _t(dp.marginal.cdf)),
                       _t(dp.cond_pdf), _t(dp.cond_cdf))
    uv_p, pdf_p = pdist.sample_dist2d(dpt, _t(u[:, 0]), _t(u[:, 1]))
    uv_j, pdf_j = jdist.sample_dist2d(dj, jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1]))
    _close(uv_p, uv_j)
    _close(pdf_p, pdf_j)


def _material(rng, n, kind):
    """Random Disney parameters; ``kind`` biases toward one lobe family."""
    m = dict(
        base_color=rng.random((n, 3), dtype=np.float32),
        emission=np.zeros((n, 3), np.float32),
        metallic=rng.random(n, dtype=np.float32),
        roughness=rng.uniform(0.05, 1.0, n).astype(np.float32),
        anisotropic=rng.random(n, dtype=np.float32) * 0.8,
        subsurface=rng.random(n, dtype=np.float32),
        clearcoat=rng.random(n, dtype=np.float32),
        clearcoat_gloss=rng.random(n, dtype=np.float32),
        transmission=rng.random(n, dtype=np.float32),
        eta=rng.uniform(1.1, 1.8, n).astype(np.float32),
    )
    if kind == "diffuse":
        m["metallic"][:] = 0.0
        m["transmission"][:] = 0.0
    elif kind == "glass":
        m["metallic"][:] = 0.0
        m["transmission"][:] = 1.0
    return (pshading.MaterialSample(**{k: _t(v) for k, v in m.items()}),
            jshading.MaterialSample(**{k: jnp.asarray(v) for k, v in m.items()}))


def _lanes_close(p, j, tol=LOOSE):
    """Share of lanes whose every component is within ``tol``."""
    p, j = np.asarray(p), np.asarray(j)
    ok = np.isclose(p, j, rtol=tol["rtol"], atol=tol["atol"])
    return ok.reshape(ok.shape[0], -1).all(axis=1).mean()


# random materials and directions include near-singular lanes (grazing
# cosines, refraction half-vector denominators near zero) where an ulp of
# difference grows past LOOSE. Measured lanes within LOOSE: eval 100 %;
# sample 99.98 % for wi, 99.37-99.73 % for f and the pdfs (f is steep where
# wi grazes). So >= 99 % must be, and eval must stay finite alike.
DISNEY_LANES = 0.99


@pytest.mark.parametrize("kind", ["mixed", "diffuse", "glass"])
def test_disney_eval_and_sample(rng, kind):
    mp, mj = _material(rng, N, kind)
    wo = _unit(rng, N, upper=True)
    wi = _unit(rng, N)
    ep = pdisney.disney_eval(mp, _t(wo), _t(wi))
    ej = jdisney.disney_eval(mj, jnp.asarray(wo), jnp.asarray(wi))
    for x, y in zip(ep, ej):
        np.testing.assert_array_equal(np.isfinite(x.numpy()), np.isfinite(np.asarray(y)))
        assert _lanes_close(x, y) >= DISNEY_LANES
    u = rng.random((N, 3), dtype=np.float32)
    sp = pdisney.disney_sample(mp, _t(wo), _t(u))
    sj = jdisney.disney_sample(mj, jnp.asarray(wo), jnp.asarray(u))
    for x, y in zip(sp, sj):
        assert _lanes_close(x, y) >= DISNEY_LANES


def test_lambert_and_microfacet(rng):
    mp, mj = _material(rng, N, "diffuse")
    wo = _unit(rng, N)
    wi = _unit(rng, N)
    for x, y in zip(pbsdf.lambert_eval(mp, _t(wo), _t(wi)),
                    jbsdf.lambert_eval(mj, jnp.asarray(wo), jnp.asarray(wi))):
        _close(x, y)
    u = rng.random((N, 3), dtype=np.float32)
    for x, y in zip(pbsdf.lambert_sample(mp, _t(wo), _t(u)),
                    jbsdf.lambert_sample(mj, jnp.asarray(wo), jnp.asarray(u))):
        _close(x, y)
    wo_up = _unit(rng, N, upper=True)
    ax, ay = (rng.uniform(1e-3, 1.0, N).astype(np.float32) for _ in range(2))
    h = pmf.sample_vndf(_t(wo_up), _t(ax), _t(ay), _t(u[:, 0]), _t(u[:, 1]))
    _close(h, jmf.sample_vndf(wo_up, ax, ay, u[:, 0], u[:, 1]), LOOSE)
    hj = np.asarray(h)
    _close(pmf.vndf_pdf(_t(wo_up), h, _t(ax), _t(ay)),
           jmf.vndf_pdf(wo_up, hj, ax, ay), LOOSE)
    _close(pmf.gtr2_ndf(h, _t(ax), _t(ay)), jmf.gtr2_ndf(hj, ax, ay), LOOSE)
    _close(pmf.smith_g1(_t(wo), _t(ax), _t(ay)), jmf.smith_g1(wo, ax, ay))
    cos = rng.uniform(-1, 1, N).astype(np.float32)
    eta = rng.uniform(0.5, 2.0, N).astype(np.float32)
    _close(pmf.fresnel_dielectric(_t(cos), _t(eta)), jmf.fresnel_dielectric(cos, eta))
    _close(pmf.gtr1_ndf(_t(cos), _t(ax)), jmf.gtr1_ndf(cos, ax), LOOSE)
    _close(pmf.sample_gtr1(_t(ax), _t(u[:, 0]), _t(u[:, 1])),
           jmf.sample_gtr1(ax, u[:, 0], u[:, 1]), LOOSE)
    wt_p, ok_p = pmf.refract(_t(wo_up), h, _t(eta))
    wt_j, ok_j = jmf.refract(wo_up, hj, eta)
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))
    _close(wt_p, wt_j, LOOSE)
    _close(pmf.reflect(_t(wo_up), h), jmf.reflect(wo_up, hj))


def test_shading_point_and_terminator(rng):
    rows = rng.normal(size=(N, 32)).astype(np.float32)
    rows[:, 24:27] = rng.integers(-1, 4, (N, 3))
    rows[:, 27:] = 0.0  # no analytic-sphere rows on the port's path
    tri = rng.integers(-1, 100, N).astype(np.int32)
    bary = rng.random((N, 2), dtype=np.float32) * 0.5
    d = _unit(rng, N)
    sp = pshading.shading_point_from_row(_t(rows), _t(tri), _t(bary), _t(d), textured=True)
    sj = jshading.shading_point_from_row(rows, tri, bary, d)
    for field in pshading.ShadingPoint._fields:
        _close(getattr(sp, field), getattr(sj, field))
    # untextured, the texture inputs are not computed
    plain = pshading.shading_point_from_row(_t(rows), _t(tri), _t(bary), _t(d))
    assert plain.uv is None and plain.tangent is None and plain.uv_area is None
    assert torch.equal(plain.shading_normal, sp.shading_normal)
    _close(pshading.shadow_terminator_factor(sp.geom_normal, sp.shading_normal, _t(d)),
           jshading.shadow_terminator_factor(sj.geom_normal, sj.shading_normal, d))
    mrow = rng.random((N, 24), dtype=np.float32)
    for x, y in zip(pshading.material_from_row(_t(mrow)), jshading.material_from_row(mrow)):
        _close(x, y)
