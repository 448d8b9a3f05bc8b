"""The port's tone mapping and small libraries against the JAX reference
(ROADMAP Queue 1 item 6): ``render/tonemap.py``, ``core/octahedral.py``,
``core/quaternion.py``, ``core/spline.py``, ``ops/anim.py`` and
``core/math.viridis``, on the same numpy-seeded inputs.

Bit for bit: ``pack_unit`` words (the port holds them as int64 in
[0, 2^32)), ``encode_oct``, the ``TonemapMode`` values. Within f32
tolerances: every tonemap operator (rtol 2e-6; ``filmic``'s power and
``viridis`` at 1e-5 absolute), ``reduce_max_color``, ``exposure_ema``,
``decode_oct`` / ``unpack_unit`` (1e-6), quaternions (1e-6), the spline
(1e-5) and skinning / blend shapes (1e-5): the two packages order a few
sums differently, and XLA's CPU code may contract a multiply-add.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.core import math as jmath
from stratum_tpu.core import octahedral as joct
from stratum_tpu.core import quaternion as jquat
from stratum_tpu.core import spline as jspline
from stratum_tpu.ops import anim as janim
from stratum_tpu.render import tonemap as jtonemap
from stratum_tpu_torch.core import math as pmath
from stratum_tpu_torch.core import octahedral as poct
from stratum_tpu_torch.core import quaternion as pquat
from stratum_tpu_torch.core import spline as pspline
from stratum_tpu_torch.ops import anim as panim
from stratum_tpu_torch.render import tonemap as ptonemap


def _hdr_image(seed=0, shape=(24, 20, 3)):
    """An HDR image: log-normal radiance over six stops, some zeros."""
    rng = np.random.default_rng(seed)
    img = np.exp(rng.normal(0.0, 1.5, shape)).astype(np.float32)
    img[rng.random(shape[:2]) < 0.05] = 0.0
    return img


def _units(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    # the axes and octant boundaries too
    axes = np.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
                       [0.6, 0.0, -0.8], [0.0, -0.6, -0.8]], np.float32)
    return np.concatenate([v, axes])


def test_mode_values_match_reference():
    assert [m.value for m in ptonemap.TonemapMode] == [m.value for m in jtonemap.TonemapMode]


@pytest.mark.parametrize("mode", [m.value for m in jtonemap.TonemapMode])
@pytest.mark.parametrize("exposure", [0.0, -1.5])
def test_tonemap_matches_reference(mode, exposure):
    img = _hdr_image(1)
    j = np.asarray(jtonemap.tonemap(jnp.asarray(img), jtonemap.TonemapMode(mode), exposure))
    p = ptonemap.tonemap(img, ptonemap.TonemapMode(mode), exposure)
    assert isinstance(p, torch.Tensor) and p.device.type == "cpu"
    atol = 1e-5 if mode in ("filmic", "viridis_r", "viridis_length") else 1e-7
    np.testing.assert_allclose(p.numpy(), j, rtol=2e-6, atol=atol)
    # a tensor in gives the same as the array, and a given max_value is used
    p2 = ptonemap.tonemap(torch.from_numpy(img), ptonemap.TonemapMode(mode), exposure, 3.0)
    j2 = np.asarray(jtonemap.tonemap(jnp.asarray(img), jtonemap.TonemapMode(mode), exposure,
                                     3.0))
    np.testing.assert_allclose(p2.numpy(), j2, rtol=2e-6, atol=atol)


def test_reduce_max_and_ema_match_reference():
    img = _hdr_image(2)
    jm, jl = jtonemap.reduce_max_color(jnp.asarray(img))
    pm, pl = ptonemap.reduce_max_color(img)
    assert float(pm) == float(jm)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
    for prev, cur, a in ((1.0, 4.0, 0.1), (7.5, 0.25, 0.3)):
        je = jtonemap.exposure_ema(jnp.float32(prev), jnp.float32(cur), a)
        pe = ptonemap.exposure_ema(torch.tensor(prev), torch.tensor(cur), a)
        np.testing.assert_allclose(float(pe), float(je), rtol=1e-7)


def test_viridis_matches_reference():
    t = np.linspace(-0.2, 1.2, 301, dtype=np.float32)
    np.testing.assert_allclose(pmath.viridis(torch.from_numpy(t)).numpy(),
                               np.asarray(jmath.viridis(jnp.asarray(t))), atol=1e-5)


def test_octahedral_matches_reference():
    n = _units(4000, 3)
    np.testing.assert_array_equal(poct.encode_oct(torch.from_numpy(n)).numpy(),
                                  np.asarray(joct.encode_oct(jnp.asarray(n))))
    jw = np.asarray(joct.pack_unit(jnp.asarray(n))).astype(np.int64)
    pw = poct.pack_unit(torch.from_numpy(n))
    assert pw.dtype == torch.int64 and int(pw.min()) >= 0 and int(pw.max()) < 2**32
    np.testing.assert_array_equal(pw.numpy(), jw)
    np.testing.assert_allclose(poct.unpack_unit(pw).numpy(),
                               np.asarray(joct.unpack_unit(jnp.asarray(jw.astype(np.uint32)))),
                               atol=1e-6)
    f = np.random.default_rng(4).uniform(-1, 1, (500, 2)).astype(np.float32)
    np.testing.assert_allclose(poct.decode_oct(torch.from_numpy(f)).numpy(),
                               np.asarray(joct.decode_oct(jnp.asarray(f))), atol=1e-6)
    # the round trip keeps directions to snorm16 precision
    assert (poct.unpack_unit(pw).numpy() * n).sum(-1).min() > 0.99999


def test_quaternion_matches_reference():
    rng = np.random.default_rng(5)
    axis = rng.normal(size=(64, 3)).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    jq = jquat.from_angle_axis(jnp.asarray(angle), jnp.asarray(axis))
    pq = pquat.from_angle_axis(torch.from_numpy(angle), torch.from_numpy(axis))
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), atol=1e-6)
    jq2 = jnp.roll(jq, 1, axis=0)
    pq2 = torch.roll(pq, 1, dims=0)
    for jf, pf, args in (
        (jquat.mul, pquat.mul, ((jq, jq2), (pq, pq2))),
        (jquat.conjugate, pquat.conjugate, ((jq,), (pq,))),
        (jquat.rotate_vector, pquat.rotate_vector, ((jq, jnp.asarray(v)),
                                                     (pq, torch.from_numpy(v)))),
        (jquat.to_matrix, pquat.to_matrix, ((jq,), (pq,))),
    ):
        np.testing.assert_allclose(pf(*args[1]).numpy(), np.asarray(jf(*args[0])), atol=2e-6)
    np.testing.assert_array_equal(pquat.identity().numpy(), np.asarray(jquat.identity()))


def test_spline_matches_reference():
    rng = np.random.default_rng(6)
    times = np.cumsum(rng.uniform(0.2, 1.0, 6)).astype(np.float32)
    values = rng.normal(size=(6, 3)).astype(np.float32)
    js = jspline.make_linear_spline(times, values)
    ps = pspline.make_linear_spline(times, values)
    for name in ("times", "values", "tangents_in", "tangents_out"):
        np.testing.assert_allclose(getattr(ps, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-6)
    # the reference evaluates one time a call; the port takes a vector too
    t = np.linspace(times[0] - 1.0, times[-1] + 1.0, 29, dtype=np.float32)
    ref = np.stack([np.asarray(jspline.evaluate(js, float(x))) for x in t])
    np.testing.assert_allclose(pspline.evaluate(ps, torch.from_numpy(t)).numpy(), ref,
                               atol=1e-5)
    for tk in (float(times[2]), 0.5 * float(times[1] + times[2])):
        np.testing.assert_allclose(pspline.evaluate(ps, tk).numpy(),
                                   np.asarray(jspline.evaluate(js, tk)), atol=1e-5)


def test_skinning_and_blend_shapes_match_reference():
    rng = np.random.default_rng(7)
    v, b, k = 200, 5, 3
    pos = rng.normal(size=(v, 3)).astype(np.float32)
    nrm = rng.normal(size=(v, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    ids = rng.integers(0, b, (v, 4)).astype(np.int32)
    wts = rng.random((v, 4)).astype(np.float32)
    wts /= wts.sum(-1, keepdims=True)
    mats = np.concatenate([np.linalg.qr(rng.normal(size=(b, 3, 3)))[0],
                           rng.normal(size=(b, 3, 1))], axis=-1).astype(np.float32)
    jp, jn = janim.skin_vertices(*(jnp.asarray(x) for x in (pos, nrm, ids, wts, mats)))
    pp, pn = panim.skin_vertices(*(torch.from_numpy(x) for x in (pos, nrm, ids, wts, mats)))
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(pn.numpy(), np.asarray(jn), atol=1e-5)
    dp = rng.normal(size=(k, v, 3)).astype(np.float32)
    dn = 0.1 * rng.normal(size=(k, v, 3)).astype(np.float32)
    w = rng.random(k).astype(np.float32)
    for ndelta in (dn, None):
        jp, jn = janim.blend_shapes(jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(dp),
                                    None if ndelta is None else jnp.asarray(ndelta),
                                    jnp.asarray(w))
        pp, pn = panim.blend_shapes(torch.from_numpy(pos), torch.from_numpy(nrm),
                                    torch.from_numpy(dp),
                                    None if ndelta is None else torch.from_numpy(ndelta),
                                    torch.from_numpy(w))
        np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=1e-5)
        np.testing.assert_allclose(pn.numpy(), np.asarray(jn), atol=1e-5)
