"""The dense tracers (stratum_tpu_torch/ops/mxu.py, ops/intersect.py)
against the JAX reference's, and the dense scene tables against the JAX
scene's.

Inputs: 4096 seeded numpy rays per scene (origins inside the scene's
bounds, uniform directions, and every 5th ray from the camera), against the
Cornell box (36 triangles, padded to 128) and the material spheres at
12 x 24 (1,588 triangles, padded to 1,664: two 1,024-triangle chunks of the
dense tracer).

Bounds. The port and the reference compute the same Moller-Trumbore
quantities in f32 but sum them in other orders, so only rays whose hit is
not near a triangle edge can be held to the same triangle: those whose
reference barycentrics (u, v, 1 - u - v) all exceed 1e-4, and that are not
ties between coplanar triangles (the Cornell boxes' bottoms lie on the
floor): where the triangles differ, t must agree within 2^-12 relative, on
at most 0.5 % of the rays. On the others: the same ``tri``, ``t`` within
2^-12 relative, barycentrics within 1e-4. Occlusion
flags must be equal on rays whose limit t_max (1 - 1e-3) is not within 2^-12
relative of the reference's closest hit. Measured on the first run: every
ray that hits off an edge has the same triangle but 3 Cornell rays whose
floor and box-bottom hits tie (t equal to 1e-7 relative). The
scene tables are copies of the same rows (``tri_payload``: the reference
builds it but leaves SceneData.tri_payload None, so it is compared with the
rows it is made of); the features are cross products of coordinates up to
555, computed by numpy and XLA (FMA contraction may differ), and match to
2^-20 of each triangle's largest feature (measured: 1e-11).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.ops import intersect as jintersect
from stratum_tpu.ops import mxu as jmxu
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu_torch.ops import intersect, mxu
from stratum_tpu_torch.scene import builtin, flatten

torch.set_num_threads(2)

T_REL = 2.0 ** -12
EDGE = 1e-4
N = 4096
SCENES = {
    "cornell": (jbuiltin.cornell_box, builtin.cornell_box, {}),
    "spheres": (jbuiltin.material_spheres, builtin.material_spheres,
                dict(stacks=12, slices=24)),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    jmake, pmake, kw = SCENES[request.param]
    jg, pg = jmake(**kw), pmake(**kw)
    js, _ = jflatten.flatten(jg.root)
    ps, _ = flatten.flatten(pg.root, device="cpu")
    rng = np.random.default_rng(7)
    pos = np.asarray(js.geo.positions)[: int((np.asarray(js.geo.tri_material) >= 0).sum()) * 3]
    lo, hi = pos.min(axis=0), pos.max(axis=0)
    o = rng.uniform(lo, hi, (N, 3)).astype(np.float32)
    node, _ = jflatten.find_camera(jg.root)
    o[::5] = np.asarray(node.to_world())[:, 3]
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dict(name=request.param, js=js, ps=ps, o=o, d=d.astype(np.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _clean(ref):
    """Rays whose reference hit lies off every edge of its triangle."""
    bary = np.asarray(ref.bary)
    w = 1.0 - bary[:, 0] - bary[:, 1]
    return (np.asarray(ref.tri) >= 0) & (bary.min(axis=1) > EDGE) & (w > EDGE)


def _same_hits(h, ref):
    clean = _clean(ref)
    miss = np.asarray(ref.tri) < 0
    assert clean.sum() > N // 4, clean.sum()
    tri, t, rt = h.tri.numpy(), h.t.numpy(), np.asarray(ref.t)
    np.testing.assert_array_equal(tri[miss], -1)
    assert np.all(np.abs(t[clean] - rt[clean]) <= T_REL * rt[clean])
    tie = clean & (tri != np.asarray(ref.tri))
    assert tie.sum() <= 0.005 * N, tie.sum()
    same = clean & ~tie
    np.testing.assert_allclose(h.bary.numpy()[same], np.asarray(ref.bary)[same], atol=1e-4)


def test_intersect_mxu_matches_reference(case):
    js, ps = case["js"], case["ps"]
    ref = jmxu.intersect_mxu(jnp.asarray(case["o"]), jnp.asarray(case["d"]), js.tri_features)
    h = mxu.intersect_mxu(_t(case["o"]), _t(case["d"]), ps.tri_features)
    _same_hits(h, ref)


def test_brute_force_matches_reference(case):
    js, ps = case["js"], case["ps"]
    ref = jintersect.intersect_brute_force(jnp.asarray(case["o"]), jnp.asarray(case["d"]),
                                           js.geo.positions, js.geo.indices)
    h = intersect.intersect_brute_force(_t(case["o"]), _t(case["d"]), ps.geo.positions,
                                        ps.geo.indices)
    _same_hits(h, ref)


@pytest.mark.parametrize("tracer", ["mxu", "brute"])
def test_occluded_matches_reference(case, tracer):
    """Segments ending at 0.3-1.7x each ray's closest hit (1e4 on a miss)
    and some dead (t_max 0)."""
    js, ps = case["js"], case["ps"]
    o, d = case["o"], case["d"]
    ref = jintersect.intersect_brute_force(jnp.asarray(o), jnp.asarray(d), js.geo.positions,
                                           js.geo.indices)
    rt = np.where(np.asarray(ref.tri) >= 0, np.asarray(ref.t), 1e4).astype(np.float32)
    t_max = (rt * np.random.default_rng(3).uniform(0.3, 1.7, N)).astype(np.float32)
    t_max[::11] = 0.0
    if tracer == "mxu":
        want = jmxu.occluded_mxu(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                 js.tri_features)
        got = mxu.occluded_mxu(_t(o), _t(d), _t(t_max), ps.tri_features)
    else:
        want = jintersect.occluded_brute_force(jnp.asarray(o), jnp.asarray(d),
                                               jnp.asarray(t_max), js.geo.positions,
                                               js.geo.indices)
        got = intersect.occluded_brute_force(_t(o), _t(d), _t(t_max), ps.geo.positions,
                                             ps.geo.indices)
    limit = t_max * np.float32(1.0 - 1e-3)
    far = np.abs(limit - rt) > T_REL * rt
    want = np.asarray(want)
    assert 0 < want[far].sum() < far.sum()
    np.testing.assert_array_equal(got.numpy()[far], want[far])
    assert not got.numpy()[::11].any()


def test_chunking_changes_nothing(case):
    """Smaller triangle chunks and ray chunks give the same hits bit for
    bit on the brute force (a later chunk wins only when strictly closer)
    and the same triangles on the dense tracer (whose product is blocked
    differently)."""
    ps = case["ps"]
    o, d = _t(case["o"]), _t(case["d"])
    ref = intersect.intersect_brute_force(o, d, ps.geo.positions, ps.geo.indices)
    h = intersect.intersect_brute_force(o, d, ps.geo.positions, ps.geo.indices, chunk=32,
                                        t_max=torch.full((N,), intersect.T_MAX))
    for a, b in zip(h, ref):
        if a is not None:
            assert torch.equal(a, b)
    h = mxu.intersect_mxu(o, d, ps.tri_features, chunk=64, ray_chunk=1000)
    m = mxu.intersect_mxu(o, d, ps.tri_features)
    assert torch.equal(h.tri, m.tri)
    torch.testing.assert_close(h.t, m.t, rtol=T_REL, atol=0.0)
    occ = mxu.occluded_mxu(o, d, m.t * 1.01, ps.tri_features, chunk=64, ray_chunk=1000)
    assert torch.equal(occ, m.tri >= 0)


def test_scene_tables_match_reference(case):
    js, ps = case["js"], case["ps"]
    ref = np.asarray(js.tri_features)
    scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(ps.tri_features.numpy() - ref) <= 2.0 ** -20 * scale)
    assert js.tri_payload is None  # built but not stored by the reference
    rows = np.asarray(js.geo.packed_tri)
    mat = np.asarray(js.materials.packed)[np.maximum(rows[:, 24].astype(np.int64), 0)]
    np.testing.assert_array_equal(ps.tri_payload.numpy(), np.concatenate([rows, mat], axis=1))
    assert ps.tri_payload.shape == (ps.geo.num_triangles, 56)


def test_full_f32_turns_tf32_off_and_restores_the_setting():
    m = torch.backends.cuda.matmul
    name, on, off = (("fp32_precision", "tf32", "ieee") if hasattr(m, "fp32_precision")
                     else ("allow_tf32", True, False))
    before = getattr(m, name)
    setattr(m, name, on)
    try:
        with mxu.full_f32():
            assert getattr(m, name) == off
        assert getattr(m, name) == on
    finally:
        setattr(m, name, before)
