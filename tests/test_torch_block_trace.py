"""The port's block tracer (stratum_tpu_torch/ops/block_trace.py) against the
JAX reference on the tiny atrium (1,258 triangles, 13 SAH leaves of 256):
camera rays plus random secondary rays, the same inputs (numpy, fixed seed)
through both packages.

- ``block_closest_plain`` against ``pallas_closest`` (kernel K1 in interpret
  mode, default GS=4) and against ``packet_closest`` (compared by triangle
  id through ``leaf_tri[slot]``); ``block_occluded_plain`` against
  ``pallas_occluded`` (K2 in interpret mode).
- ``candidate_lists`` (the plain list phase) at the reference's 2048-ray
  blocks and at the kernel's 128-ray CTAs, ``finalize_hit`` and the raysort
  keys against the reference, bit for bit.
- A walk written exactly as the CUDA kernel walks (each 128-ray CTA with
  its own list of live rays, front-to-back groups, early exit on the CTA's
  largest best, per-ray pretests, each leaf's real triangles, packed-key
  commits) against the plain version, so the kernel's traversal logic is
  checked here too; the kernel itself runs only on a GPU
  (``test_kernel_matches_plain_on_gpu``).

Tolerances: the reference kernel packs the slot index into the low 10
mantissa bits of t (<= 2^-13 relative) and runs a bf16-split matmul, so
near-tie hits may pick another slot: slots must agree on >= 99.5 % of rays,
and t within 2^-12 relative where they agree (see the closest test for the
few rays where the split products lose more).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.ops import packet as jpacket
from stratum_tpu.ops import pallas_trace
from stratum_tpu.ops import raysort as jraysort
from stratum_tpu.ops.bvh import morton3 as jmorton3
from stratum_tpu.render import camera as jcamera
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu_torch.ops import block_trace, raysort
from stratum_tpu_torch.ops.bvh import morton3
from stratum_tpu_torch.ops.intersect import T_MAX
from stratum_tpu_torch.ops.packet import FatBVH, leaf_counts
from stratum_tpu_torch.scene import bridge, builtin, flatten

torch.set_num_threads(2)

SLOT_AGREE = 0.995
T_REL = 2.0 ** -12
W, H = 64, 32


@pytest.fixture(scope="module")
def case():
    """The tiny atrium in both packages and 4096 rays (2048 camera rays,
    2048 random rays from inside the hall) with t_max per ray."""
    g = jbuiltin.atrium(columns=1, stacks=6, slices=12)
    js, _ = jflatten.flatten(g.root)
    ps = bridge.scene_from_numpy(bridge.numpy_fields(js), "cpu")
    node, cam = jflatten.find_camera(g.root)
    view = jcamera.make_view(node.to_world(), cam.fovy, W, H)
    px, py = jcamera.pixel_grid(W, H)
    rng = np.random.default_rng(7)
    jit = jnp.asarray(rng.random((W * H, 2), dtype=np.float32))
    o_cam, d_cam = jcamera.generate_rays(view, px, py, jit, W, H)
    n2 = 2048
    o_rand = rng.uniform([-11, 0.2, -39], [11, 9.5, 39], (n2, 3)).astype(np.float32)
    d_rand = rng.normal(size=(n2, 3)).astype(np.float32)
    d_rand /= np.linalg.norm(d_rand, axis=1, keepdims=True)
    o = np.concatenate([np.asarray(o_cam), o_rand]).astype(np.float32)
    d = np.concatenate([np.asarray(d_cam), d_rand]).astype(np.float32)
    t_max = np.full(o.shape[0], T_MAX, np.float32)
    t_max[::7] = 0.0  # dead lanes
    t_max[3::7] = rng.uniform(0.5, 30.0, t_max[3::7].shape).astype(np.float32)
    return dict(js=js, ps=ps, o=o, d=d, t_max=t_max)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _plain_closest(case):
    return block_trace.block_closest_plain(
        case["ps"].fat_bvh, _t(case["o"]), _t(case["d"]), _t(case["t_max"])
    )


def test_closest_plain_matches_pallas_interpret(case):
    js = case["js"]
    hj = pallas_trace.pallas_closest(
        js.fat_bvh, js.leaf_feat_packed, jnp.asarray(case["o"]),
        jnp.asarray(case["d"]), t_max=jnp.asarray(case["t_max"]), block=256,
        interpret=True, slot_payload=js.slot_payload,
    )
    hp = _plain_closest(case)
    sj, sp = np.asarray(hj.slot), hp.slot.numpy()
    agree = (sj == sp).mean()
    # measured: 1.0 on this case
    assert agree >= SLOT_AGREE, agree
    both = (sj == sp) & (sp >= 0)
    assert both.sum() > 1000
    # the reference's c48 bf16-split products drop the lo*lo term (~2^-16
    # of each product), which t_num = o.n - p0.n can amplify where the two
    # terms nearly cancel: measured 3 of 2539 agreeing rays beyond 2^-12,
    # at most 2^-9 relative. 2^-12 must hold on >= 99.5 % of them, and no
    # ray may be off by more than 2^-8.
    rel = np.abs(hp.t.numpy()[both] - np.asarray(hj.t)[both]) / np.asarray(hj.t)[both]
    assert (rel <= T_REL).mean() >= SLOT_AGREE, (rel > T_REL).sum()
    assert rel.max() <= 2.0 ** -8, rel.max()
    assert (hp.t.numpy()[sp < 0] == T_MAX).all()


def test_closest_plain_matches_packet_by_triangle(case):
    js = case["js"]
    hj = jpacket.packet_closest(
        js.fat_bvh, jnp.asarray(case["o"]), jnp.asarray(case["d"]),
        t_max=jnp.asarray(case["t_max"]), block=256,
    )
    hp = _plain_closest(case)
    leaf_tri = case["ps"].fat_bvh.leaf_tri.reshape(-1).numpy()
    tri = np.where(hp.slot.numpy() >= 0, leaf_tri[np.maximum(hp.slot.numpy(), 0)], -1)
    tj = np.asarray(hj.tri)
    assert (tri == tj).mean() >= SLOT_AGREE
    both = (tri == tj) & (tj >= 0)
    np.testing.assert_allclose(hp.t.numpy()[both], np.asarray(hj.t)[both], rtol=T_REL)


def test_occluded_plain_matches_pallas_interpret(case):
    js = case["js"]
    oj = np.asarray(pallas_trace.pallas_occluded(
        js.fat_bvh, js.leaf_feat_packed, jnp.asarray(case["o"]),
        jnp.asarray(case["d"]), jnp.asarray(case["t_max"]), block=256,
        interpret=True,
    ))
    op = block_trace.block_occluded_plain(
        case["ps"].fat_bvh, _t(case["o"]), _t(case["d"]), _t(case["t_max"])
    ).numpy()
    assert (oj == op).mean() >= SLOT_AGREE
    assert not op[case["t_max"] == 0].any()
    assert 0.05 < op.mean() < 0.95  # the case has both outcomes


def test_wrappers_take_the_plain_version_on_cpu(case):
    fat = case["ps"].fat_bvh
    o, d, tm = _t(case["o"]), _t(case["d"]), _t(case["t_max"])
    before = dict(block_trace.LAUNCHES)
    h = block_trace.block_closest(fat, o, d, tm)
    hp = block_trace.block_closest_plain(fat, o, d, tm)
    assert torch.equal(h.slot, hp.slot) and torch.equal(h.t, hp.t)
    occ = block_trace.block_occluded(fat, o, d, tm)
    assert torch.equal(occ, block_trace.block_occluded_plain(fat, o, d, tm))
    assert block_trace.LAUNCHES == before  # no kernel launch on the CPU


def test_launch_refuses_cpu_tensors(case):
    fat = case["ps"].fat_bvh
    o, d, tm = _t(case["o"]), _t(case["d"]), _t(case["t_max"])
    prep = block_trace._prepare(fat, o, d, tm)
    with pytest.raises(ValueError, match="CUDA"):
        block_trace.launch(fat, prep, occluded=False)


def test_lists_past_the_shared_budget_take_the_global_mode(monkeypatch):
    """A CTA sorts all its list keys in shared memory up to AUTO_SHARED_KEYS
    keys and culls past that ("culled": only the reached keys, sorted in
    shared memory, or in the CTA's global scratch row when they exceed
    CULL_LIST_KEYS): no group count is refused, the choice follows the keys
    (checked here with the budget made small), the shared mode (where its
    MAX_LIST_KEYS hold the keys), the culled mode and its overflow path
    ("global") can be forced, and the scratch holds LIST_SCRATCH_BYTES of
    overflow rows (the wave's CTAs at most)."""
    assert block_trace.list_keys(4097) == 8192 and block_trace.list_keys(1) == 1
    assert block_trace.resolve_list_mode(512) == "shared"
    assert block_trace.resolve_list_mode(513) == "culled"
    assert block_trace.resolve_list_mode(4096, "shared") == "shared"
    assert block_trace.resolve_list_mode(16, "global") == "global"
    assert block_trace.resolve_list_mode(16, "culled") == "culled"
    with pytest.raises(ValueError, match="shared mode"):
        block_trace.resolve_list_mode(4097, "shared")
    monkeypatch.setattr(block_trace, "AUTO_SHARED_KEYS", 16)
    assert [block_trace.resolve_list_mode(g) for g in (9, 16, 17, 100)] == [
        "shared", "shared", "culled", "culled"]
    assert block_trace.list_scratch_ctas(16384, 10**6) == (1 << 29) // (8 * 16384)
    assert block_trace.list_scratch_ctas(16384, 7) == 7
    with pytest.raises(ValueError, match="list_mode"):
        block_trace.resolve_list_mode(16, "sorted")
    L = 40  # 40 single-leaf groups: past the patched budget
    fat = FatBVH(
        leaf_lo=torch.zeros((L, 3)), leaf_hi=torch.ones((L, 3)),
        leaf_feat=torch.zeros((L, 1, 10, 4)),
        leaf_tri=torch.arange(L, dtype=torch.int32).view(L, 1),
    )
    prep = block_trace._prepare(fat, torch.zeros((128, 3)), torch.ones((128, 3)),
                                torch.ones(128), gs=1)
    with pytest.raises(ValueError, match="CUDA"):  # only the device stops it
        block_trace.launch(fat, prep, occluded=False)
    glo, ghi = block_trace.group_boxes(fat, 1)
    slo, shi = block_trace.super_boxes(glo, ghi, 32)
    assert slo.shape == (2, 3) and torch.equal(slo[1], torch.zeros(3))  # 8 real, 24 padded


def _assert_lists_equal(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _culled_somewhere(fat, o, d, tm, gs, block, super_size, live_only=True):
    """Blocks with a live ray, and how many of them miss some super-group."""
    ob, db, tb = block_trace._blocks(o, d, tm, block, live_only)
    glo, ghi = block_trace.group_boxes(fat, gs)
    slo, shi = block_trace.super_boxes(glo, ghi, super_size)
    reach = torch.isfinite(block_trace._entries(slo, shi, ob, db, tb))
    live = (tb > 0).any(dim=1) if live_only else torch.ones(tb.shape[0], dtype=torch.bool)
    return int(live.sum()), int((live & ~reach.all(dim=1)).sum())


@pytest.mark.parametrize("super_size", [2, 3])
@pytest.mark.parametrize("gs", [1, 4])
@pytest.mark.parametrize("occluded", [False, True])
def test_culled_lists_equal_candidate_lists(case, occluded, gs, super_size):
    """The plain two-level list phase (super-groups, then the members of the
    reached ones, then a stable sort) gives each CTA's list bit for bit as
    the one-level ``candidate_lists`` at block 128 over live rays, with
    super-groups small enough that some CTAs cull some (13 leaves: 4 groups
    at gs = 4, the last with 3 padded leaves; 13 at gs = 1, the last
    super-group padded)."""
    fat = case["ps"].fat_bvh
    tm = case["t_max"] * (block_trace.SHADOW_EPS if occluded else 1.0)
    o, d, tm = _t(case["o"]), _t(case["d"]), _t(tm.astype(np.float32))
    got, overflow = block_trace.culled_lists(fat, o, d, tm, gs, block_trace.CTA,
                                             super_size=super_size)
    _assert_lists_equal(got, block_trace.candidate_lists(fat, o, d, tm, gs, block_trace.CTA,
                                                         live_only=True))
    live, culled = _culled_somewhere(fat, o, d, tm, gs, block_trace.CTA, super_size)
    assert 0 < culled < live, (culled, live)
    assert not overflow.any()  # CULL_LIST_KEYS is far past 13 groups


def _grid_fat(n=24, leaf_size=4, seed=3):
    """A rippled n x n height field (2 n^2 triangles) in SAH leaves of
    ``leaf_size``: many small leaves in tree order."""
    from stratum_tpu_torch.ops.packet import build_fat_bvh_sah

    u = np.linspace(-1.0, 1.0, n + 1, dtype=np.float32)
    zz, xx = np.meshgrid(u, u, indexing="ij")
    h = 0.1 * np.sin(4 * xx) * np.cos(3 * zz) + 0.02 * np.random.default_rng(seed).random(xx.shape)
    pos = np.stack([xx, h.astype(np.float32), zz], -1).reshape(-1, 3)
    a = (np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]).reshape(-1)
    idx = np.stack([np.stack([a, a + n + 2, a + 1], -1), np.stack([a, a + n + 1, a + n + 2], -1)],
                   axis=1).reshape(-1, 3).astype(np.int32)
    fat = build_fat_bvh_sah(pos, idx, leaf_size=leaf_size)
    return FatBVH(*(torch.from_numpy(np.asarray(x)) for x in fat))


def _grid_rays(n_rays=1024, seed=5):
    """Rays from above the field looking down (coherent in 128-ray runs),
    every 9th dead, some with short bounds."""
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-0.3, 0.3, (n_rays, 1)), np.full((n_rays, 1), 1.5),
                        rng.uniform(-1.2, 1.2, (n_rays, 1))], 1)
    o = o[np.argsort(o[:, 2])]
    tgt = np.concatenate([rng.uniform(-1, 1, (n_rays, 1)), np.zeros((n_rays, 1)),
                          o[:, 2:] + rng.uniform(-0.1, 0.1, (n_rays, 1))], 1)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.full(n_rays, T_MAX, np.float32)
    tm[::9] = 0.0
    tm[4::9] = rng.uniform(0.2, 1.4, tm[4::9].shape)
    return (torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32)),
            torch.from_numpy(tm))


@pytest.mark.parametrize("gs,cap", [(1, 32), (4, 16)])
def test_culled_lists_past_a_patched_budget(monkeypatch, gs, cap):
    """A scene past the shared budget (made small here) takes the culled
    mode; its plain two-level lists equal ``candidate_lists`` bit for bit,
    with the keys budget made small too, so some CTAs overflow (reach more
    groups than CULL_LIST_KEYS) and others do not."""
    fat = _grid_fat()
    o, d, tm = _grid_rays()
    G = -(-fat.num_leaves // gs)
    monkeypatch.setattr(block_trace, "AUTO_SHARED_KEYS", 64)
    monkeypatch.setattr(block_trace, "CULL_LIST_KEYS", cap)
    assert G > 64 and block_trace.resolve_list_mode(G) == "culled"
    got, overflow = block_trace.culled_lists(fat, o, d, tm, gs, block_trace.CTA, super_size=8)
    want = block_trace.candidate_lists(fat, o, d, tm, gs, block_trace.CTA, live_only=True)
    _assert_lists_equal(got, want)
    assert torch.equal(overflow, want.ncand > cap)
    n_cta = o.shape[0] // block_trace.CTA
    assert 0 < int(overflow.sum()) < n_cta, want.ncand[:n_cta]
    live, culled = _culled_somewhere(fat, o, d, tm, gs, block_trace.CTA, 8)
    assert culled == live  # every CTA skips some super-group


def _degenerate_rays(case, kind, n=512, seed=13):
    """Half the case's own rays, half degenerate ones, interleaved: starting
    at a leaf box's centre ("inside"), or on one face of it with the
    direction component across that face exactly 0 ("zero", safe inverse
    1e20: the ray runs in the face's plane), tiny and negative ("tiny
    negative", safe inverse exactly 0: the ray reaches no box) or tiny and
    positive ("tiny positive", 2e20). Where the face is its super-group's
    too, a super-group box one ulp too small would miss the ray."""
    rng = np.random.default_rng(seed)
    fat = case["ps"].fat_bvh
    o, d = case["o"][2048:2048 + n].copy(), case["d"][2048:2048 + n].copy()
    bad = np.arange(1, n, 2)
    axis = rng.integers(0, 3, bad.size)
    lo, hi = fat.leaf_lo.numpy(), fat.leaf_hi.numpy()
    leaf = rng.integers(0, fat.num_leaves, bad.size)
    o[bad] = 0.5 * (lo[leaf] + hi[leaf])
    if kind != "inside":
        o[bad, axis] = lo[leaf, axis]
        d[bad, axis] = {"zero": 0.0, "tiny negative": -1e-25, "tiny positive": 1e-25}[kind]
    tm = case["t_max"][2048:2048 + n].copy()
    return o, d, tm


@pytest.mark.parametrize("kind", ["inside", "zero", "tiny negative", "tiny positive"])
def test_culled_lists_on_degenerate_rays(case, kind):
    """The culling stays conservative where the slab formula is weakest:
    rays starting inside boxes, a zero direction component, and tiny ones
    whose safe inverse is exactly 0 or 2e20. The two-level lists equal
    ``candidate_lists`` (live lanes, block 128) and, over every lane, the
    reference's ``pallas_trace._prepare`` lists, bit for bit, at gs 4 and 1
    with super-groups of 2."""
    js, fat = case["js"], case["ps"].fat_bvh
    o, d, tm = _degenerate_rays(case, kind)
    if kind != "inside":
        assert (d == {"zero": 0.0, "tiny negative": np.float32(-1e-25),
                      "tiny positive": np.float32(1e-25)}[kind]).any()
    for gs in (4, 1):
        got, _ = block_trace.culled_lists(fat, _t(o), _t(d), _t(tm), gs, block_trace.CTA,
                                          super_size=2)
        _assert_lists_equal(got, block_trace.candidate_lists(
            fat, _t(o), _t(d), _t(tm), gs, block_trace.CTA, live_only=True))
        got, _ = block_trace.culled_lists(fat, _t(o), _t(d), _t(tm), gs, block_trace.CTA,
                                          live_only=False, super_size=2)
        _, _, order, entry, ncand, _ = pallas_trace._prepare(
            js.fat_bvh, jnp.asarray(o), jnp.asarray(d), 1e-4, jnp.asarray(tm),
            block_trace.CTA, gs, expand=gs == 1)
        np.testing.assert_array_equal(got.ncand.numpy(), np.asarray(ncand)[:, 0])
        np.testing.assert_array_equal(got.centry.numpy(), np.asarray(entry))
        np.testing.assert_array_equal(got.cand.numpy(), np.asarray(order))
        assert int(got.ncand.sum()) > 0


@pytest.mark.parametrize("gs", [1, 4])
@pytest.mark.parametrize("occluded", [False, True])
def test_culled_lists_match_reference(case, occluded, gs):
    """The plain two-level lists at the reference's 2048-ray blocks over
    every lane (``live_only=False``) against ``pallas_trace._prepare``'s,
    bit for bit, as ``test_prepare_matches_reference`` runs it."""
    js, ps = case["js"], case["ps"]
    tm = (case["t_max"] * (block_trace.SHADOW_EPS if occluded else 1.0)).astype(np.float32)
    _, _, order, entry, ncand, _ = pallas_trace._prepare(
        js.fat_bvh, jnp.asarray(case["o"]), jnp.asarray(case["d"]), 1e-4,
        jnp.asarray(tm), 2048, gs, expand=gs == 1,
    )
    got, _ = block_trace.culled_lists(ps.fat_bvh, _t(case["o"]), _t(case["d"]), _t(tm), gs,
                                      2048, live_only=False, super_size=2)
    np.testing.assert_array_equal(got.ncand.numpy(), np.asarray(ncand)[:, 0])
    np.testing.assert_array_equal(got.centry.numpy(), np.asarray(entry))
    np.testing.assert_array_equal(got.cand.numpy(), np.asarray(order))


def test_plain_mt_does_not_depend_on_the_batch(case):
    """``mt_quantities`` gives a ray the same bits whatever rays share its
    batch (a CPU matmul does not), which is what lets the binned and block
    plain versions agree bit for bit."""
    fat = case["ps"].fat_bvh
    rows = block_trace.leaf_rows(fat)[3]
    rf = block_trace.smxu.ray_features(_t(case["o"]), _t(case["d"]))
    full = block_trace.mt_quantities(rf, rows)
    for sel in (slice(5, 6), slice(0, 17), slice(1000, 3001)):
        assert torch.equal(block_trace.mt_quantities(rf[sel], rows), full[sel])
    np.testing.assert_allclose(
        full.reshape(rf.shape[0], -1).numpy(), (rf @ rows).numpy(), rtol=1e-4, atol=1e-2
    )


@pytest.mark.parametrize("block", [2048, 128])
@pytest.mark.parametrize("gs", [1, 4])
@pytest.mark.parametrize("occluded", [False, True])
def test_prepare_matches_reference(case, occluded, gs, block):
    """``candidate_lists``' order, entries and counts are bit-identical to
    ``pallas_trace._prepare``'s, at the reference's 2048-ray blocks and at
    the kernel's 128-ray CTAs: group streaming at gs = 4 (G = ceil(L/4),
    ``expand=False``), and single leaves at gs = 1 (the K3 kernel's lists:
    ``entry_group`` 1, where ``expand`` has nothing to expand). The light
    ``_prepare`` pads the rays to whole CTAs."""
    js, ps = case["js"], case["ps"]
    tm = (case["t_max"] * (block_trace.SHADOW_EPS if occluded else 1.0)).astype(np.float32)
    _, _, order, entry, ncand, n = pallas_trace._prepare(
        js.fat_bvh, jnp.asarray(case["o"]), jnp.asarray(case["d"]), 1e-4,
        jnp.asarray(tm), block, gs, expand=gs == 1,
    )
    lists = block_trace.candidate_lists(ps.fat_bvh, _t(case["o"]), _t(case["d"]), _t(tm),
                                        gs, block)
    np.testing.assert_array_equal(lists.ncand.numpy(), np.asarray(ncand)[:, 0])
    np.testing.assert_array_equal(lists.centry.numpy(), np.asarray(entry))
    # order is only meaningful where entries are finite (ties past ncand
    # sort identically anyway: both sorts are stable)
    np.testing.assert_array_equal(lists.cand.numpy(), np.asarray(order))
    assert lists.cand.shape[1] == -(-ps.fat_bvh.num_leaves // gs)
    # padded rays carry direction 1.0 and t_max 0
    prep = block_trace._prepare(ps.fat_bvh, _t(case["o"][:-5]), _t(case["d"][:-5]),
                                _t(tm[:-5]), gs)
    assert prep.n == n - 5 and prep.rays.shape[0] == n
    assert (prep.t_max[n - 5:] == 0).all() and (prep.rays[n - 5:, 0:3] == 1.0).all()
    glo, ghi = block_trace.group_boxes(ps.fat_bvh, gs)
    assert torch.equal(prep.group_lo, glo) and torch.equal(prep.group_hi, ghi)


def test_live_only_lists_leave_out_only_dead_lanes(case):
    """``live_only`` (the kernel's CTA lists) equals the reference's entry
    pass over each block's live lanes alone. The reference's lists also
    count boxes that dead lanes sit inside (entry 0 below t_clip 0): on this
    case that changes entries at gs = 1."""
    fat = case["ps"].fat_bvh
    o, d, tm = _t(case["o"]), _t(case["d"]), _t(case["t_max"])
    differ = 0
    for gs in (1, 4):
        live = block_trace.candidate_lists(fat, o, d, tm, gs, 128, live_only=True)
        ref = block_trace.candidate_lists(fat, o, d, tm, gs, 128)
        glo, ghi = block_trace.group_boxes(fat, gs)
        for b in range(o.shape[0] // 128):
            lanes = torch.arange(b * 128, b * 128 + 128)
            lanes = lanes[tm[lanes] > 0]
            e = block_trace._block_entries(glo, ghi, o[lanes][None], d[lanes][None],
                                           block_trace.T_MIN, tm[lanes][None])[0]
            se, order = torch.sort(e, stable=True)
            assert int(live.ncand[b]) == int(torch.isfinite(se).sum())
            assert torch.equal(live.cand[b], order.to(torch.int32))
            assert torch.equal(live.centry[b], torch.where(torch.isfinite(se), se, 3.0e38))
        assert (live.ncand[o.shape[0] // 128:] == 0).all()  # the padded blocks
        differ += int((live.centry != ref.centry).sum())
    assert differ > 0


def _best_t(key):
    return (key >> 32).to(torch.int32).view(torch.float32)


def _walk_like_the_kernel(fat, o, d, bound, occluded, gs=block_trace.GS):
    """The CUDA kernel's traversal, CTA by CTA, in torch (see
    csrc/block_trace.cu): each CTA's own list over its live rays
    (``candidate_lists`` at block 128, ``live_only``), front-to-back groups,
    early exit on the CTA's largest best, per-ray slab pretest against the
    current best, exact MT over each leaf's real triangles, closest commits
    as the minimum of packed (t bits << 32) | slot keys that start at
    (bound bits << 32) | 0."""
    L, K = fat.leaf_tri.shape
    prep = block_trace._prepare(fat, o, d, bound, gs)
    lists = block_trace.candidate_lists(fat, o, d, bound, gs, block_trace.CTA, live_only=True)
    rows = block_trace.leaf_rows(fat)
    counts = leaf_counts(fat).tolist()
    live = prep.t_max > 0
    zero = torch.zeros(live.shape, dtype=torch.int32)
    init = torch.where(live, block_trace.pack_key(prep.t_max, zero), 0)
    key, bnd = init.clone(), prep.t_max.clone()
    for cta in range(live.shape[0] // 128):
        lanes = slice(cta * 128, cta * 128 + 128)
        rf, org, inv = prep.rays[lanes], prep.origin[lanes], prep.inv_dir[lanes]
        k_, b_ = key[lanes], bnd[lanes]
        for c in range(int(lists.ncand[cta])):
            if not lists.centry[cta, c] < (b_ if occluded else _best_t(k_)).max():
                break
            g = int(lists.cand[cta, c])
            for leaf in range(g * gs, min((g + 1) * gs, L)):
                best = b_ if occluded else _best_t(k_)
                tn, tf = block_trace._leaf_slab(fat.leaf_lo[leaf], fat.leaf_hi[leaf], org, inv)
                want = torch.nonzero((tn <= tf) & (tn < best)).squeeze(1)
                if want.numel() == 0:
                    continue
                n = counts[leaf]
                abs_a, stn, valid = block_trace._classify(
                    block_trace.mt_quantities(rf[want], rows[leaf, :, :n * 4])
                )
                if occluded:
                    b_[want[(valid & (stn < b_[want, None] * abs_a)).any(dim=1)]] = 0.0
                    continue
                tt = torch.where(valid, stn / torch.where(valid, abs_a, 1.0), 0.0)
                slot = (leaf * K + torch.arange(n, dtype=torch.int32)).expand(tt.shape)
                cand = torch.where(valid, block_trace.pack_key(tt, slot), init.max() + 1)
                k_[want] = torch.minimum(k_[want], cand.amin(dim=1))
    if occluded:
        return (bnd <= 0) & live
    hit = key < init
    return (torch.where(hit, _best_t(key), T_MAX),
            torch.where(hit, key & 0xFFFFFFFF, -1).to(torch.int32))


def test_kernel_traversal_matches_plain(case):
    fat = case["ps"].fat_bvh
    o, d, tm = _t(case["o"]), _t(case["d"]), _t(case["t_max"])
    t, slot = _walk_like_the_kernel(fat, o, d, tm, occluded=False)
    hp = block_trace.block_closest_plain(fat, o, d, tm)
    n = o.shape[0]
    assert (slot[:n] == hp.slot).float().mean() >= 0.999
    same = slot[:n] == hp.slot
    torch.testing.assert_close(t[:n][same], hp.t[same], rtol=T_REL, atol=0.0)
    assert (slot[n:] == -1).all()  # padding rays never hit
    limit = tm * block_trace.SHADOW_EPS
    blocked = _walk_like_the_kernel(fat, o, d, limit, occluded=True)
    op = block_trace.block_occluded_plain(fat, o, d, tm)
    assert (blocked[:n] == op).float().mean() >= 0.999


def test_single_leaf_traversal_matches_plain(case):
    """The K3 launch (gs = 1): the kernel's walk over single-leaf candidate
    lists gives the plain version's hits; with exact arithmetic on both
    sides (``mt_quantities``), slots and t are equal."""
    fat = case["ps"].fat_bvh
    o, d, tm = _t(case["o"]), _t(case["d"]), _t(case["t_max"])
    n = o.shape[0]
    assert block_trace._prepare(fat, o, d, tm, gs=1).group_lo.shape[0] == fat.num_leaves
    t, slot = _walk_like_the_kernel(fat, o, d, tm, occluded=False, gs=1)
    hp = block_trace.block_closest_plain(fat, o, d, tm)
    assert torch.equal(slot[:n], hp.slot) and torch.equal(t[:n], hp.t)
    blocked = _walk_like_the_kernel(fat, o, d, tm * block_trace.SHADOW_EPS, occluded=True, gs=1)
    assert torch.equal(blocked[:n], block_trace.block_occluded_plain(fat, o, d, tm))


def test_packed_key_is_the_lexicographic_minimum():
    """The kernel's closest commit, emulated in int64 from t's int32 bits:
    the minimum key is the least t and, among equal t, the lower slot. A
    ray's key starts at (bound bits << 32) | 0, so a hit at exactly the
    bound stays a miss and one an ulp below it is a hit; a dead ray (bound
    0) starts at 0 and takes nothing."""
    rng = np.random.default_rng(11)
    t = rng.choice(np.float32([0.5, 1.0, np.nextafter(1.0, 2.0), 2.0, 3e38]), (400, 6))
    slot = rng.integers(0, 1 << 20, (400, 6)).astype(np.int32)
    key = block_trace.pack_key(torch.from_numpy(t), torch.from_numpy(slot)).amin(dim=1)
    first = [np.lexsort((slot[i], t[i]))[0] for i in range(400)]
    np.testing.assert_array_equal(_best_t(key).numpy(), t[np.arange(400), first])
    np.testing.assert_array_equal((key & 0xFFFFFFFF).numpy(), slot[np.arange(400), first])
    bound = torch.tensor([3.0, 3.0, 3.0, 0.0])
    init = torch.where(bound > 0, block_trace.pack_key(bound, torch.zeros(4, dtype=torch.int32)), 0)
    hit_t = torch.tensor([3.0, float(np.nextafter(np.float32(3.0), np.float32(0.0))), 3.5, 1.0])
    got = torch.minimum(init, block_trace.pack_key(hit_t, torch.tensor([0, 7, 0, 0])))
    assert (got < init).tolist() == [False, True, False, False]


@pytest.mark.parametrize("scene", ["atrium", "cornell"])
def test_leaf_padding_sits_at_the_tail(case, scene):
    """The kernel visits slots [0, count) of each leaf: in the port's SAH
    build (and the JAX package's, bridged) every leaf's padding is at its
    tail, and padded rows (zero features) are never valid under the accept
    rule, so leaving them out changes no result."""
    g = (builtin.atrium(columns=1, stacks=6, slices=12) if scene == "atrium"
         else builtin.cornell_box())
    fats = [flatten.flatten(g.root, device="cpu")[0].fat_bvh]
    if scene == "atrium":
        fats.append(case["ps"].fat_bvh)
    rf = block_trace.smxu.ray_features(_t(case["o"]), _t(case["d"]))
    for fat in fats:
        L, K = fat.leaf_tri.shape
        counts = leaf_counts(fat)
        assert counts.dtype == torch.int32 and bool((counts > 0).all())
        assert torch.equal(fat.leaf_tri >= 0, torch.arange(K) < counts[:, None])
        rows = block_trace.leaf_rows(fat)
        padded = [leaf for leaf in range(L) if counts[leaf] < K]
        assert padded  # the case has padding to check
        for leaf in padded:
            q = block_trace.mt_quantities(rf, rows[leaf, :, int(counts[leaf]) * 4:])
            assert not block_trace._classify(q)[2].any()


def test_finalize_hit_matches_reference(case):
    js, ps = case["js"], case["ps"]
    hp = _plain_closest(case)
    from stratum_tpu.ops.intersect import HitRecord as JHit

    jh = pallas_trace.finalize_hit(
        js.slot_payload, jnp.asarray(case["o"]), jnp.asarray(case["d"]),
        JHit(t=jnp.asarray(hp.t.numpy()), tri=jnp.asarray(hp.tri.numpy()),
             bary=jnp.zeros((hp.t.shape[0], 2)), slot=jnp.asarray(hp.slot.numpy())),
    )
    ph = block_trace.finalize_hit(ps.slot_payload, _t(case["o"]), _t(case["d"]), hp)
    np.testing.assert_array_equal(ph.tri.numpy(), np.asarray(jh.tri))
    np.testing.assert_array_equal(ph.payload.numpy(), np.asarray(jh.payload))
    # bary: the same 10-term sums in the same order, but their terms reach
    # |o||e| >> the result and XLA may contract a product into an FMA, so a
    # few ulps of the largest term remain: measured 5.4e-6 at most
    np.testing.assert_allclose(ph.bary.numpy(), np.asarray(jh.bary), rtol=1e-5, atol=2e-5)


def test_morton_and_ray_keys_bit_exact(case):
    rng = np.random.default_rng(3)
    q = rng.uniform(-0.1, 1.1, (5000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        morton3(_t(q)).numpy(), np.asarray(jmorton3(jnp.asarray(q))).astype(np.int64)
    )
    lo = np.asarray([-12.0, 0.0, -40.0], np.float32)
    hi = np.asarray([12.0, 10.0, 40.0], np.float32)
    tm = case["t_max"]
    kj = jraysort.ray_key(jnp.asarray(case["o"]), jnp.asarray(case["d"]),
                          jnp.asarray(tm), jnp.asarray(lo), jnp.asarray(hi))
    kp = raysort.ray_key(_t(case["o"]), _t(case["d"]), _t(tm), _t(lo), _t(hi))
    np.testing.assert_array_equal(kp.numpy(), np.asarray(kj).astype(np.int64))
    assert (kp.numpy()[tm == 0] == 0xFFFFFFFF).all()


def test_sorted_closest_is_identical_to_unsorted(case):
    """The trace-local sort never changes hits (the plain walk is order
    independent), and it returns them in the caller's lane order."""
    fat = case["ps"].fat_bvh
    o, d, tm = _t(case["o"]), _t(case["d"]), _t(case["t_max"])
    pos = case["ps"].geo.positions
    sc = raysort.sorted_closest(
        lambda a, b, c: block_trace.block_closest(fat, a, b, c),
        pos.amin(dim=0), pos.amax(dim=0),
    )
    hs = sc(o, d, tm)
    hu = block_trace.block_closest(fat, o, d, tm)
    assert torch.equal(hs.slot, hu.slot) and torch.equal(hs.t, hu.t)
