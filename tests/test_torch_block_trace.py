"""The port's block tracer (stratum_tpu_torch/ops/block_trace.py) against the
JAX reference on the tiny atrium (1,258 triangles, 13 SAH leaves of 256):
camera rays plus random secondary rays, the same inputs (numpy, fixed seed)
through both packages.

- ``block_closest_plain`` against ``pallas_closest`` (kernel K1 in interpret
  mode, default GS=4) and against ``packet_closest`` (compared by triangle
  id through ``leaf_tri[slot]``); ``block_occluded_plain`` against
  ``pallas_occluded`` (K2 in interpret mode).
- ``_prepare``'s candidate lists, ``finalize_hit`` and the raysort keys
  against the reference, bit for bit.
- A candidate-list walk written exactly as the CUDA kernel walks (one
  128-ray CTA, front-to-back groups, early exit on the CTA's largest best,
  per-ray pretests) against the plain version, so the kernel's traversal
  logic is checked here too; the kernel itself runs only on a GPU
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
from stratum_tpu_torch.scene import bridge

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


@pytest.mark.parametrize("gs", [1, 4])
@pytest.mark.parametrize("occluded", [False, True])
def test_prepare_matches_reference(case, occluded, gs):
    """Candidate order, entries and counts are bit-identical (block 2048):
    group streaming at gs = 4 (G = ceil(L/4), ``expand=False``), and single
    leaves at gs = 1 (the K3 kernel's lists: ``entry_group`` 1, where
    ``expand`` has nothing to expand)."""
    js, ps = case["js"], case["ps"]
    tm = case["t_max"] * (block_trace.SHADOW_EPS if occluded else 1.0)
    _, _, order, entry, ncand, n = pallas_trace._prepare(
        js.fat_bvh, jnp.asarray(case["o"]), jnp.asarray(case["d"]), 1e-4,
        jnp.asarray(tm.astype(np.float32)), 2048, gs, expand=gs == 1,
    )
    prep = block_trace._prepare(ps.fat_bvh, _t(case["o"]), _t(case["d"]),
                                _t(tm.astype(np.float32)), gs)
    assert prep.n == n
    np.testing.assert_array_equal(prep.ncand.numpy(), np.asarray(ncand)[:, 0])
    np.testing.assert_array_equal(prep.centry.numpy(), np.asarray(entry))
    # order is only meaningful where entries are finite (ties past ncand
    # sort identically anyway: both sorts are stable)
    np.testing.assert_array_equal(prep.cand.numpy(), np.asarray(order))
    assert prep.cand.shape[1] == -(-ps.fat_bvh.num_leaves // gs)
    # padded rays carry direction 1.0 and t_max 0: they yield no entries
    assert (prep.t_max[n:] == 0).all() and (prep.rays[n:, 0:3] == 1.0).all()


def _walk_like_the_kernel(fat, prep, occluded, gs=block_trace.GS):
    """The CUDA kernel's traversal, CTA by CTA, in torch (see
    csrc/block_trace.cu): front-to-back groups, early exit on the CTA's
    largest best, per-ray slab pretest, exact MT, lower slot on ties."""
    L, K = fat.leaf_tri.shape
    feat = fat.leaf_feat.permute(0, 2, 1, 3).reshape(L, 10, K * 4)
    best = prep.t_max.clone()
    slot = torch.full(best.shape, -1, dtype=torch.int32)
    for cta in range(best.shape[0] // 128):
        lanes = slice(cta * 128, cta * 128 + 128)
        blk = cta * 128 // block_trace.BLOCK
        rf, o, inv = prep.rays[lanes], prep.origin[lanes], prep.inv_dir[lanes]
        b, s = best[lanes], slot[lanes]
        for c in range(int(prep.ncand[blk])):
            if not prep.centry[blk, c] < b.max():
                break
            g = int(prep.cand[blk, c])
            for leaf in range(g * gs, min((g + 1) * gs, L)):
                tn, tf = block_trace._leaf_slab(fat.leaf_lo[leaf], fat.leaf_hi[leaf], o, inv)
                want = torch.nonzero((tn <= tf) & (tn < b)).squeeze(1)
                if want.numel() == 0:
                    continue
                abs_a, stn, valid = block_trace._classify(
                    block_trace.mt_quantities(rf[want], feat[leaf])
                )
                if occluded:
                    b[want[(valid & (stn < b[want, None] * abs_a)).any(dim=1)]] = 0.0
                    continue
                tt = torch.where(valid, stn / torch.where(valid, abs_a, 1.0), float("inf"))
                tk, k = torch.min(tt, dim=1)
                sid = (leaf * K + k).to(torch.int32)
                cur_t, cur_s = b[want], s[want]
                take = (tk < cur_t) | ((tk == cur_t) & (sid < cur_s))
                b[want[take]] = tk[take]
                s[want[take]] = sid[take]
    if occluded:
        return (best <= 0) & (prep.t_max > 0)
    return torch.where(slot >= 0, best, T_MAX), slot


def test_kernel_traversal_matches_plain(case):
    fat = case["ps"].fat_bvh
    o, d, tm = _t(case["o"]), _t(case["d"]), _t(case["t_max"])
    prep = block_trace._prepare(fat, o, d, tm)
    t, slot = _walk_like_the_kernel(fat, prep, occluded=False)
    hp = block_trace.block_closest_plain(fat, o, d, tm)
    n = o.shape[0]
    assert (slot[:n] == hp.slot).float().mean() >= 0.999
    same = slot[:n] == hp.slot
    torch.testing.assert_close(t[:n][same], hp.t[same], rtol=T_REL, atol=0.0)
    assert (slot[n:] == -1).all()  # padding rays never hit
    limit = tm * block_trace.SHADOW_EPS
    prep_o = block_trace._prepare(fat, o, d, limit)
    blocked = _walk_like_the_kernel(fat, prep_o, occluded=True)
    op = block_trace.block_occluded_plain(fat, o, d, tm)
    assert (blocked[:n] == op).float().mean() >= 0.999


def test_single_leaf_traversal_matches_plain(case):
    """The K3 launch (gs = 1): the kernel's walk over single-leaf candidate
    lists gives the plain version's hits; with exact arithmetic on both
    sides (``mt_quantities``), slots and t are equal."""
    fat = case["ps"].fat_bvh
    o, d, tm = _t(case["o"]), _t(case["d"]), _t(case["t_max"])
    n = o.shape[0]
    prep = block_trace._prepare(fat, o, d, tm, gs=1)
    assert prep.cand.shape[1] == fat.num_leaves
    t, slot = _walk_like_the_kernel(fat, prep, occluded=False, gs=1)
    hp = block_trace.block_closest_plain(fat, o, d, tm)
    assert torch.equal(slot[:n], hp.slot) and torch.equal(t[:n], hp.t)
    prep_o = block_trace._prepare(fat, o, d, tm * block_trace.SHADOW_EPS, gs=1)
    blocked = _walk_like_the_kernel(fat, prep_o, occluded=True, gs=1)
    assert torch.equal(blocked[:n], block_trace.block_occluded_plain(fat, o, d, tm))


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


@pytest.mark.cuda
def test_kernel_matches_plain_on_gpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    ps = bridge.scene_from_numpy(bridge.numpy_fields(case["js"]), "cuda")
    o, d, tm = (_t(case[k]).cuda() for k in ("o", "d", "t_max"))
    hk = block_trace.block_closest(ps.fat_bvh, o, d, tm)
    hp = block_trace.block_closest_plain(ps.fat_bvh, o, d, tm)
    assert (hk.slot == hp.slot).float().mean().item() >= 0.999
    ok = block_trace.block_occluded(ps.fat_bvh, o, d, tm)
    op = block_trace.block_occluded_plain(ps.fat_bvh, o, d, tm)
    assert (ok == op).float().mean().item() >= 0.999
