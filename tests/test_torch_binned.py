"""The port's binned pair-stream tracer (stratum_tpu_torch/ops/binned.py)
against the JAX reference (``pallas_closest_binned`` /
``pallas_occluded_binned`` with the K5 kernel in interpret mode), the port's
block tracer and a brute loop, on the tiny atrium (1,258 triangles, 13 SAH
leaves of 256) and on random triangles (leaves of 32), the way
tests/test_binned.py runs the reference. The same inputs (numpy, fixed
seeds) go through both packages.

Tolerances. Emission, sort and padding are exact, so ``stats`` must equal
the reference's. The reference's kernel packs the slot into the low 10
mantissa bits of t (<= 2^-13 relative) and runs a bf16-split (c48) matmul
that drops the lo*lo term, which t_num = o.n - p0.n can amplify where its
terms nearly cancel (the allowance of test_torch_block_trace.py): slots must
agree on >= 99.5 % of rays, t within 2^-12 relative on >= 99.5 % of the
agreeing rays and within 2^-8 on all of them (on the atrium). Random
triangles put ray origins within 1e-3 of a triangle, where t_num cancels
completely and no relative bound holds: there every agreeing ray is held to
2^-12 relative plus C48 times the t numerator's term magnitudes over |a|
(both the a and t_num sums lose ~2^-16 of each product; C48 = 2^-14 leaves
a factor 2 on each). Against the port's block tracer, both sides exact f32
with the lower slot on equal t, results are equal bit for bit when no pair
is dropped.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.ops import binned as jbinned
from stratum_tpu.ops import packet as jpacket
from stratum_tpu.ops import pallas_trace
from stratum_tpu.render import camera as jcamera
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu_torch.ops import binned, block_trace
from stratum_tpu_torch.ops.intersect import T_MAX
from stratum_tpu_torch.ops.packet import FatBVH
from stratum_tpu_torch.scene import bridge
from stratum_tpu_torch.utils import cuda_build

torch.set_num_threads(2)

SLOT_AGREE = 0.995
T_REL = 2.0 ** -12
T_REL_ALL = 2.0 ** -8
C48 = 2.0 ** -14
MCAP = 8192  # explicit, small, and above every case's pair count


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _atrium_rays(rng, view):
    """2048 camera rays then 2048 random rays from inside the hall, with
    dead lanes (t_max 0) and short bounds."""
    px, py = jcamera.pixel_grid(64, 32)
    jit = jnp.asarray(rng.random((2048, 2), dtype=np.float32))
    o_cam, d_cam = jcamera.generate_rays(view, px, py, jit, 64, 32)
    o_rand = rng.uniform([-11, 0.2, -39], [11, 9.5, 39], (2048, 3)).astype(np.float32)
    d_rand = rng.normal(size=(2048, 3)).astype(np.float32)
    d_rand /= np.linalg.norm(d_rand, axis=1, keepdims=True)
    o = np.concatenate([np.asarray(o_cam), o_rand]).astype(np.float32)
    d = np.concatenate([np.asarray(d_cam), d_rand]).astype(np.float32)
    t_max = np.full(o.shape[0], T_MAX, np.float32)
    t_max[::7] = 0.0
    t_max[3::7] = rng.uniform(0.5, 30.0, t_max[3::7].shape).astype(np.float32)
    return o, d, t_max


def _random_case(rng):
    """400 random triangles in leaves of 32 (the reference's Morton fat BVH)
    and 2048 random rays, as tests/test_binned.py builds them."""
    n = 400
    base = (rng.random((n, 3)) * 2 - 1).astype(np.float32)
    e1 = ((rng.random((n, 3)) - 0.5) * 0.4).astype(np.float32)
    e2 = ((rng.random((n, 3)) - 0.5) * 0.4).astype(np.float32)
    pos = np.concatenate([base, base + e1, base + e2])
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], 1).astype(np.int32)
    jfat = jpacket.build_fat_bvh(jnp.asarray(pos), jnp.asarray(idx), leaf_size=32)
    o = ((rng.random((2048, 3)) * 2 - 1) * 2.0).astype(np.float32)
    d = (rng.random((2048, 3)) - 0.5).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-9
    t_max = np.where(np.arange(2048) % 5 == 0, 0.0, T_MAX).astype(np.float32)
    return dict(
        jfat=jfat, packed=pallas_trace.pack_leaf_features(jfat, mode="c48"),
        fat=FatBVH(*(_t(x) for x in (jfat.leaf_lo, jfat.leaf_hi, jfat.leaf_feat, jfat.leaf_tri))),
        o=o, d=d, t_max=t_max,
    )


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(7)
    g = jbuiltin.atrium(columns=1, stacks=6, slices=12)
    js, _ = jflatten.flatten(g.root)
    node, cam = jflatten.find_camera(g.root)
    o, d, t_max = _atrium_rays(rng, jcamera.make_view(node.to_world(), cam.fovy, 64, 32))
    atrium = dict(
        jfat=js.fat_bvh, packed=js.leaf_feat_packed,
        fat=bridge.scene_from_numpy(bridge.numpy_fields(js), "cpu").fat_bvh,
        o=o, d=d, t_max=t_max,
    )
    return dict(atrium=atrium, random=_random_case(rng))


def _closest_both(case, **kw):
    hj, sj = jbinned.pallas_closest_binned(
        case["jfat"], case["packed"], jnp.asarray(case["o"]), jnp.asarray(case["d"]),
        t_max=jnp.asarray(case["t_max"]), mcap=MCAP, interpret=True, slot_payload=True,
        with_stats=True, **kw,
    )
    hp, bins = binned.binned_closest(
        case["fat"], _t(case["o"]), _t(case["d"]), _t(case["t_max"]), mcap=MCAP,
        with_stats=True, **kw,
    )
    return hj, {k: int(v) for k, v in sj.items()}, hp, bins


def _check_closest(case, hj, hp, relative=True):
    sj, sp = np.asarray(hj.slot), hp.slot.numpy()
    assert (sj == sp).mean() >= SLOT_AGREE, (sj == sp).mean()
    both = (sj == sp) & (sp >= 0)
    assert both.sum() > 100
    tj, tp = np.asarray(hj.t)[both], hp.t.numpy()[both]
    rel = np.abs(tp - tj) / tj
    if relative:
        assert (rel <= T_REL).mean() >= SLOT_AGREE, (rel > T_REL).sum()
        assert rel.max() <= T_REL_ALL, rel.max()
    feat = case["fat"].leaf_feat.reshape(-1, 10, 4).numpy()[sp[both]]
    terms = binned.ray_features(_t(case["o"]), _t(case["d"])).numpy()[both][:, :, None] * feat
    mag = np.abs(terms).sum(axis=1)
    abs_a = np.abs(terms[..., 0].sum(axis=1))
    bound = T_REL * tj + C48 * (mag[:, 3] + tj * mag[:, 0]) / abs_a
    assert (np.abs(tp - tj) <= bound).all(), (np.abs(tp - tj) / bound).max()
    assert (hp.t.numpy()[sp < 0] == T_MAX).all()


@pytest.mark.parametrize("sb", [1, 2])
@pytest.mark.parametrize("em", ["ray", "group"])
@pytest.mark.parametrize("g", [8, 16])
def test_closest_matches_reference(cases, g, em, sb):
    """Tiny atrium: stats exact, slots and t within the reference's bf16
    allowance (see the module docstring)."""
    hj, sj, hp, bins = _closest_both(cases["atrium"], g=g, em=em, sb=sb)
    assert bins.stats == sj and sj["pairs"] > 500
    assert sj["dropped_pcap"] == 0 and sj["dropped_mcap"] == 0
    _check_closest(cases["atrium"], hj, hp)


@pytest.mark.parametrize("g", [8, 16])
def test_closest_matches_reference_on_random_triangles(cases, g):
    hj, sj, hp, bins = _closest_both(cases["random"], g=g, pcap=24)
    assert bins.stats == sj and sj["dropped_pcap"] == 0
    _check_closest(cases["random"], hj, hp, relative=False)


def test_occluded_matches_reference(cases):
    c = cases["atrium"]
    oj, sj = jbinned.pallas_occluded_binned(
        c["jfat"], c["packed"], jnp.asarray(c["o"]), jnp.asarray(c["d"]),
        jnp.asarray(c["t_max"]), mcap=MCAP, interpret=True, with_stats=True,
    )
    op, bins = binned.binned_occluded(c["fat"], _t(c["o"]), _t(c["d"]), _t(c["t_max"]),
                                      mcap=MCAP, with_stats=True)
    assert bins.stats == {k: int(v) for k, v in sj.items()}
    assert (np.asarray(oj) == op.numpy()).mean() >= SLOT_AGREE
    assert not op.numpy()[c["t_max"] == 0].any()
    assert 0.05 < float(op.float().mean()) < 0.95  # the case has both outcomes


@pytest.mark.parametrize("name, em", [("atrium", "ray"), ("atrium", "group"), ("random", "ray")])
def test_equals_block_tracer_at_zero_drops(cases, name, em):
    c = cases[name]
    o, d, tm = _t(c["o"]), _t(c["d"]), _t(c["t_max"])
    hp, bins = binned.binned_closest(c["fat"], o, d, tm, mcap=MCAP, pcap=32, em=em,
                                     with_stats=True)
    assert bins.stats["dropped_pcap"] == 0 and bins.stats["dropped_mcap"] == 0
    assert not bins.lost.any()
    hb = block_trace.block_closest_plain(c["fat"], o, d, tm)
    assert torch.equal(hp.slot, hb.slot) and torch.equal(hp.t, hb.t)
    op = binned.binned_occluded(c["fat"], o, d, tm, mcap=MCAP, pcap=32, em=em)
    assert torch.equal(op, block_trace.block_occluded_plain(c["fat"], o, d, tm))


def test_overflow_counts_and_lost_lanes(cases):
    """pcap = 2 and a small mcap drop pairs: the counts equal the
    reference's, ``lost`` marks exactly the groups that dropped one, and
    every other ray keeps the block tracer's hit."""
    c = cases["atrium"]
    o, d, tm = _t(c["o"]), _t(c["d"]), _t(c["t_max"])
    hb = block_trace.block_closest_plain(c["fat"], o, d, tm)
    for kw in (dict(pcap=2), dict(mcap=900)):
        sj = jbinned.pallas_closest_binned(
            c["jfat"], c["packed"], jnp.asarray(c["o"]), jnp.asarray(c["d"]),
            t_max=jnp.asarray(c["t_max"]), interpret=True, with_stats=True,
            **{"mcap": MCAP, **kw},
        )[1]
        hp, bins = binned.binned_closest(c["fat"], o, d, tm, with_stats=True,
                                         **{"mcap": MCAP, **kw})
        assert bins.stats == {k: int(v) for k, v in sj.items()}
        key = "dropped_pcap" if "pcap" in kw else "dropped_mcap"
        assert bins.stats[key] > 0
        kept = ~bins.lost
        assert 0 < int(kept.sum()) < kept.numel()
        assert torch.equal(hp.slot[kept], hb.slot[kept])
        # a dropped pair is a miss, never a wrong nearer hit
        assert bool((hp.t[~kept] >= hb.t[~kept]).all())


def test_bin_min_plain_matches_a_brute_loop(cases):
    """The plain bin step against a per-lane loop in numpy (f32, the same
    slab pretest of the lane's own ray against the bin's leaf box, the same
    accept rule and sum order, every slot of the leaf, padding included):
    the same words, bit for bit."""
    for name, g in (("atrium", 8), ("random", 16)):
        c = cases[name]
        bins = binned.bin_pairs(c["fat"], _t(c["o"]), _t(c["d"]), _t(c["t_max"]), g=g,
                                pcap=32, mcap=MCAP, sb=2)
        words = binned.bin_min_plain(c["fat"], bins).numpy()
        L, K = c["fat"].leaf_tri.shape
        rows = block_trace.leaf_rows(c["fat"]).numpy().reshape(L, 10, K, 4)
        rays = bins.rays.numpy()
        lo, hi = c["fat"].leaf_lo.numpy(), c["fat"].leaf_hi.numpy()
        org, inv, tb = bins.origin.numpy(), bins.inv_dir.numpy(), bins.t_bound.numpy()
        want = np.full(bins.n, binned.MISS, np.int64)
        bw = binned.LANES // g
        skipped = 0
        for b, leaf in enumerate(bins.bin_leaf.tolist()):
            for lane in range(binned.LANES):
                pid = int(bins.pair_id[b * bw + lane // g])
                ray = pid // bins.pcap * g + lane % g
                if leaf < 0 or pid < 0 or ray >= bins.n:
                    continue
                t0 = (lo[leaf] - org[ray]) * inv[ray]
                t1 = (hi[leaf] - org[ray]) * inv[ray]
                tn = max(np.minimum(t0, t1).max(), np.float32(0.0))
                tf = np.maximum(t0, t1).min()
                if not (tn <= tf and tf >= np.float32(bins.t_min) and tn < tb[ray]):
                    skipped += 1
                    continue
                q = rays[ray, 0] * rows[leaf, 0]
                for f in range(1, 10):
                    q = q + rays[ray, f] * rows[leaf, f]
                a, u, v, t = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
                s = np.sign(a)
                aa, su, sv, st = a * s, u * s, v * s, t * s
                ok = ((aa > 1e-12) & (aa < 1e37) & (su >= 0) & (sv >= 0)
                      & (su + sv <= aa) & (st > np.float32(1e-4) * aa))
                if ok.any():
                    tt = np.where(ok, st / np.where(ok, aa, 1), np.inf).astype(np.float32)
                    k = int(np.argmin(tt))
                    w = (int(tt[k].view(np.int32)) << 32) | (leaf * K + k)
                    want[ray] = min(want[ray], w)
        np.testing.assert_array_equal(words, want)
        assert (words != binned.MISS).sum() > 100 and skipped > 100


def test_wrappers_take_the_plain_version_on_cpu(cases):
    c = cases["atrium"]
    o, d, tm = _t(c["o"]), _t(c["d"]), _t(c["t_max"])
    before = cuda_build.launches()
    bins = binned.bin_pairs(c["fat"], o, d, tm, mcap=MCAP)
    assert torch.equal(binned.bin_min(c["fat"], bins, "closest"),
                       binned.bin_min_plain(c["fat"], bins))
    binned.binned_occluded(c["fat"], o, d, tm, mcap=MCAP)
    assert cuda_build.launches() == before  # no kernel launch on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        binned.launch(c["fat"], bins, "closest")


@pytest.mark.parametrize("kw", [dict(g=3), dict(g=256), dict(em="leaf"), dict(sb=0)])
def test_bad_arguments_raise(cases, kw):
    c = cases["random"]
    with pytest.raises(ValueError):
        binned.binned_closest(c["fat"], _t(c["o"]), _t(c["d"]), **kw)
