"""The port's kernels against their plain versions on the card.

This module imports torch, numpy, pytest and the port only (no JAX, no
``stratum_tpu``), so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

Every test is marked ``cuda`` and skips without a CUDA device (the kernels
have no CPU mode). Inputs come from the port's own scene build (the tiny
atrium, ``builtin.atrium(columns=1, stacks=6, slices=12)``, 13 SAH leaves)
and from seeded numpy.

Bounds: K1/K2/K3 and K5 against their plain versions, slots (and blocked
flags) equal on >= 99.9 % of rays (exact f32 on both sides; a slot may
differ on a tie), t within 1e-3 relative where the slots agree (the
Plucker sums of a short hit from a far origin round apart); lists, the two
list modes, the emission's count and slots and the tiled emission bit for
bit; T1-T4 on small-integer inputs bit for bit (every product and sum is
exact), T1-T3 also at k from 8 to 1,024 and T4 at C from 8 to 128 on normal
values within their tools' bounds; the dense tracer's product against float64 within 1e-5 of its
magnitude (TF32 would lose 1e-3), and its render within test_torch_slice's
bounds of the CPU render; texture samples within 1e-6 of the CPU's, and a
textured colonnade render through K1/K2 within test_torch_slice's bounds of
the CPU render. On the tiny atrium through K1/K2, ``render_path_batched``
and ``render_path_lanes`` (without the light tile) against the sequential
samples, and caps of 1.0 (``wave_caps``) against the uncapped render, at
rtol 1e-5 / atol 1e-7. BDPT (paired and light-cache connections) and light
tracing through K1/K2 against the same renders on the card's brute-force
tracer (test_torch_slice's bounds: mean 2 %, >= 97 % of pixels within
1e-3), with 8 K1 and 3 K2 launches a BDPT sample at 3 bounces; two
same-seed BDPT renders (whole and in chunks) bit for bit, and the
fixed-order splat against float64 (1e-6) and bit-equal to itself. The
G-buffer through its one K1 wave against the card's brute-force tracer
(instances equal on >= 99.9 % of pixels, albedo, normal and ``prev_uv``
within 1e-4 and depth within 1e-5 relative where they are: K1's Plucker
barycentrics and the brute force's Moller-Trumbore ones differ in their
last bits, which the interpolated normals of the pillars' small triangles
magnify), and the
denoiser on the card against the CPU port on the same inputs over two
frames, at twice test_torch_denoise.py's bound (rtol 2e-5, atol 2e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

from stratum_tpu_torch.ops import binned, block_trace, intersect, mxu
from stratum_tpu_torch.ops.packet import FatBVH
from stratum_tpu_torch.render import aov, bdpt, camera, denoise, integrator, lighttrace, texture
from stratum_tpu_torch.scene import builtin, flatten, sample_assets, schema
from stratum_tpu_torch.tools import (
    bench_mxu_model,
    perf_commit_pipeline,
    perf_epilogue,
    probe_mxu_loop,
)

pytestmark = pytest.mark.cuda

AGREE = 0.999
T_RTOL = 1e-3
MCAP = 1 << 15
NONZERO = (-3.0, -2.0, -1.0, 1.0, 2.0, 3.0)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def atrium(dev):
    """The tiny atrium on the card and 4096 rays: camera rays, rays from
    inside the hall, every 7th lane dead, some short bounds, and lanes
    256-511 all dead."""
    g = builtin.atrium(columns=1, stacks=6, slices=12)
    scene, _ = flatten.flatten(g.root, device=dev)
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, 64, 32, device=dev)
    rng = np.random.default_rng(11)
    px, py = camera.pixel_grid(64, 32, dev)
    jit = torch.from_numpy(rng.random((2048, 2), dtype=np.float32)).to(dev)
    o_cam, d_cam = camera.generate_rays(view, px, py, jit, 64, 32)
    o_rand = rng.uniform([-11, 0.2, -39], [11, 9.5, 39], (2048, 3)).astype(np.float32)
    d_rand = rng.normal(size=(2048, 3)).astype(np.float32)
    d_rand /= np.linalg.norm(d_rand, axis=1, keepdims=True)
    o = torch.cat([o_cam, torch.from_numpy(o_rand).to(dev)]).contiguous()
    d = torch.cat([d_cam, torch.from_numpy(d_rand).to(dev)]).contiguous()
    t_max = np.full(4096, intersect.T_MAX, np.float32)
    t_max[::7] = 0.0
    t_max[3::7] = rng.uniform(0.5, 30.0, t_max[3::7].shape).astype(np.float32)
    t_max[256:512] = 0.0
    return dict(scene=scene, fat=scene.fat_bvh, o=o, d=d, t_max=torch.from_numpy(t_max).to(dev))


def _close_slots(tk, sk, tp, sp):
    assert (sk == sp).float().mean().item() >= AGREE
    same = (sk == sp) & (sp >= 0)
    torch.testing.assert_close(tk[same], tp[same], rtol=T_RTOL, atol=0.0)


@pytest.mark.parametrize("gs", [4, 1])
def test_block_kernel_matches_plain(atrium, gs):
    """K1 / K2 (gs = 4) and K3 (gs = 1) against the plain walk."""
    fat, o, d, tm = atrium["fat"], atrium["o"], atrium["d"], atrium["t_max"]
    hk = block_trace.block_closest(fat, o, d, tm, gs=gs)
    hp = block_trace.block_closest_plain(fat, o, d, tm)
    _close_slots(hk.t, hk.slot, hp.t, hp.slot)
    ok = block_trace.block_occluded(fat, o, d, tm, gs=gs)
    op = block_trace.block_occluded_plain(fat, o, d, tm)
    assert (ok == op).float().mean().item() >= AGREE


@pytest.mark.parametrize("occluded", [False, True])
def test_kernel_lists_equal_the_plain_list_phase(atrium, occluded):
    """Each CTA's sorted entries and groups, bit for bit, at gs 4 and 1."""
    fat, o, d, tm = atrium["fat"], atrium["o"], atrium["d"], atrium["t_max"]
    bound = tm * block_trace.SHADOW_EPS if occluded else tm
    for gs in (4, 1):
        prep = block_trace._prepare(fat, o, d, bound, gs)
        *_, lists = block_trace.launch(fat, prep, occluded, stats="lists")
        plain = block_trace.candidate_lists(fat, o, d, bound, gs, block_trace.CTA,
                                            live_only=True)
        n = lists.ncand.numel()
        for a, b in zip(lists, plain):
            assert torch.equal(a, b[:n]), gs


def test_global_list_mode_equals_shared(atrium, monkeypatch):
    """The global list mode (forced here; the default past MAX_LIST_KEYS),
    with the scratch cut to 3 CTAs' lists so the wave runs in chunks, gives
    the shared mode's results and lists bit for bit."""
    fat, o, d, tm = atrium["fat"], atrium["o"], atrium["d"], atrium["t_max"]
    for gs in (4, 1):
        keys = block_trace.list_keys(-(-fat.num_leaves // gs))
        monkeypatch.setattr(block_trace, "LIST_SCRATCH_BYTES", 3 * 8 * keys)
        for occluded in (False, True):
            prep = block_trace._prepare(fat, o, d, tm, gs)
            want = block_trace.launch(fat, prep, occluded, stats="lists")
            got = block_trace.launch(fat, prep, occluded, stats="lists", list_mode="global")
            for a, b in zip(got[:-1], want[:-1]):
                assert torch.equal(a, b), (gs, occluded)
            for a, b in zip(got[-1], want[-1]):
                assert torch.equal(a, b), (gs, occluded)


def _padded(atrium, g):
    return binned.pad_wave(atrium["o"], atrium["d"], atrium["t_max"], g)


def test_emission_kernel_matches_plain(atrium):
    """Count and slots of the emission kernel equal ``_emit``'s bit for bit
    at every g, both modes, pcap 3 and 32."""
    fat = atrium["fat"]
    for g in (1, 2, 8, 16, 32, 64, 128):
        o, inv, tb = _padded(atrium, g)
        for em in ("ray", "group"):
            for pcap in (3, 32):
                got = binned.emit_launch(fat, o, inv, tb, block_trace.T_MIN, g, pcap, em)
                want = binned._emit(fat, o, inv, tb, block_trace.T_MIN, g, pcap, em)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (
                    g, em, pcap)


def test_tiled_emission_equals_plain(atrium, dev, monkeypatch):
    """Leaf boxes streamed in tiles (forced with ``emit_mode="tiled"``, and
    taken by ``auto`` once the budget is made small) give ``_emit``'s count
    and slots bit for bit, on 1,000 random leaf boxes (4 tiles of 256 when
    forced, 11 of 96 under the patched budget)."""
    rng = np.random.default_rng(5)
    lo = rng.uniform([-11, 0, -39], [10, 9, 38], (1000, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.05, 2.0, (1000, 3)).astype(np.float32)
    fat = FatBVH(leaf_lo=torch.from_numpy(lo).to(dev), leaf_hi=torch.from_numpy(hi).to(dev),
                 leaf_feat=torch.zeros((1000, 1, 10, 4), device=dev),
                 leaf_tri=torch.zeros((1000, 1), dtype=torch.int32, device=dev))
    assert binned.emit_tile_leaves(1000, 8, 16, "tiled") == 256
    cases = [(g, em, pcap) for g in (1, 8, 64) for em in ("ray", "group") for pcap in (3, 32)]
    for mode in ("tiled", "auto"):
        if mode == "auto":
            monkeypatch.setattr(binned, "EMIT_SMEM_BUDGET", binned.emit_smem(500, 1, 32))
            monkeypatch.setattr(binned, "EMIT_TILE", 96)
        for g, em, pcap in cases:
            o, inv, tb = _padded(atrium, g)
            got = binned.emit_launch(fat, o, inv, tb, block_trace.T_MIN, g, pcap, em, mode)
            want = binned._emit(fat, o, inv, tb, block_trace.T_MIN, g, pcap, em)
            assert int(want[0].sum()) > 0
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (
                mode, g, em, pcap)


def test_k5_matches_plain(atrium):
    """K5 against bin_min_plain on the same bins, g 8 and 16, sb 1 and 2."""
    fat, o, d, tm = atrium["fat"], atrium["o"], atrium["d"], atrium["t_max"]
    for g, sb in ((8, 1), (16, 2)):
        bins = binned.bin_pairs(fat, o, d, tm, g=g, mcap=MCAP, sb=sb)
        tk, sk = binned.unpack(binned.launch(fat, bins, "closest"))
        tp, sp = binned.unpack(binned.bin_min_plain(fat, bins))
        assert (sk == sp).float().mean().item() >= AGREE
        same = (sk == sp) & torch.isfinite(tp)
        torch.testing.assert_close(tk[same], tp[same], rtol=T_RTOL, atol=0.0)


def _values(rng, kind, shape, nonzero=False):
    if kind == "int":
        x = rng.choice(NONZERO, shape) if nonzero else rng.integers(-3, 4, shape)
    else:
        x = rng.standard_normal(shape)
    return x.astype(np.float32)


def test_microbench_kernels_match_plain(dev):
    """T1-T4 against their plain versions on integer sets, bit for bit."""
    rng = np.random.default_rng(5)

    def bf16(x):
        return torch.from_numpy(x).to(dev, torch.bfloat16)

    k, iters = 64, 6
    word = torch.tensor([1, 0, 3, 1, 0, 1, 1, 2], dtype=torch.int32, device=dev)
    n = torch.tensor([iters - 1], dtype=torch.int32, device=dev)
    for variant in perf_commit_pipeline.VARIANTS:
        lanes = perf_commit_pipeline.lanes_of(variant)
        feat = bf16(_values(rng, "int", (4, 48, 4 * k)))
        for ctas in (1, 3):
            rays = bf16(_values(rng, "int", (48, ctas * lanes)))
            got = perf_commit_pipeline.run_inner(rays, feat, word, n, variant, k, iters)
            want = perf_commit_pipeline.run_inner_plain(rays, feat, word, n, variant, k, iters)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (variant, ctas)
    slab = bf16(_values(rng, "int", (48, 4 * k)))
    rays = bf16(_values(rng, "int", (48, 256), nonzero=True))
    for variant in perf_epilogue.VARIANTS:
        got = perf_epilogue.run(slab, rays, variant, k, 256, iters)
        want = perf_epilogue.run_plain(slab, rays, variant, k, 256, iters)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), variant
    rays = rays[:, :128].contiguous()
    feat = bf16(_values(rng, "int", (4, 48, 4 * k)))
    for dep in (False, True):
        got = probe_mxu_loop.run(rays, feat, iters, dep)
        assert torch.equal(got, probe_mxu_loop.run_plain(rays, feat, iters, dep))
    for c, passes, reps in ((8, 3, 1), (16, 0, 1), (128, 5, 2)):
        a = torch.from_numpy(_values(rng, "int", (c, 128))).to(dev)
        b = torch.from_numpy(np.abs(_values(rng, "int", (c, 64)))).to(dev)
        got = bench_mxu_model.run(a, b, iters, passes, reps)
        assert torch.equal(got, bench_mxu_model.run_plain(a, b, iters, passes, reps))


# rows of a visit: below, at and past one 32-row tile, not a whole number of
# tiles (72), and up to the packed argmin's 1,024 rows
VISIT_KS = (8, 16, 72, 256, 512, 1024)
VISITS = 6
# least share of equal outputs on the normal sets. T1's best + acc[0] is
# quantised by the packed argmin's 2^-13 band (least measured on the H100:
# 0.945); T2's best is the f32 minimum itself, of sums taken in another
# order (least measured: 0.332, the none variant)
T1_EQUAL = 0.9
T2_EQUAL = 0.25


def _share_equal(got, want, tol, name):
    """|got - want| <= tol on every output (equal values, inf included,
    differ by 0) -> the share of outputs that are equal."""
    diff = torch.where(got == want, 0.0, (got.double() - want.double()).abs())
    assert bool((diff <= tol).all()), (name, float((diff / tol).max()))
    return float((diff == 0).double().mean())


@pytest.mark.parametrize("k", VISIT_KS)
def test_commit_pipeline_kernel_at_k(dev, k):
    """T1 (wgmma products on a TMA ring of slab tiles) against its plain
    version at k rows, every variant (bare and classify scaled by 2^58, so
    that acc[0] shows beside best's 3e38): small integers bit for bit on one
    CTA and on three independent CTAs; standard normal values every lane's
    row 0 within perf_commit_pipeline.tolerance (the f32 sums in another
    order, the packed argmin's band), at least T1_EQUAL of it equal."""
    t1 = perf_commit_pipeline
    rng = np.random.default_rng(k)
    word = torch.tensor([1, 0, 3, 1, 0, 1, 1, 2], dtype=torch.int32, device=dev)
    n = torch.tensor([VISITS - 1], dtype=torch.int32, device=dev)
    for v in t1.VARIANTS:
        lanes = t1.lanes_of(v)
        scale = 2.0 ** 58 if v in ("bare", "classify") else 1.0
        for ctas in (1, 3):
            rays = torch.from_numpy(_values(rng, "int", (48, ctas * lanes)) * scale).to(
                dev, torch.bfloat16)
            feat = torch.from_numpy(_values(rng, "int", (4, 48, 4 * k)) * scale).to(
                dev, torch.bfloat16)
            got = t1.run_inner(rays, feat, word, n, v, k, VISITS)
            want = t1.run_inner_plain(rays, feat, word, n, v, k, VISITS)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (v, k, ctas)
        rays = torch.from_numpy(_values(rng, "normal", (48, lanes)) * scale).to(dev, torch.bfloat16)
        feat = torch.from_numpy(_values(rng, "normal", (4, 48, 4 * k)) * scale).to(
            dev, torch.bfloat16)
        got = t1.run_inner(rays, feat, word, n, v, k, VISITS)
        want = t1.run_inner_plain(rays, feat, word, n, v, k, VISITS)
        tol = t1.tolerance(rays, feat, k, VISITS, v, want)
        assert _share_equal(got[0], want[0], tol, (v, k)) >= T1_EQUAL, (v, k)


@pytest.mark.parametrize("k", VISIT_KS)
def test_epilogue_kernel_at_k(dev, k):
    """T2 (three wgmma products of the f32 rays' bf16 parts, the slab
    streamed through the TMA ring) against its plain version at k rows,
    every variant, 256 lanes (two CTAs): small nonzero integers bit for bit;
    standard normal values every lane's best within perf_epilogue.tolerance
    (the f32 sums of every candidate that may reach the best, SUM_ULPS per
    term, and the packed argmin's band), at least T2_EQUAL equal, and every
    lane past REL_TOL of its value shown (run with -rP) beside the float64
    run's winner, whose a or t_num sums must cancel past CANCELLING."""
    t2 = perf_epilogue
    rng = np.random.default_rng(100 + k)
    for v in t2.VARIANTS:
        for kind in ("int", "normal"):
            slab = torch.from_numpy(_values(rng, kind, (48, 4 * k))).to(dev, torch.bfloat16)
            rays = torch.from_numpy(_values(rng, kind, (48, 256), nonzero=True)).to(
                dev, torch.bfloat16)
            want = t2.run_plain(slab, rays, v, k, 256, VISITS)
            got = t2.run(slab, rays, v, k, 256, VISITS)
            if kind == "int":
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (v, k)
            else:
                tol = t2.tolerance(slab, rays, v, k, VISITS, want)
                share = _share_equal(got, want, tol, (v, k))
                assert share >= T2_EQUAL, (v, k, share)
                # a lane past 2^-12 of its value is a winner whose sums cancel
                for lane in t2.past_band(slab, rays, v, k, VISITS, got, want):
                    print(f"[T2 past 2^-12] {lane['line']}")
                    assert lane["cancel"] >= t2.CANCELLING, lane["line"]


@pytest.mark.parametrize("k", VISIT_KS)
def test_mxu_loop_kernel_at_k(dev, k):
    """T3 (T1's bare visit on the TMA ring of slab tiles, plus the scalar
    carry fed back into the rays with dep) against its plain version at k
    rows, dep 0 and 1: small integers (rays nonzero, so rays + bf16(carry)
    stays exact) bit for bit; standard normal values every lane within
    probe_mxu_loop.tolerance."""
    t3 = probe_mxu_loop
    rng = np.random.default_rng(200 + k)
    for dep in (False, True):
        for kind in ("int", "normal"):
            rays = torch.from_numpy(_values(rng, kind, (48, t3.B), nonzero=True)).to(
                dev, torch.bfloat16)
            feat = torch.from_numpy(_values(rng, kind, (t3.NL, 48, 4 * k))).to(
                dev, torch.bfloat16)
            got = t3.run(rays, feat, VISITS, dep)
            want = t3.run_plain(rays, feat, VISITS, dep)
            if kind == "int":
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (k, dep)
            else:
                _share_equal(got, want, t3.tolerance(rays, feat, VISITS), (k, dep))


@pytest.mark.parametrize("c", [8, 16, 32, 48, 128])
def test_mxu_model_kernel_at_c(dev, c):
    """T4 (wgmma products of bf16 operands that the CTA's own threads stage,
    passes and iterations summed in the accumulators) against its plain
    version at C = c (48: not a multiple of 16), passes 0, 1, 3 and 5: at
    reps 1 and 8 on two output tiles in each direction of every slice, and
    on 1024 x 256 and 1024 x 512 outputs, whose tiles the library makes 32
    and 64 columns wide where shared memory allows; small integers (b >= 0,
    so b fi + p never cancels) bit for bit, standard normal values within
    bench_mxu_model.tolerance."""
    t4 = bench_mxu_model
    rng = np.random.default_rng(300 + c)
    for passes in (0, 1, 3, 5):
        for m, b, reps in ((128, 32, 1), (1024, 32, 8), (1024, 256, 1), (1024, 512, 1)):
            (tm, tn), _ = t4.geometry(c, m, b, passes)
            if b == 32:  # two tiles of each slice in each direction
                assert (m // reps, b) == (2 * tm, 2 * tn), (tm, tn)
            for kind in ("int", "normal"):
                a = torch.from_numpy(_values(rng, kind, (c, m))).to(dev)
                bb = torch.from_numpy(_values(rng, kind, (c, b))).to(dev)
                bb = bb.abs() if kind == "int" else bb
                got = t4.run(a, bb, VISITS, passes, reps)
                want = t4.run_plain(a, bb, VISITS, passes, reps)
                if kind == "int":
                    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
                        passes, m, b, reps)
                else:
                    _share_equal(got, want, t4.tolerance(a, bb, VISITS, passes),
                                 (passes, m, b, reps))


def test_mxu_model_refuses_partial_tiles(dev):
    """T4 takes outputs of whole CTA tiles only, each slice of M / reps rows
    too, and C from 1 to 128: the wrapper raises for the rest."""
    t4 = bench_mxu_model
    (tm, tn), _ = t4.geometry(16, 128, 32, 3)
    for c, m, b, reps in ((16, tm + tm // 2, 2 * tn, 1), (16, 2 * tm, tn + 8, 1),
                          (16, 2 * tm, 2 * tn, 4), (129, 2 * tm, 2 * tn, 1)):
        a = torch.zeros((c, m), device=dev)
        bb = torch.zeros((c, b), device=dev)
        with pytest.raises(ValueError):
            t4.run(a, bb, 2, 3, reps)


def test_dense_tracer_on_the_card(dev):
    """The dense tracer's product runs in full f32 (against float64), its
    hits equal the brute force's on the Cornell camera rays, and a Cornell
    render on the card agrees with the same render on the CPU."""
    g = builtin.cornell_box()
    scene, _ = flatten.flatten(g.root, device=dev)
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, 64, 64, device=dev)
    px, py = camera.pixel_grid(64, 64, dev)
    o, d = camera.generate_rays(view, px, py, torch.full((4096, 2), 0.5, device=dev), 64, 64)
    rays = mxu.ray_features(o, d)
    feat = scene.tri_features
    c = feat.shape[0]
    m = torch.backends.cuda.matmul
    name, on = ("fp32_precision", "tf32") if hasattr(m, "fp32_precision") else ("allow_tf32", True)
    before = getattr(m, name)
    setattr(m, name, on)  # a caller's TF32, which the tracer must not take
    try:
        a, _, _, _ = mxu._chunk_quants(rays, feat)
    finally:
        setattr(m, name, before)
    exact = (rays.double() @ feat.double().permute(1, 0, 2).reshape(10, c * 4)).view(-1, c, 4)
    mag = (rays.double().abs() @ feat.double().abs().permute(1, 0, 2).reshape(10, c * 4))
    assert torch.all((a.double() - exact[..., 0]).abs() <= 1e-5 * mag.view(-1, c, 4)[..., 0] + 1e-30)
    hm = mxu.intersect_mxu(o, d, feat)
    hb = intersect.intersect_brute_force(o, d, scene.geo.positions, scene.geo.indices)
    assert (hm.tri == hb.tri).float().mean().item() >= AGREE
    same = (hm.tri == hb.tri) & (hb.tri >= 0)
    torch.testing.assert_close(hm.t[same], hb.t[same], rtol=2.0 ** -12, atol=0.0)
    cfg = integrator.RenderConfig(width=64, height=64, max_bounces=3, presample_lights=256)
    img = integrator.render_path(scene, view, cfg, 0).cpu().numpy()
    cpu_scene, _ = flatten.flatten(g.root, device="cpu")
    cpu_view = camera.make_view(node.to_world(), cam.fovy, 64, 64, device="cpu")
    ref = integrator.render_path(cpu_scene, cpu_view, cfg, 0).numpy()
    assert abs(img.mean() - ref.mean()) <= 0.02 * ref.mean()
    assert np.all(np.abs(img - ref) <= 1e-3 * (1 + np.abs(ref)), axis=-1).mean() >= 0.97


def test_texture_sampling_on_the_card(dev):
    """Texture samples on the card (nearest, bilinear, trilinear and
    stochastic trilinear; uvs outside [0, 1), tex id -1) against the same
    samples on the CPU, within 1e-6: the same f16 texels, blended in f32."""
    rng = np.random.default_rng(12)
    imgs = [rng.random((32, 32, 3), dtype=np.float32) for _ in range(3)]
    stack = texture.build_texture_stack(imgs, res=32)
    st_d, st_c = schema.to_device(stack, dev), schema.to_device(stack, "cpu")
    n = 8192
    uv = torch.from_numpy(rng.uniform(-2.0, 17.0, (n, 2)).astype(np.float32))
    tid = torch.from_numpy(rng.integers(-1, 3, n).astype(np.int32))
    flod = torch.from_numpy(rng.uniform(-0.5, 6.0, n).astype(np.float32))
    ilod = torch.from_numpy(rng.integers(0, 6, n).astype(np.int32))
    u_lod = torch.from_numpy(rng.random(n, dtype=np.float32))
    cases = [
        (texture.sample_nearest, (ilod,)),
        (texture.sample_bilinear, (ilod,)),
        (texture.sample_bilinear, (flod,)),
        (texture.sample_bilinear, (flod, u_lod)),
    ]
    for fn, extra in cases:
        got = fn(st_d, tid.to(dev), uv.to(dev), *(x.to(dev) for x in extra))
        want = fn(st_c, tid, uv, *extra)
        torch.testing.assert_close(got.cpu(), want, rtol=0.0, atol=1e-6)


def test_colonnade_render_on_the_card(dev, tmp_path):
    """The golden's small colonnade at 48x48 through the block kernel
    (``tracer="pallas"``: K1/K2 and the slot payload's texture columns) on
    the card against the same render on the CPU (the kernel's plain
    version), within test_torch_slice's bounds."""
    g, _ = sample_assets.load_colonnade(tmp_path, columns=3, seg=12, rings=6, tex_res=64,
                                        env_res=64)
    node, cam = flatten.find_camera(g.root)
    cfg = integrator.RenderConfig(width=48, height=48, max_bounces=2, bsdf="disney",
                                  presample_lights=256, tracer="pallas")
    imgs = []
    for device in (dev, "cpu"):
        scene, _ = flatten.flatten(g.root, device=device)
        view = camera.make_view(node.to_world(), cam.fovy, 48, 48, device=device)
        before = dict(block_trace.LAUNCHES)
        imgs.append(integrator.render_path_progressive(scene, view, cfg, 2).cpu().numpy())
        if device == dev:
            assert block_trace.LAUNCHES["closest"] > before["closest"]
            assert block_trace.LAUNCHES["occluded"] > before["occluded"]
    img, ref = imgs
    assert np.isfinite(img).all()
    assert abs(img.mean() - ref.mean()) <= 0.02 * ref.mean()
    assert np.all(np.abs(img - ref) <= 1e-3 * (1 + np.abs(ref)), axis=-1).mean() >= 0.97


@pytest.fixture(scope="module")
def tiny_render(atrium, dev):
    """The tiny atrium's view at 64x32 and the bench configuration (3
    bounces) on the block kernel."""
    g = builtin.atrium(columns=1, stacks=6, slices=12)
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, 64, 32, device=dev)
    cfg = integrator.RenderConfig(width=64, height=32, max_bounces=3, bsdf="disney",
                                  presample_lights=4096, coherent_tiles=16, tracer="pallas")
    return atrium["scene"], view, cfg


def test_batched_equals_progressive_on_the_card(tiny_render):
    """``render_path_batched`` sums the same samples as
    ``render_path_progressive`` (rtol 1e-5, atol 1e-7); its ray count is
    the samples' sum."""
    scene, view, cfg = tiny_render
    before = block_trace.LAUNCHES["closest"]
    img, rays = integrator.render_path_batched(scene, view, cfg, 3, 2)
    assert block_trace.LAUNCHES["closest"] - before == 3 * 4
    ref = integrator.render_path_progressive(scene, view, cfg, 3, 2)
    torch.testing.assert_close(img, ref, rtol=1e-5, atol=1e-7)
    counts = [int(integrator.render_path_with_counts(scene, view, cfg, s)[1]) for s in (2, 3, 4)]
    assert int(rays) == sum(counts)


def test_lanes_without_presample_equal_sequential_on_the_card(tiny_render):
    """Without the light tile, ``render_path_lanes`` (2 samples as one
    4,096-lane wave) is the sequential mean (rtol 1e-5, atol 1e-7)."""
    scene, view, cfg = tiny_render
    cfg = dataclasses.replace(cfg, presample_lights=0, coherent_tiles=0)
    img, rays = integrator.render_path_lanes(scene, view, cfg, 2, 5)
    ref = integrator.render_path_progressive(scene, view, cfg, 2, 5)
    torch.testing.assert_close(img, ref, rtol=1e-5, atol=1e-7)
    counts = [int(integrator.render_path_with_counts(scene, view, cfg, s)[1]) for s in (5, 6)]
    assert int(rays) == sum(counts)


def test_non_binding_wave_caps_equal_uncapped_on_the_card(tiny_render):
    """Caps of 1.0 never compact: the uncapped render (rtol 1e-5, atol
    1e-7) and its ray count."""
    scene, view, cfg = tiny_render
    img, n = integrator.render_path_with_counts(
        scene, view, dataclasses.replace(cfg, wave_caps=(1.0,)), 1)
    ref, n_ref = integrator.render_path_with_counts(scene, view, cfg, 1)
    torch.testing.assert_close(img, ref, rtol=1e-5, atol=1e-7)
    assert int(n) == int(n_ref)


def _parity(img, ref):
    img, ref = img.cpu().numpy(), ref.cpu().numpy()
    assert np.isfinite(img).all()
    assert abs(img.mean() - ref.mean()) <= 0.02 * ref.mean()
    assert np.all(np.abs(img - ref) <= 1e-3 * (1 + np.abs(ref)), axis=-1).mean() >= 0.97


@pytest.mark.parametrize("lvc", [0, 4])
def test_bdpt_on_the_block_kernel_matches_plain_tracers(tiny_render, lvc):
    """A BDPT sample through K1 (8 subpath waves) and K2 (3 connection
    batches) against the same sample on the brute-force tracer."""
    scene, view, cfg = tiny_render
    cfg = dataclasses.replace(cfg, lvc_connections=lvc)
    before = dict(block_trace.LAUNCHES)
    img = bdpt.render_bdpt(scene, view, cfg, 4)
    assert block_trace.LAUNCHES["closest"] - before["closest"] == 8
    assert block_trace.LAUNCHES["occluded"] - before["occluded"] == 3
    _parity(img, bdpt.render_bdpt(scene, view, dataclasses.replace(cfg, tracer="brute"), 4))


def test_lt_on_the_block_kernel_matches_plain_tracers(tiny_render):
    """A light-traced sample through K1/K2 against the brute-force tracer."""
    scene, view, cfg = tiny_render
    before = dict(block_trace.LAUNCHES)
    img = lighttrace.render_lt(scene, view, cfg, 2)
    assert block_trace.LAUNCHES["closest"] - before["closest"] == 5
    assert block_trace.LAUNCHES["occluded"] - before["occluded"] == 4
    _parity(img, lighttrace.render_lt(scene, view, dataclasses.replace(cfg, tracer="brute"), 2))


def test_bdpt_same_seed_bit_equal_on_the_card(tiny_render):
    """The splat is summed in a fixed order, so two renders of one seed are
    equal bit for bit, whole and in 4 chunks."""
    scene, view, cfg = tiny_render
    cfg = dataclasses.replace(cfg, lvc_connections=4)
    assert torch.equal(bdpt.render_bdpt(scene, view, cfg, 6), bdpt.render_bdpt(scene, view, cfg, 6))
    assert torch.equal(bdpt.render_bdpt_chunked(scene, view, cfg, 6, 4),
                       bdpt.render_bdpt_chunked(scene, view, cfg, 6, 4))


def test_splat_add_fixed_order_on_the_card(dev):
    """1M terms on 4,096 pixels: the per-pixel sums against float64, and
    two calls bit-equal."""
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 4096, 1 << 20) ** 2 % 4096
    val = rng.standard_normal((1 << 20, 3)).astype(np.float32)
    want = np.zeros((4096, 3))
    np.add.at(want, idx, val.astype(np.float64))
    base = torch.zeros((4096, 3), device=dev)
    ti, tv = torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev)
    a = lighttrace.splat_add(base, ti, tv)
    assert torch.equal(a, lighttrace.splat_add(base, ti, tv))
    np.testing.assert_allclose(a.cpu().numpy(), want, rtol=1e-6, atol=1e-3)


def _gbuffers(tiny_render):
    """The tiny atrium's G-buffer through K1 and through the card's brute
    force tracer, a moved camera's against the first view."""
    scene, view, cfg = tiny_render
    g = builtin.atrium(columns=1, stacks=6, slices=12)
    node, cam = flatten.find_camera(g.root)
    c2w = node.to_world().copy()
    c2w[:, 3] += (0.3, 0.1, 0.5)
    view2 = camera.make_view(c2w, cam.fovy, cfg.width, cfg.height, device=view[0].device)
    before = block_trace.LAUNCHES["closest"]
    gb = aov.render_gbuffer(scene, view2, view, cfg)
    launches = block_trace.LAUNCHES["closest"] - before
    ref = aov.render_gbuffer(scene, view2, view, dataclasses.replace(cfg, tracer="brute"))
    return gb, ref, launches


def test_gbuffer_on_the_block_kernel_matches_brute(tiny_render):
    gb, ref, launches = _gbuffers(tiny_render)
    assert launches == 1
    same = gb.instance == ref.instance
    assert float(same.float().mean()) >= AGREE
    hit = same & (ref.instance >= 0)
    for a, b in ((gb.albedo, ref.albedo), (gb.normal, ref.normal), (gb.prev_uv, ref.prev_uv)):
        torch.testing.assert_close(a[hit], b[hit], rtol=0, atol=1e-4)
    torch.testing.assert_close(gb.depth[hit], ref.depth[hit], rtol=1e-5, atol=0)
    assert bool(torch.isinf(gb.depth[gb.instance < 0]).all())


def test_denoiser_on_the_card_matches_cpu(tiny_render):
    gb, _, _ = _gbuffers(tiny_render)
    scene, view, cfg = tiny_render
    rng = np.random.default_rng(8)
    dcfg = denoise.DenoiseConfig(history_tap=1)
    states = [denoise.init_state(cfg.height, cfg.width, gb.depth.device),
              denoise.init_state(cfg.height, cfg.width, "cpu")]
    gb_cpu = aov.GBuffer(*(x.cpu() for x in gb))
    for _ in range(2):
        rad = (rng.exponential(1.0, (cfg.height, cfg.width, 3)) * 0.3).astype(np.float32)
        states[0], out = denoise.denoise(states[0], torch.from_numpy(rad).to(gb.depth.device),
                                         gb, dcfg)
        states[1], ref = denoise.denoise(states[1], torch.from_numpy(rad), gb_cpu, dcfg)
        torch.testing.assert_close(out.cpu(), ref, rtol=2e-5, atol=2e-6)
        torch.testing.assert_close(states[0].color.cpu(), states[1].color, rtol=2e-5, atol=2e-6)
