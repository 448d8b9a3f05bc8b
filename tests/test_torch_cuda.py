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
exact); the dense tracer's product against float64 within 1e-5 of its
magnitude (TF32 would lose 1e-3), and its render within test_torch_slice's
bounds of the CPU render.
"""

import numpy as np
import pytest
import torch

from stratum_tpu_torch.ops import binned, block_trace, intersect, mxu
from stratum_tpu_torch.ops.packet import FatBVH
from stratum_tpu_torch.render import camera, integrator
from stratum_tpu_torch.scene import builtin, flatten
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
