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
frames, at twice test_torch_denoise.py's bound (rtol 2e-5, atol 2e-6). The
a-trous kernel (one launch an iteration) against the plain loop on the CPU
at that bound, for every filter type with and without a history tap, on
images with background pixels whose sides are no multiple of the kernel's
32 x 8 CTA and lie under the last iteration's dilation of 16, so the taps'
edge clamps bind. SPD's sphereflake at size factor 2 forced into the
culled list mode: K1 / K2 against the plain walk, the lists bit for bit
against the plain two-level phase, and the recorder's ``overflow`` and
``reached_keys`` counters equal to its sums, with and without overflowing
CTAs. The Disney kernels (``csrc/disney.cu``) against the plain torch
bodies on the card bit for bit (equal values, NaN where they are NaN) on
every output: mixed, diffuse, glass, metal, clearcoat and anisotropic
lanes, grazing and below-horizon directions, u at 0 and one ulp below 1,
the material columns as the payload's strided views and as contiguous
tensors; torch's sum over 3 components on the card in the kernels' order;
one 4-bounce sample's 10 launches and ``bsdf`` spans, and its image equal
to the plain bodies' bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from stratum_tpu_torch.ops import binned, block_trace, intersect, mxu
from stratum_tpu_torch.ops.packet import FatBVH, build_fat_bvh_sah
from stratum_tpu_torch.render import aov, bdpt, camera, denoise, integrator, lighttrace, texture
from stratum_tpu_torch.scene import builtin, flatten, sample_assets, schema
from stratum_tpu_torch.tools import (
    bench_mxu_model,
    perf_commit_pipeline,
    perf_epilogue,
    probe_mxu_loop,
)
from stratum_tpu_torch.utils import cuda_build
from stratum_tpu_torch.utils import profiler as sprof

pytestmark = pytest.mark.cuda

AGREE = 0.999
T_RTOL = 1e-3
MCAP = 1 << 15
NONZERO = (-3.0, -2.0, -1.0, 1.0, 2.0, 3.0)


def _added(before, prefix: str = "") -> dict:
    """Kernels the launch registry counted since ``before`` (a
    ``cuda_build.launches()`` read), by key, those whose key starts with
    ``prefix``."""
    return {k: v for k, v in (cuda_build.launches() - before).items() if k.startswith(prefix)}


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


def _live_ctas(bound, n_cta):
    """The CTAs with a live ray (bound > 0)."""
    live = torch.nn.functional.pad(bound > 0, (0, n_cta * block_trace.CTA - bound.numel()))
    return live.view(n_cta, block_trace.CTA).any(dim=1)


def _expected_overflow(lists, bound, mode):
    """The CTAs that must take the overflow path: those with a live ray
    whose list is longer than CULL_LIST_KEYS, or all of them when forced."""
    live = _live_ctas(bound, lists.ncand.numel())
    return live & (lists.ncand > block_trace.CULL_LIST_KEYS if mode == "culled" else True)


def test_global_list_mode_equals_shared(atrium, monkeypatch):
    """The culled list phase (forced here; the default past AUTO_SHARED_KEYS),
    with super-groups of 2 so that CTAs cull, without overflow, with some
    CTAs overflowing (CULL_LIST_KEYS cut to 2) and with every CTA forced
    down the overflow path (``list_mode="global"``), the scratch cut to 3
    CTAs' rows so the wave runs in chunks: results and lists equal the
    shared mode's and the plain list phase's bit for bit at gs 4 and 1, and
    the CTAs that overflow are the ones whose lists predict it."""
    fat, o, d, tm = atrium["fat"], atrium["o"], atrium["d"], atrium["t_max"]
    monkeypatch.setattr(block_trace, "SUPER_SIZE", 2)
    for gs in (4, 1):
        keys = block_trace.list_keys(-(-fat.num_leaves // gs))
        monkeypatch.setattr(block_trace, "LIST_SCRATCH_BYTES", 3 * 8 * keys)
        for occluded in (False, True):
            bound = tm * block_trace.SHADOW_EPS if occluded else tm
            prep = block_trace._prepare(fat, o, d, bound, gs)
            want = block_trace.launch(fat, prep, occluded, stats="lists", list_mode="shared")
            plain = block_trace.candidate_lists(fat, o, d, bound, gs, block_trace.CTA,
                                                live_only=True)
            overflows = []
            for mode, cap in (("culled", 1024), ("culled", 2), ("global", 1024)):
                monkeypatch.setattr(block_trace, "CULL_LIST_KEYS", cap)
                got = block_trace.launch(fat, prep, occluded, stats="lists", list_mode=mode)
                for a, b in zip(got[:-1], want[:-1]):
                    assert torch.equal(a, b), (gs, occluded, mode, cap)
                for a, b, c in zip(got[-1], want[-1], plain):
                    assert torch.equal(a, b) and torch.equal(a, c[:a.shape[0]]), (
                        gs, occluded, mode, cap)
                *_, ph = block_trace.launch(fat, prep, occluded, stats="phases", list_mode=mode)
                assert torch.equal(ph.ncand, want[-1].ncand)
                assert torch.equal(ph.overflow, _expected_overflow(want[-1], bound, mode))
                live = _live_ctas(bound, ph.ncand.numel())
                assert not bool(live.all())  # lanes 256-511 are dead: CTAs 2 and 3
                assert torch.equal(ph.list_cycles > 0, live) and torch.equal(ph.walk_cycles > 0, live)
                overflows.append(int(ph.overflow.sum()))
            assert overflows[0] == 0 and 0 < overflows[1] <= overflows[2], overflows


def _grid_fat(dev, n=90, leaf_size=4, seed=3):
    """A rippled n x n height field (2 n^2 triangles) in SAH leaves of
    ``leaf_size``: 4,000+ small leaves in tree order."""
    u = np.linspace(-1.0, 1.0, n + 1, dtype=np.float32)
    zz, xx = np.meshgrid(u, u, indexing="ij")
    h = 0.1 * np.sin(4 * xx) * np.cos(3 * zz) + 0.02 * np.random.default_rng(seed).random(xx.shape)
    pos = np.stack([xx, h.astype(np.float32), zz], -1).reshape(-1, 3)
    a = (np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]).reshape(-1)
    idx = np.stack([np.stack([a, a + n + 2, a + 1], -1), np.stack([a, a + n + 1, a + n + 2], -1)],
                   axis=1).reshape(-1, 3).astype(np.int32)
    fat = build_fat_bvh_sah(pos, idx, leaf_size=leaf_size)
    return FatBVH(*(torch.from_numpy(np.asarray(x)).to(dev) for x in fat))


@pytest.mark.parametrize("gs", [1, 4])
def test_culled_lists_past_the_budget(dev, monkeypatch, gs):
    """A grid of 16,200 triangles in 4,000+ leaves of 4: past 4,096 groups
    at gs = 1, where no shared mode could hold the keys, and 1,160 at
    gs = 4, both past AUTO_SHARED_KEYS, so ``auto`` culls. 8,192 rays
    from above, coherent in CTAs, some dead or short: hits against the plain
    walk, each CTA's list and count bit for bit against the plain list
    phase and the plain two-level phase, no CTA overflowing at the default
    budget; with CULL_LIST_KEYS cut below the longest lists, exactly the
    CTAs the plain phase predicts overflow, with the same results."""
    fat = _grid_fat(dev)
    G = -(-fat.num_leaves // gs)
    assert fat.num_leaves > 4096
    rng = np.random.default_rng(9)
    n = 8192
    o = np.concatenate([rng.uniform(-0.3, 0.3, (n, 1)), np.full((n, 1), 1.5),
                        rng.uniform(-1.2, 1.2, (n, 1))], 1)
    o = o[np.argsort(o[:, 2])]
    tgt = np.concatenate([rng.uniform(-1, 1, (n, 1)), np.zeros((n, 1)),
                          o[:, 2:] + rng.uniform(-0.1, 0.1, (n, 1))], 1)
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    tm = np.full(n, intersect.T_MAX, np.float32)
    tm[::9] = 0.0
    tm[4::9] = rng.uniform(0.2, 1.4, tm[4::9].shape)
    o, d, tm = (torch.from_numpy(x.astype(np.float32)).to(dev) for x in (o, d, tm))
    mode = "auto"
    assert block_trace.resolve_list_mode(G) == "culled"
    plain = block_trace.candidate_lists(fat, o, d, tm, gs, block_trace.CTA, live_only=True)
    two, _ = block_trace.culled_lists(fat, o, d, tm, gs, block_trace.CTA)
    for a, b in zip(two, plain):
        assert torch.equal(a, b)
    hp = block_trace.block_closest_plain(fat, o, d, tm)
    op = block_trace.block_occluded_plain(fat, o, d, tm)
    n_cta = n // block_trace.CTA
    longest = int(plain.ncand.max())
    overflowed = []
    for cap in (block_trace.CULL_LIST_KEYS, 1 << ((longest - 1).bit_length() - 1)):
        monkeypatch.setattr(block_trace, "CULL_LIST_KEYS", cap)
        hk = block_trace.block_closest(fat, o, d, tm, gs=gs, list_mode=mode)
        _close_slots(hk.t, hk.slot, hp.t, hp.slot)
        ok = block_trace.block_occluded(fat, o, d, tm, gs=gs, list_mode=mode)
        assert (ok == op).float().mean().item() >= AGREE
        prep = block_trace._prepare(fat, o, d, tm, gs)
        *_, lists = block_trace.launch(fat, prep, False, stats="lists", list_mode=mode)
        for a, b in zip(lists, plain):
            assert torch.equal(a, b[:n_cta])
        *_, ph = block_trace.launch(fat, prep, False, stats="phases", list_mode=mode)
        assert torch.equal(ph.overflow, _expected_overflow(lists, tm, "culled"))
        overflowed.append(int(ph.overflow.sum()))
    assert overflowed[0] == 0 and 0 < overflowed[1] < n_cta, (overflowed, longest)


@pytest.fixture(scope="module")
def flake(dev):
    """SPD's sphereflake at size factor 2 (91 spheres of 528 triangles, the
    ground, three light spheres) on the card, and 8,192 camera rays at
    128 x 64 followed by 8,192 rays leaving the spheres' surfaces, every 5th
    lane dead and every 3rd short."""
    g = builtin.sphereflake(size_factor=2)
    scene, _ = flatten.flatten(g.root, device=dev)
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, 128, 64, device=dev)
    rng = np.random.default_rng(5)
    px, py = camera.pixel_grid(128, 64, dev)
    jit = torch.from_numpy(rng.random((8192, 2), dtype=np.float32)).to(dev)
    o_cam, d_cam = camera.generate_rays(view, px, py, jit, 128, 64)
    centres, radii = builtin.sphereflake_spheres(2)
    k = rng.integers(0, len(radii), 8192)
    n = rng.normal(size=(8192, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    o_s = centres[k] + n * radii[k, None] * 1.001
    d_s = n + rng.normal(size=(8192, 3))
    d_s /= np.linalg.norm(d_s, axis=1, keepdims=True)
    as_dev = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)  # noqa: E731
    o = torch.cat([o_cam, as_dev(o_s)]).contiguous()
    d = torch.cat([d_cam, as_dev(d_s)]).contiguous()
    t_max = np.full(16384, intersect.T_MAX, np.float32)
    t_max[::5] = 0.0
    t_max[1::3] = rng.uniform(0.05, 2.0, t_max[1::3].shape)
    return scene.fat_bvh, o, d, as_dev(t_max)


@pytest.mark.parametrize("tight", [False, True], ids=["default_budget", "small_budget"])
def test_culled_counters_on_the_flake(flake, monkeypatch, tight):
    """The flake forced into the culled list mode (super-groups of 4) at gs
    4 and 1, under the recorder: K1 / K2 against the plain walk, each CTA's
    list bit for bit against the plain two-level phase
    (``culled_lists``), and the launch span's ``overflow`` and
    ``reached_keys`` equal to that phase's overflow and ``ncand`` sums;
    with the list budget cut below the longest list, CTAs overflow."""
    fat, o, d, tm = flake
    monkeypatch.setattr(block_trace, "SUPER_SIZE", 4)
    hp = block_trace.block_closest_plain(fat, o, d, tm)
    op = block_trace.block_occluded_plain(fat, o, d, tm)
    overflowed = 0
    for gs in (4, 1):
        for occluded in (False, True):
            bound = tm * block_trace.SHADOW_EPS if occluded else tm
            cap = block_trace.CULL_LIST_KEYS
            lists, over = block_trace.culled_lists(fat, o, d, bound, gs, block_trace.CTA,
                                                   super_size=4, cap=cap)
            if tight:
                cap = 1 << ((int(lists.ncand.max()) - 1).bit_length() - 1)
                lists, over = block_trace.culled_lists(fat, o, d, bound, gs, block_trace.CTA,
                                                       super_size=4, cap=cap)
            monkeypatch.setattr(block_trace, "CULL_LIST_KEYS", cap)
            prep = block_trace._prepare(fat, o, d, bound, gs)
            sprof.start()
            try:
                *res, got = block_trace.launch(fat, prep, occluded, stats="lists",
                                               list_mode="culled")
            finally:
                sprof.stop()
            (rec,) = [r for r in sprof.records() if r.name == "launch"]
            n_cta = got.ncand.numel()
            for a, b in zip(got, lists):
                assert torch.equal(a, b[:n_cta]), (gs, occluded, tight)
            if occluded:
                blocked = res[0][:prep.n].bool()
                assert (blocked == op).float().mean().item() >= AGREE
            else:
                _close_slots(res[0][:prep.n], res[1][:prep.n], hp.t, hp.slot)
            assert rec.attrs["mode"] == "culled" and rec.attrs["ctas"] == n_cta
            assert rec.attrs["overflow"] == int(over.sum())
            assert rec.attrs["reached_keys"] == int(lists.ncand.sum())
            overflowed += rec.attrs["overflow"]
    assert (overflowed > 0) == tight, overflowed


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
        before = cuda_build.launches()
        imgs.append(integrator.render_path_progressive(scene, view, cfg, 2).cpu().numpy())
        if device == dev:
            after = cuda_build.launches()
            assert after["block_trace_closest"] > before["block_trace_closest"]
            assert after["block_trace_occluded"] > before["block_trace_occluded"]
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
    before = cuda_build.launches()
    img, rays = integrator.render_path_batched(scene, view, cfg, 3, 2)
    assert _added(before)["block_trace_closest"] == 3 * 4
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
    before = cuda_build.launches()
    img = bdpt.render_bdpt(scene, view, cfg, 4)
    added = _added(before)
    assert added["block_trace_closest"] == 8 and added["block_trace_occluded"] == 3
    _parity(img, bdpt.render_bdpt(scene, view, dataclasses.replace(cfg, tracer="brute"), 4))


def test_lt_on_the_block_kernel_matches_plain_tracers(tiny_render):
    """A light-traced sample through K1/K2 against the brute-force tracer."""
    scene, view, cfg = tiny_render
    before = cuda_build.launches()
    img = lighttrace.render_lt(scene, view, cfg, 2)
    added = _added(before)
    assert added["block_trace_closest"] == 5 and added["block_trace_occluded"] == 4
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
    before = cuda_build.launches()
    gb = aov.render_gbuffer(scene, view2, view, cfg)
    launches = _added(before)["block_trace_closest"]
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


def _atrous_inputs(h, w, seed):
    """Seeded a-trous inputs: three tilted planes of normals with a little
    noise, depth steps between them, 15 % background (depth inf, normal 0)."""
    rng = np.random.default_rng(seed)
    color = (rng.exponential(1.0, (h, w, 3)) * 0.3).astype(np.float32)
    var = rng.uniform(0.0, 0.3, (h, w)).astype(np.float32)
    planes = np.array([[0, 1, 0], [1, 0, 0], [0.6, 0.8, 0]], np.float32)
    lab = (np.arange(w)[None, :] * 3 // w + (np.arange(h)[:, None] > h // 2)) % 3
    normal = planes[lab] + rng.normal(0, 0.02, (h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    depth = (5 + lab + rng.uniform(0, 0.1, (h, w))).astype(np.float32)
    depth[rng.random((h, w)) < 0.15] = np.inf
    normal[np.isinf(depth)] = 0
    gb = aov.GBuffer(albedo=np.ones((h, w, 3), np.float32), normal=normal.astype(np.float32),
                     depth=depth, instance=np.zeros((h, w), np.int32),
                     prev_uv=np.zeros((h, w, 2), np.float32))
    return color, var, gb


@pytest.mark.parametrize("history_tap", [0, 2])
@pytest.mark.parametrize("filter_type", ["atrous", "box3", "box5", "subsampled",
                                         "box3_subsampled", "box5_subsampled"])
@pytest.mark.parametrize("shape", [(13, 15), (37, 70)])
def test_atrous_kernel_matches_plain(dev, shape, filter_type, history_tap):
    """``atrous_filter`` on the card (one kernel an iteration, each
    ``atrous`` span counting it as ``kernels``) against the plain loop on
    the CPU on the same inputs: the filtered colour and the history tap's
    (rtol 2e-5, atol 2e-6)."""
    color, var, gb = _atrous_inputs(*shape, seed=len(filter_type) + history_tap)
    cfg = denoise.DenoiseConfig(filter_type=filter_type, history_tap=history_tap)
    cpu = [torch.from_numpy(x) for x in (color, var)]
    gb_cpu = aov.GBuffer(*(torch.from_numpy(x) for x in gb))
    before = cuda_build.launches()
    sprof.start()
    try:
        out, tap = denoise.atrous_filter(*(x.to(dev) for x in cpu),
                                         aov.GBuffer(*(x.to(dev) for x in gb_cpu)), cfg)
    finally:
        sprof.stop()
    assert _added(before) == {"atrous_iteration": cfg.atrous_iterations}
    spans = [r for r in sprof.records() if r.name == "atrous"]
    assert [(r.attrs["it"], r.attrs["kernels"]) for r in spans] == [
        (it, 1) for it in range(cfg.atrous_iterations)]
    ref, ref_tap = denoise.atrous_filter(*cpu, gb_cpu, cfg)
    assert _added(before) == {"atrous_iteration": cfg.atrous_iterations}
    torch.testing.assert_close(out.cpu(), ref, rtol=2e-5, atol=2e-6)
    assert (tap is None) == (ref_tap is None) == (history_tap == 0)
    if tap is not None:
        torch.testing.assert_close(tap.cpu(), ref_tap, rtol=2e-5, atol=2e-6)


def test_sharded_cornell_on_the_card(dev):
    """``render_path_sharded`` with two shards on the one card against
    ``render_path`` (the dense tracer): tests/test_parallel.py's bounds,
    allclose rtol 1e-4 / atol 1e-6 and > 90 % of pixels bit-equal."""
    from stratum_tpu_torch.parallel import mesh as pmesh

    g = builtin.cornell_box()
    scene, _ = flatten.flatten(g.root, device=dev)
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, 64, 32, device=dev)
    cfg = integrator.RenderConfig(width=64, height=32, max_bounces=3)
    single = integrator.render_path(scene, view, cfg, 5).cpu().numpy().reshape(-1, 3)
    sharded = pmesh.render_path_sharded(scene, view, cfg, 5, pmesh.make_mesh([dev, dev]))
    assert sharded.device == dev
    sharded = sharded.cpu().numpy().reshape(-1, 3)
    np.testing.assert_allclose(sharded, single, rtol=1e-4, atol=1e-6)
    assert (sharded == single).all(axis=-1).mean() > 0.9


def test_glb_texture_stack_on_the_card(dev, tmp_path):
    """A GLB with an embedded PNG, loaded by the port's glTF loader and
    flattened on the card and on the CPU: the texture stacks equal bit for
    bit and hold the image."""
    import json
    import struct

    from stratum_tpu_torch.io import image as pimage
    from stratum_tpu_torch.scene.graph import NodeGraph
    from stratum_tpu_torch.scene.loaders.gltf import load_gltf

    rng = np.random.default_rng(14)
    pimage.write_png(tmp_path / "t.png", (rng.random((32, 32, 4)) * 255).astype(np.uint8))
    png = (tmp_path / "t.png").read_bytes()
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    uv = np.asarray([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32)
    idx = np.asarray([0, 1, 2, 2, 1, 3], np.uint16)
    raw = pos.tobytes() + uv.tobytes() + idx.tobytes() + b"\0" * 4
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                                    "indices": 2, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}],
        "textures": [{"source": 0}], "images": [{"bufferView": 3, "mimeType": "image/png"}],
        "buffers": [{"byteLength": len(raw) + len(png)}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 48},
                        {"buffer": 0, "byteOffset": 48, "byteLength": 32},
                        {"buffer": 0, "byteOffset": 80, "byteLength": 12},
                        {"buffer": 0, "byteOffset": len(raw), "byteLength": len(png)}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
                      {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC2"},
                      {"bufferView": 2, "componentType": 5123, "count": 6, "type": "SCALAR"}],
    }
    payload = json.dumps(doc).encode()
    payload += b" " * (-len(payload) % 4)
    binc = raw + png + b"\0" * (-(len(raw) + len(png)) % 4)
    body = (struct.pack("<II", len(payload), 0x4E4F534A) + payload
            + struct.pack("<II", len(binc), 0x004E4942) + binc)
    (tmp_path / "t.glb").write_bytes(struct.pack("<4sII", b"glTF", 2, 12 + len(body)) + body)
    g = NodeGraph()
    load_gltf(g.root, tmp_path / "t.glb")
    on_card, _ = flatten.flatten(g.root, device=dev)
    on_cpu, _ = flatten.flatten(g.root, device="cpu")
    assert on_card.textures.flat.device == dev and on_card.textures.resolution == 64
    for a, b in zip(on_card.textures, on_cpu.textures):
        if torch.is_tensor(a):
            assert torch.equal(a.cpu(), b)
        else:
            assert a == b


# -- the Disney BSDF kernels (csrc/disney.cu) -------------------------------------
E24 = 2.0 ** -24
ONE_BELOW = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


@pytest.mark.parametrize("keepdim", [False, True])
def test_sum_of_three_adds_the_outer_components_first(dev, keepdim):
    """``torch.sum(x, dim=-1)`` over 3 components on the card is
    ``(x0 + x2) + x1`` with a zero result +0: the order csrc/disney.cu's
    ``sum3`` takes. The three triples tell the three orders apart (each
    order rounds one of them to 1 + 2^-23, the others to 1); the normal
    values and a row of -0 check it on a wave."""
    rng = np.random.default_rng(21)
    x = np.concatenate([
        np.asarray([[1.0, E24, E24], [E24, 1.0, E24], [E24, E24, 1.0], [-0.0, -0.0, -0.0]]),
        rng.normal(size=(1 << 16, 3)) * rng.choice([1e-3, 1.0, 1e3], (1 << 16, 1)),
    ]).astype(np.float32)
    x = torch.from_numpy(x).to(dev)
    got = torch.sum(x, dim=-1, keepdim=keepdim).reshape(-1)
    want = (x[:, 0] + x[:, 2]) + x[:, 1] + 0.0
    assert got[:3].tolist() == [1.0, 1.0 + 2 * E24, 1.0]
    assert not torch.signbit(got[3])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _disney_inputs(dev, n, seed, payload):
    """Seeded Disney inputs on the card: (MaterialSample, wo, wi, u). The
    material kind cycles through mixed, diffuse, glass, metal, clearcoat
    and anisotropic lanes, with some at roughness 0, eta 1 and subsurface
    1. ``payload``: the columns are the strided views of [n, 88] slot
    payload rows that ``material_from_row`` hands the integrator (eta a
    contiguous ``torch.where`` as there), and wo, wi, u are views of [n, 4]
    rows; else every input is contiguous. wo lies on the upper hemisphere
    with grazing (z = 0) and below-horizon lanes; wi over the sphere with
    grazing lanes, wi = wo and wi = -wo; u holds 0 and one ulp below 1."""
    from stratum_tpu_torch.render import shading

    rng = np.random.default_rng(seed)
    kind = np.arange(n) % 6
    row = np.zeros((n, 88), np.float32)
    row[:, :64] = rng.normal(size=(n, 64))
    m = row[:, 64:88]
    m[:, 0:3] = rng.uniform(0.0, 1.0, (n, 3))
    m[:, 3:6] = rng.uniform(0.0, 2.0, (n, 3))
    u01 = rng.uniform(0.0, 1.0, (8, n)).astype(np.float32)
    m[:, 6] = np.select([kind == 0, kind == 3], [u01[0], 1.0], 0.0)
    m[:, 7] = np.where(rng.random(n) < 0.05, 0.0, 0.001 + 0.999 * u01[1])
    m[:, 8] = np.select([kind == 0, kind == 5], [u01[2], 0.2 + 0.8 * u01[2]], 0.0)
    m[:, 9] = np.select([kind == 0, kind == 1], [u01[3], np.where(u01[3] < 0.2, 1.0, u01[3])], 0.0)
    m[:, 10] = np.select([kind == 0, kind == 4], [u01[4], 1.0], 0.0)
    m[:, 11] = u01[5]
    m[:, 12] = np.select([kind == 0, kind == 2], [u01[6], 1.0], 0.0)
    m[:, 13] = np.where(u01[7] < 0.1, 1.0, 1.2 + 0.6 * u01[7])

    def unit(k):
        d = rng.normal(size=(n, 3))
        return d / np.linalg.norm(d, axis=1, keepdims=True)

    wo = unit(0)
    wo[:, 2] = np.abs(wo[:, 2])
    wo[::29, 2] = 0.0
    wo[5::31, 2] *= -1.0
    wi = unit(1)
    wi[::23, 2] = 0.0
    wi[7::37] = wo[7::37]
    wi[11::41] = -wo[11::41]
    u = rng.random((n, 3))
    u[::13, 0] = 0.0
    u[::11, 1] = ONE_BELOW
    u[3::17, 2] = 0.0
    u[4::19, 2] = ONE_BELOW
    u[5::7] = rng.choice([0.0, ONE_BELOW], (len(u[5::7]), 3))

    front = torch.from_numpy(rng.random(n) < 0.7).to(dev)
    if payload:
        rows = torch.from_numpy(row).to(dev)
        mat = shading.material_from_row(rows[:, 64:88])

        def view4(a):
            t = torch.zeros((n, 4), dtype=torch.float32, device=dev)
            t[:, :3] = torch.from_numpy(a.astype(np.float32)).to(dev)
            return t[:, :3]

        wo, wi, u = view4(wo), view4(wi), view4(u)
    else:
        mat = shading.material_from_row(torch.from_numpy(m).to(dev))
        mat = type(mat)(*(x.contiguous() for x in mat))
        wo, wi, u = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (wo, wi, u))
    mat = mat._replace(eta=torch.where(front, mat.eta, 1.0 / torch.clamp(mat.eta, min=1e-6)))
    return mat, wo, wi, u


def _differing_lanes(got, want) -> int:
    """Lanes where two outputs differ: by value, or where one is NaN and the
    other not (NaNs at the same place agree)."""
    gn, wn = torch.isnan(got), torch.isnan(want)
    bad = (gn != wn) | (~gn & ~wn & (got != want))
    return int(bad.reshape(bad.shape[0], -1).any(-1).sum())


@pytest.mark.parametrize("payload", [True, False])
@pytest.mark.parametrize("op", ["eval", "sample"])
def test_disney_kernel_equals_plain(dev, op, payload):
    """One ``csrc/disney.cu`` launch against the plain torch body on the
    same card inputs (:func:`_disney_inputs`): every output equal on every
    lane, NaN positions included; the launch registry counts the launch,
    and the sample's roughness is the input tensor."""
    from stratum_tpu_torch.render import disney

    mat, wo, wi, u = _disney_inputs(dev, 1 << 16, 5 + payload, payload)
    before = cuda_build.launches()
    if op == "eval":
        got, want = disney.disney_eval(mat, wo, wi), disney._disney_eval_plain(mat, wo, wi)
    else:
        got, want = disney.disney_sample(mat, wo, u), disney._disney_sample_plain(mat, wo, u)
        assert got.roughness is mat.roughness
    assert _added(before) == {f"disney_{op}": 1}
    diff = {k: _differing_lanes(a, b) for k, a, b in zip(got._fields, got, want)}
    bits = {k: int((a.view(torch.int32) != b.view(torch.int32)).sum())
            for k, a, b in zip(got._fields, got, want)}
    print(f"[disney {op} payload={payload}] differing lanes {diff}, differing words {bits}")
    assert set(diff.values()) == {0}, diff


def test_disney_spans_and_launches_in_a_sample(tiny_render):
    """One 4-bounce sample of the tiny atrium through K1/K2 makes 10 Disney
    launches (an eval for NEE and a sample a bounce), each a ``bsdf`` span
    inside ``shade`` with ``kernels`` 1; its image and ray count equal
    those of the same sample through the plain bodies bit for bit."""
    from stratum_tpu_torch.render import disney

    scene, view, cfg = tiny_render
    cfg = dataclasses.replace(cfg, max_bounces=4)
    before = cuda_build.launches()
    sprof.start()
    try:
        img, rays = integrator.render_path_with_counts(scene, view, cfg, 9)
    finally:
        sprof.stop()
    added = _added(before, "disney")
    assert added == {"disney_eval": 5, "disney_sample": 5}, added
    recs = sprof.records()
    spans = [r for r in recs if r.name == "bsdf"]
    assert [(r.attrs["op"], r.attrs["kernels"]) for r in spans] == [("eval", 1), ("sample", 1)] * 5
    assert all(recs[r.parent].name == "shade" and r.attrs["lanes"] == 64 * 32 for r in spans)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(disney, "disney_eval", disney._disney_eval_plain)
        mp.setattr(disney, "disney_sample", disney._disney_sample_plain)
        ref, ref_rays = integrator.render_path_with_counts(scene, view, cfg, 9)
    assert _added(before, "disney") == added
    assert torch.equal(img, ref) and int(rays) == int(ref_rays)


def test_disney_kernel_info(dev):
    """Both kernels build and report their registers and at least one
    resident CTA per SM; ptxas's report spills no byte of either."""
    from stratum_tpu_torch.render import disney

    for sample in (False, True):
        info = disney.kernel_info(sample)
        print(f"[disney kernel_info sample={sample}] {info}")
        assert info["ctas_per_sm"] >= 1, info
        assert info["spill_stores"] == 0 and info["spill_loads"] == 0, info


# -- finalize_hit (csrc/finalize.cu) ------------------------------------------------
F12 = np.float32(1e-12)  # the bound |a| is compared with, as torch casts 1e-12
# a values the kernel must treat as the plain body does: on both sides of the
# bound, zero, cancelling terms, a subnormal, large and negative
A_EDGES = np.asarray([F12, np.nextafter(F12, np.float32(1)), np.nextafter(F12, np.float32(0)),
                      -F12, -np.nextafter(F12, np.float32(1)), 0.0, -0.0, 1e-40, -1e-40,
                      1e30, -1e30, 1.0], np.float32)


def _finalize_inputs(dev, n, seed, views):
    """Seeded inputs of one closest wave on the card: (slot_payload [301,
    88], origin, direction, slot-mode HitRecord). A third of the lanes miss
    (slot -1), some hit slot 0. Rows 1..12 have a's coefficients zero but
    column 32 (d_x's), which is ``A_EDGES``; the lanes that hit them have
    direction (1, 0, 0) or, on rows 1..6, (1, 1, 0) with column 35 the
    negated edge, so a is each edge exactly or cancels to 0. ``views``:
    origin and direction are views of [n, 8] rows and the slot every other
    element of an int32 [2n], else all three are contiguous."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(301, 88)).astype(np.float32)
    rows[:, 62] = rng.integers(0, 1 << 24, 301)
    k = len(A_EDGES)
    rows[1:k + 1, 32:62:3] = 0.0
    rows[1:k + 1, 32] = A_EDGES
    rows[1:7, 35] = -A_EDGES[:6]
    o = (rng.normal(size=(n, 3)) * 10.0).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    slot = rng.integers(0, 301, n).astype(np.int32)
    slot[rng.random(n) < 1 / 3] = -1
    slot[5::17] = 0
    edge = np.arange(n) % 7 == 3
    slot[edge] = 1 + rng.integers(0, k, int(edge.sum()))
    d[edge] = (1.0, 0.0, 0.0)
    cancel = edge & (slot <= 6) & (np.arange(n) % 2 == 0)
    d[cancel] = (1.0, 1.0, 0.0)
    t = rng.uniform(0.1, 50.0, n).astype(np.float32)
    t[slot < 0] = intersect.T_MAX
    cuda = lambda a: torch.from_numpy(a).to(dev)
    if views:
        od = torch.zeros((n, 8), dtype=torch.float32, device=dev)
        od[:, 1:4], od[:, 5:8] = cuda(o), cuda(d)
        o_t, d_t = od[:, 1:4], od[:, 5:8]
        s2 = torch.full((2 * n,), 7, dtype=torch.int32, device=dev)
        s2[::2] = cuda(slot)
        slot_t = s2[::2]
    else:
        o_t, d_t, slot_t = cuda(o), cuda(d), cuda(slot)
    h = block_trace._slot_record(cuda(t), slot_t)
    return cuda(rows), o_t, d_t, h


def _differing_words(got, want) -> dict:
    """Differing 32-bit words of tri, bary and payload."""
    return {k: int((getattr(got, k).view(torch.int32) != w.view(torch.int32)).sum())
            for k, w in zip(("tri", "bary", "payload"), want)}


@pytest.mark.parametrize("n,views", [(1, False), (129, True), (65_537, False), (65_537, True)])
def test_finalize_kernel_equals_plain(dev, n, views):
    """One ``csrc/finalize.cu`` launch against the plain body on the same
    card inputs (:func:`_finalize_inputs`: misses, slot 0, a on both sides
    of 1e-12 and at 0, N no multiple of the 128-lane CTA): 0 differing
    words in tri, bary and payload; t passed through, payload contiguous;
    one launch in the registry and a ``finalize`` span with the lanes and
    ``kernels`` 1."""
    rows, o, d, h = _finalize_inputs(dev, n, 31 + n + views, views)
    want = block_trace.finalize_hit_plain(rows, o, d, h)
    before = cuda_build.launches()
    sprof.start()
    try:
        got = block_trace.finalize_hit(rows, o, d, h)
    finally:
        sprof.stop()
    assert _added(before) == {"finalize_hit": 1}
    spans = [r for r in sprof.records() if r.name == "finalize"]
    assert [(r.attrs["lanes"], r.attrs["kernels"]) for r in spans] == [(n, 1)]
    words = _differing_words(got, want)
    print(f"[finalize n={n} views={views}] differing words {words}")
    assert words == {"tri": 0, "bary": 0, "payload": 0}, words
    assert got.t is h.t and got.slot is None and got.payload.is_contiguous()
    assert got.tri.dtype == torch.int32 and bool((got.tri[h.slot < 0] == -1).all())


def test_finalize_kernel_on_an_empty_wave(dev):
    """N = 0: empty outputs of the plain body's shapes and types, no
    launch, a ``finalize`` span with ``kernels`` 0."""
    rows, o, d, h = _finalize_inputs(dev, 0, 3, False)
    before = cuda_build.launches()
    sprof.start()
    try:
        got = block_trace.finalize_hit(rows, o, d, h)
    finally:
        sprof.stop()
    assert cuda_build.launches() == before
    spans = [r for r in sprof.records() if r.name == "finalize"]
    assert [(r.attrs["lanes"], r.attrs["kernels"]) for r in spans] == [(0, 0)]
    want = block_trace.finalize_hit_plain(rows, o, d, h)
    for k, w in zip(("tri", "bary", "payload"), want):
        g = getattr(got, k)
        assert g.shape == w.shape and g.dtype == w.dtype and g.device == w.device, k


def test_finalize_spans_and_launches_in_a_sample(tiny_render):
    """One 4-bounce sample of the tiny atrium through K1/K2 launches
    ``finalize_hit`` once a closest wave (5), each a ``finalize`` span
    under its ``closest`` wave with the wave's lanes and ``kernels`` 1; its
    image and ray count equal those of the same sample through the plain
    body bit for bit."""
    scene, view, cfg = tiny_render
    cfg = dataclasses.replace(cfg, max_bounces=4)
    before = cuda_build.launches()
    sprof.start()
    try:
        img, rays = integrator.render_path_with_counts(scene, view, cfg, 9)
    finally:
        sprof.stop()
    assert _added(before, "finalize") == {"finalize_hit": 5}
    recs = sprof.records()
    spans = [r for r in recs if r.name == "finalize"]
    assert [(r.attrs["lanes"], r.attrs["kernels"]) for r in spans] == [(64 * 32, 1)] * 5
    assert all(recs[r.parent].name == "closest" for r in spans)

    def plain(slot_payload, o, d, h):
        if h.slot is None:
            return h
        tri, bary, payload = block_trace.finalize_hit_plain(slot_payload, o, d, h)
        return intersect.HitRecord(t=h.t, tri=tri, bary=bary, payload=payload)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(block_trace, "finalize_hit", plain)
        ref, ref_rays = integrator.render_path_with_counts(scene, view, cfg, 9)
    assert _added(before, "finalize") == {"finalize_hit": 5}
    assert torch.equal(img, ref) and int(rays) == int(ref_rays)


def test_finalize_kernel_info(dev):
    """The kernel builds and reports its registers, its shared memory and
    at least one resident CTA per SM; ptxas's report spills no byte."""
    info = block_trace.finalize_kernel_info()
    print(f"[finalize kernel_info] {info}")
    assert info["ctas_per_sm"] >= 1 and info["threads"] == 128, info
    assert info["spill_stores"] == 0 and info["spill_loads"] == 0, info
