"""The port's main path, ``render_path_with_counts``, against the JAX
reference on the tiny atrium at 64x32 with the bench configuration (Disney,
4 bounces, presample 4096, coherent tiles 16; NEE + MIS + RR, sorted closest
waves, one deferred shadow wave).

The JAX side uses ``tracer="packet"`` and the port ``tracer="pallas"`` (its
block kernel): "auto" resolves to the dense MXU tracer below 16,384
triangles in both, while these keep the peel, the sort and the deferred
wave (integrator.py:383, 704). Both packages get the same scene (through
the bridge) and the same camera. ``test_dense_tracers_match_reference``
holds the port's ``mxu`` and ``brute`` renders to the reference's with the
same tracer, under the same bounds.

Bounds. Paths diverge only where a discrete decision (a near-tie hit, a
Russian-roulette or lobe draw) lands on the other side of its threshold,
and one diverged path can move a 2048-pixel image's mean by up to ~1 %.
Measured on the first run: image means equal to 1e-7 relative, 100 % of
pixels within 1e-3, n_rays equal, for seeds 0-3. Bounds, with margin for a
few diverged paths: mean within 2 % relative, >= 97 % of pixels within
1e-3 (abs + rel), n_rays within 1 %. chip_smoke.py holds the GPU render to
twice these bounds against tests/golden/torch_atrium_tiny.npz.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.ops import binned as jbinned
from stratum_tpu.render import camera as jcamera
from stratum_tpu.render import integrator as jintegrator
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu_torch.ops import binned, block_trace
from stratum_tpu_torch.render import camera, integrator
from stratum_tpu_torch.scene import bridge, builtin, flatten

torch.set_num_threads(2)

MEAN_REL = 0.02
PIXEL_SHARE = 0.97
RAYS_REL = 0.01
W, H = 64, 32
BENCH = dict(width=W, height=H, max_bounces=4, bsdf="disney",
             presample_lights=4096, coherent_tiles=16)
GOLDEN = Path(__file__).resolve().parent / "golden" / "torch_atrium_tiny.npz"


def _cfg(**kw):
    """The port's RenderConfig on its block kernel unless ``kw`` names a
    tracer."""
    return integrator.RenderConfig(**{"tracer": "pallas", **kw})


def _agree(img, ref, n, n_ref):
    img, ref = np.asarray(img), np.asarray(ref)
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert abs(img.mean() - ref.mean()) <= MEAN_REL * ref.mean(), (img.mean(), ref.mean())
    pix = np.all(np.abs(img - ref) <= 1e-3 * (1 + np.abs(ref)), axis=-1).mean()
    assert pix >= PIXEL_SHARE, pix
    assert abs(int(n) - int(n_ref)) <= RAYS_REL * int(n_ref), (int(n), int(n_ref))


@pytest.fixture(scope="module")
def case():
    g = jbuiltin.atrium(columns=1, stacks=6, slices=12)
    js, _ = jflatten.flatten(g.root)
    node, cam = jflatten.find_camera(g.root)
    c2w = np.asarray(node.to_world())
    return dict(
        js=js, jview=jcamera.make_view(c2w, cam.fovy, W, H),
        ps=bridge.scene_from_numpy(bridge.numpy_fields(js), "cpu"),
        pview=camera.make_view(c2w, cam.fovy, W, H, device="cpu"),
    )


def _render_both(case, seed, **cfg):
    jimg, jn = jintegrator.render_path_with_counts(
        case["js"], case["jview"], jintegrator.RenderConfig(tracer="packet", **cfg), seed
    )
    pimg, pn = integrator.render_path_with_counts(
        case["ps"], case["pview"], _cfg(**cfg), seed
    )
    return pimg.numpy(), pn, np.asarray(jimg), jn


@pytest.mark.parametrize("seed", [0, 1])
def test_bench_config_matches_reference(case, seed):
    pimg, pn, jimg, jn = _render_both(case, seed, **BENCH)
    _agree(pimg, jimg, pn, jn)
    assert pn.dtype == torch.int64 and int(pn) > W * H


def test_per_lane_lambert_nee_matches_reference(case):
    """No light tile (per-lane light sampling) and the Lambertian BSDF."""
    cfg = dict(width=W, height=H, max_bounces=3, bsdf="lambert")
    pimg, pn, jimg, jn = _render_both(case, 2, **cfg)
    _agree(pimg, jimg, pn, jn)


@pytest.mark.parametrize("option", [dict(sort_rays=False), dict(defer_shadows=False)])
def test_trace_options_match_reference(case, option):
    """The unsorted closest waves and per-bounce (not deferred) shadow rays,
    both off the bench configuration, against the reference with the same
    option."""
    pimg, pn, jimg, jn = _render_both(case, 3, **{**BENCH, **option})
    _agree(pimg, jimg, pn, jn)


def test_port_scene_matches_golden():
    """The port's own atrium build (no JAX) against the golden reference
    images, seeds 0-3 (the check chip_smoke.py repeats on the GPU)."""
    gold = np.load(GOLDEN)
    scene, _ = flatten.flatten(builtin.atrium(columns=1, stacks=6, slices=12).root, device="cpu")
    view = camera.make_view(gold["camera_to_world"], float(gold["fovy"]), W, H, device="cpu")
    cfg = _cfg(**BENCH)
    for i, seed in enumerate(gold["seeds"]):
        img, n = integrator.render_path_with_counts(scene, view, cfg, int(seed))
        _agree(img.numpy(), gold["images"][i], n, gold["n_rays"][i])


def test_schedule_knobs_are_ignored_and_options_agree(case):
    """TPU schedule knobs change nothing; the unsorted tracer gives the same
    hits (so the same image); immediate shadow rays give the same image up
    to the order of the radiance sums."""
    ref, n_ref = integrator.render_path_with_counts(
        case["ps"], case["pview"], _cfg(**BENCH), 3
    )
    knobs = _cfg(ring=1, entry_group=4, unroll_bounces=3, **BENCH)
    img, n = integrator.render_path_with_counts(case["ps"], case["pview"], knobs, 3)
    assert torch.equal(img, ref) and int(n) == int(n_ref)
    unsorted = _cfg(sort_rays=False, **BENCH)
    img, n = integrator.render_path_with_counts(case["ps"], case["pview"], unsorted, 3)
    assert torch.equal(img, ref) and int(n) == int(n_ref)
    eager = _cfg(defer_shadows=False, **BENCH)
    img, n = integrator.render_path_with_counts(case["ps"], case["pview"], eager, 3)
    torch.testing.assert_close(img, ref, rtol=1e-5, atol=1e-6)
    assert int(n) == int(n_ref)


def test_main_path_uses_the_block_tracer_wrappers(case, monkeypatch):
    """Every closest wave and the one deferred occlusion wave go through the
    block-trace wrappers: 5 closest calls and 1 occluded call per sample."""
    calls = {"closest": 0, "occluded": 0}
    real_c, real_o = block_trace.block_closest, block_trace.block_occluded

    def closest(*a, **k):
        calls["closest"] += 1
        return real_c(*a, **k)

    def occluded(*a, **k):
        calls["occluded"] += 1
        return real_o(*a, **k)

    monkeypatch.setattr(block_trace, "block_closest", closest)
    monkeypatch.setattr(block_trace, "block_occluded", occluded)
    integrator.render_path_with_counts(
        case["ps"], case["pview"], _cfg(**BENCH), 0
    )
    assert calls == {"closest": 5, "occluded": 1}


def test_capture_records_the_traced_waves(case):
    """``capture`` holds the inputs of every tracer call of a sample: five
    closest waves of W*H lanes and the one deferred shadow wave of 5*W*H
    lanes, whose replay through the wrapper gives the same image."""
    waves = {}
    img, _ = integrator.render_path_with_counts(
        case["ps"], case["pview"], _cfg(**BENCH), 0, capture=waves
    )
    assert [o.shape[0] for o, _, _ in waves["closest"]] == [W * H] * 5
    ((o, d, t),) = waves["occluded"]
    assert o.shape == d.shape == (5 * W * H, 3) and t.shape == (5 * W * H,)
    assert bool((t[:W * H] > 0).any()) and bool((t == 0).any())  # live and dead lanes
    ref, _ = integrator.render_path_with_counts(
        case["ps"], case["pview"], _cfg(**BENCH), 0
    )
    assert torch.equal(img, ref)
    replay = block_trace.block_occluded(case["ps"].fat_bvh, o, d, t)
    assert torch.equal(replay, block_trace.block_occluded_plain(case["ps"].fat_bvh, o, d, t))


def test_profile_layer_split_attributes_the_tracer_calls(case):
    """The profiling script's layer split on CPU tensors: the wrappers take
    their plain versions (no prep, no kernel), the layers add up to the
    sample, and the patched functions are restored afterwards."""
    from stratum_tpu_torch import profile_sample

    real = block_trace.block_closest, block_trace._prepare, block_trace.finalize_hit
    split = profile_sample.layer_split(
        case["ps"], case["pview"], _cfg(**BENCH), 0
    )
    assert split["calls"] == {"prep": 0, "kernel": 0, "trace": 6, "finalize_hit": 5,
                              "emit": 0, "bin_pairs": 0, "bin_step": 0, "binned": 0}
    parts = [split[k] for k in ("prep", "kernel", "trace_other", "finalize_hit", "glue")]
    assert min(parts) >= 0.0 and split["trace_other"] > 0.0
    assert sum(parts) == pytest.approx(split["sample"], rel=1e-9)
    assert (block_trace.block_closest, block_trace._prepare, block_trace.finalize_hit) == real


def test_profile_layer_split_of_the_binned_path(case):
    """``profile_sample --binned``'s split on CPU tensors: the primary wave
    on the block tracer, four binned closest waves and the binned deferred
    wave, each through the emission (plain ``_emit`` here, no kernel), sort
    and padding and the resolve; the layers add up to the sample and the
    binned module's functions are restored afterwards."""
    from stratum_tpu_torch import profile_sample

    real = binned.emit, binned.bin_pairs, binned.launch, binned.binned_closest
    cfg = _cfg(**BENCH, **profile_sample.BINNED)
    split = profile_sample.layer_split(case["ps"], case["pview"], cfg, 0)
    assert split["calls"] == {"prep": 0, "kernel": 0, "trace": 1, "finalize_hit": 5,
                              "emit": 5, "bin_pairs": 5, "bin_step": 0, "binned": 5}
    parts = [split[k] for k in ("prep", "kernel", "trace_other", "emit", "sort_pad",
                                "bin_step", "resolve", "finalize_hit", "glue")]
    assert min(parts) >= 0.0 and split["emit"] > 0.0 and split["resolve"] > 0.0
    assert sum(parts) == pytest.approx(split["sample"], rel=1e-9)
    assert (binned.emit, binned.bin_pairs, binned.launch, binned.binned_closest) == real


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_clamp_and_shadow_rr_match_reference(depth):
    """The indirect-luminance clamp and the shadow-ray roulette (off in the
    bench configuration) against the reference's helpers: same RNG draws,
    same survivors, same weights."""
    from stratum_tpu.core import rng as jrng

    rng = np.random.default_rng(depth)
    contrib = (rng.random((4096, 3), dtype=np.float32) * 4).astype(np.float32)
    candidate = rng.random(4096) < 0.8
    px = np.arange(4096, dtype=np.uint32)
    st_j = jrng.rng_init(px, px // 64, 9, depth)
    st_p = torch.from_numpy(np.asarray(st_j).view(np.int32).copy())
    kw = dict(clamp_indirect=1.5, shadow_rr=2.0)
    cj = jintegrator.RenderConfig(**kw)
    cp = _cfg(**kw)
    for min_depth in (1, 2):
        np.testing.assert_allclose(
            integrator._firefly_clamp(cp, torch.from_numpy(contrib), depth, min_depth).numpy(),
            np.asarray(jintegrator._firefly_clamp(cj, contrib, depth, min_depth)),
            rtol=1e-6,
        )
    pc, pk, ps = integrator._shadow_ray_rr(cp, torch.from_numpy(contrib),
                                           torch.from_numpy(candidate), st_p)
    jc, jk, js = jintegrator._shadow_ray_rr(cj, contrib, candidate, st_j)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ps.numpy().view(np.uint32), np.asarray(js))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-6)


@pytest.mark.parametrize("option", [
    dict(tracer="packet"), dict(tracer="bvh"),
    dict(alpha_test=True), dict(ris_candidates=4), dict(wave_caps=(1.0, 0.5)),
    dict(slim_carry=True), dict(debug_path_edges=2), dict(indirect_only=True),
    dict(use_nee=False), dict(use_mis=False),
    dict(lvc_connections=4), dict(tex_filter="stochastic"),
])
def test_unported_options_raise(case, option):
    cfg = _cfg(**{**BENCH, **option})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        integrator.render_path_with_counts(case["ps"], case["pview"], cfg, 0)


@pytest.mark.parametrize("tracer", ["mxu", "brute"])
def test_dense_tracers_match_reference(case, tracer):
    """The dense MXU tracer and the brute-force oracle on the tiny atrium
    (1,280 triangles, padded) against the reference with the same tracer:
    every wave unsorted, shadow rays traced per bounce, hits resolved by
    triangle id. Same bounds as the block-kernel renders."""
    cfg = dict(BENCH, tracer=tracer)
    jimg, jn = jintegrator.render_path_with_counts(
        case["js"], case["jview"], jintegrator.RenderConfig(**cfg), 1)
    pimg, pn = integrator.render_path_with_counts(
        case["ps"], case["pview"], integrator.RenderConfig(**cfg), 1)
    _agree(pimg.numpy(), np.asarray(jimg), pn, jn)


BINNED = [dict(binned_secondary=8, binned_shadow=8), dict(binned_bounces=1)]


@pytest.mark.parametrize("option", BINNED)
def test_binned_render_equals_block_render(case, option):
    """The binned tracer on the sorted bounce waves and the deferred shadow
    wave (or on bounce 1, unsorted) gives the block render bit for bit when
    no pair is dropped: both plain versions compute exact f32 and keep the
    lower slot on equal t."""
    cfg = {**BENCH, **option}
    waves = {}
    img, n = integrator.render_path_with_counts(
        case["ps"], case["pview"], _cfg(**cfg), 1, capture=waves
    )
    ref, n_ref = integrator.render_path_with_counts(
        case["ps"], case["pview"], _cfg(**BENCH), 1
    )
    stats = [w[-1] for k in ("binned_closest", "binned_occluded") for w in waves.get(k, [])]
    assert len(stats) == (5 if "binned_shadow" in option else 1)
    assert all(s["dropped_pcap"] == 0 and s["dropped_mcap"] == 0 and s["pairs"] > 0
               for s in stats), stats
    assert torch.equal(img, ref) and int(n) == int(n_ref)


@pytest.mark.parametrize("option", BINNED)
def test_binned_render_matches_reference(case, option):
    """The binned render against the JAX reference (``tracer="packet"``
    there, which runs no binned tracer: the hits, and so the image, are the
    same) within the file's bounds."""
    pimg, pn, jimg, jn = _render_both(case, 2, **{**BENCH, **option})
    _agree(pimg, jimg, pn, jn)


@pytest.mark.parametrize("option, calls", [
    (dict(), {"block_closest": 5, "block_occluded": 1}),
    (dict(binned_secondary=8), {"block_closest": 1, "binned_closest": 4, "block_occluded": 1}),
    (dict(binned_shadow=8), {"block_closest": 5, "binned_occluded": 1}),
    (dict(binned_bounces=2), {"block_closest": 3, "binned_closest": 2, "block_occluded": 1}),
    (dict(binned_bounces=1, binned_secondary=16, binned_shadow=8),
     {"block_closest": 1, "binned_closest": 4, "binned_occluded": 1}),
])
def test_binned_options_route_the_waves(case, monkeypatch, option, calls):
    """Counterpart of tests/test_binned.py::test_integrator_routes_binned:
    the primary peel stays on the block tracer, ``binned_secondary`` takes
    the sorted bounces, ``binned_bounces`` the first bounces (unsorted, with
    g = binned_secondary or 8) and ``binned_shadow`` the occlusion wave."""
    seen = {}
    groups = []

    def counted(module, name):
        real = getattr(module, name)

        def fn(*a, **k):
            seen[name] = seen.get(name, 0) + 1
            if name == "binned_closest":
                groups.append(k["g"])
            return real(*a, **k)

        monkeypatch.setattr(module, name, fn)

    for module, name in ((block_trace, "block_closest"), (block_trace, "block_occluded"),
                         (binned, "binned_closest"), (binned, "binned_occluded")):
        counted(module, name)
    integrator.render_path_with_counts(
        case["ps"], case["pview"], _cfg(**{**BENCH, **option}), 0
    )
    assert seen == calls
    g_b = option.get("binned_secondary") or 8
    assert groups == [g_b] * calls.get("binned_closest", 0)


@pytest.fixture(scope="module")
def binned_default_stats(case):
    waves = {}
    integrator.render_path_with_counts(
        case["ps"], case["pview"], _cfg(**BENCH, **BINNED[0]), 0,
        capture=waves)
    return {k: [w[-1] for w in waves[k]] for k in ("binned_closest", "binned_occluded")}


@pytest.mark.parametrize("field", [
    dict(binned_pcap=2), dict(binned_mcap_num=1), dict(binned_em="group"), dict(binned_sb=2),
])
def test_binned_fields_match_reference(case, binned_default_stats, field):
    """``binned_pcap``, ``binned_mcap_num``, ``binned_em`` and ``binned_sb``
    set through RenderConfig reach both binned tracers: the stats of a
    sample's first binned closest wave and of its deferred shadow wave
    differ from the defaults' and equal the JAX package's (interpret mode)
    on the same waves, with the fields resolved as the reference's
    integrator resolves them (integrator.py:326-381)."""
    fields = {**BENCH, **BINNED[0], **field}
    waves = {}
    integrator.render_path_with_counts(
        case["ps"], case["pview"], _cfg(**fields), 0, capture=waves)
    jcfg = jintegrator.RenderConfig(**fields)
    js = case["js"]
    ours, ref = [], []
    for kind, jfn, kw in (
        ("binned_closest", jbinned.pallas_closest_binned,
         dict(g=jcfg.binned_secondary, slot_payload=True)),
        ("binned_occluded", jbinned.pallas_occluded_binned, dict(g=jcfg.binned_shadow)),
    ):
        o, d, t, stats = waves[kind][0]
        n = o.shape[0]
        _, sj = jfn(js.fat_bvh, js.leaf_feat_packed, jnp.asarray(o.numpy()),
                    jnp.asarray(d.numpy()), t_max=jnp.asarray(t.numpy()),
                    pcap=jcfg.binned_pcap, sb=jcfg.binned_sb, em=jcfg.binned_em,
                    mcap=n * jcfg.binned_mcap_num // 8 if jcfg.binned_mcap_num else None,
                    interpret=True, with_stats=True, **kw)
        ours.append(stats)
        ref.append({k: int(v) for k, v in sj.items()})
    assert ours == ref
    default = [binned_default_stats[k][0] for k in ("binned_closest", "binned_occluded")]
    assert all(a != b for a, b in zip(ours, default)), (ours, default)


@pytest.mark.parametrize("option", [dict(binned_secondary=8), dict(binned_bounces=1)])
def test_binned_closest_needs_sorted_waves(case, option):
    """The reference silently ignores these without ``sort_rays``; the port
    refuses them."""
    cfg = _cfg(**{**BENCH, **option, "sort_rays": False})
    with pytest.raises(ValueError, match="sort_rays"):
        integrator.render_path_with_counts(case["ps"], case["pview"], cfg, 0)


@pytest.mark.parametrize("gs", [dict(gs=1), dict(gs=8), dict(gs=1, gs_primary=4, gs_shadow=-1)])
def test_group_size_renders_equal(case, monkeypatch, gs):
    """``gs`` / ``gs_primary`` / ``gs_shadow`` reach the block-trace
    wrappers as the reference resolves them, and the image does not depend
    on the group size."""
    seen = []
    for name in ("block_closest", "block_occluded"):
        real = getattr(block_trace, name)

        def fn(*a, _real=real, **k):
            seen.append(k["gs"])
            return _real(*a, **k)

        monkeypatch.setattr(block_trace, name, fn)
    img, n = integrator.render_path_with_counts(
        case["ps"], case["pview"], _cfg(**{**BENCH, **gs}), 3
    )
    monkeypatch.undo()
    ref, n_ref = integrator.render_path_with_counts(
        case["ps"], case["pview"], _cfg(**BENCH), 3
    )
    assert torch.equal(img, ref) and int(n) == int(n_ref)
    g = gs["gs"]
    primary = gs.get("gs_primary", g)
    shadow = 4 if gs.get("gs_shadow") == -1 else g
    assert seen == [primary] + [g] * 4 + [shadow]
