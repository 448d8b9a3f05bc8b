"""The plain reference against the port's plain CPU path on a tiny scene,
the control (the reference in bfloat16 in the program's place) coming out
as not correct, and whole CPU runs with the timed path broken underneath
coming out as not correct."""

import pytest
import torch

from portbench import harness
from portbench.reference import geometry, intersect, svgf
from portbench.scenes import atrium
from portbench.tests import _tiny


@pytest.fixture(scope="module")
def tiny_scene():
    from stratum_tpu_torch.scene import flatten

    raw = atrium.build({"columns": 2, "stacks": 6, "slices": 12}, 0, None)
    g = harness.build_program_scene(raw)
    scene, _ = flatten.flatten(g.root, device="cpu")
    return raw, scene


def _rays(n, seed):
    g = torch.Generator().manual_seed(seed)
    o = torch.rand((n, 3), generator=g) * torch.tensor([20.0, 8.0, 70.0]) \
        + torch.tensor([-10.0, 0.5, -35.0])
    d = torch.randn((n, 3), generator=g)
    return o, d / d.norm(dim=-1, keepdim=True)


def test_hits_match_the_ports_plain_tracer(tiny_scene):
    from stratum_tpu_torch.ops import block_trace

    raw, scene = tiny_scene
    tris = intersect.Triangles(geometry.world(raw, "cpu", normals=False).tri)
    o, d = _rays(512, 1)
    tm = torch.full((512,), intersect.T_MAX)
    t_ref, k_ref, _, _ = intersect.closest(tris, o, d, tm)
    h = block_trace.block_closest_plain(scene.fat_bvh, o, d, tm)
    hit = h.slot >= 0
    assert bool((hit == (k_ref >= 0)).all())
    assert float(((h.t[hit] - t_ref[hit]).abs() / t_ref[hit]).max()) < 1e-5
    seg = torch.where(torch.isfinite(t_ref), t_ref * 1.5, 30.0)
    occ_ref = intersect.occluded(tris, o, d, seg)
    occ = block_trace.block_occluded_plain(scene.fat_bvh, o, d, seg)
    assert bool((occ == occ_ref).all())


def test_the_denoiser_and_tonemap_match_the_ports():
    from stratum_tpu_torch.render import aov, denoise, tonemap

    g = torch.Generator().manual_seed(3)
    h, w = 24, 40
    depth = torch.rand((h, w), generator=g) * 10 + 1
    depth[:3] = torch.inf
    nrm = torch.randn((h, w, 3), generator=g)
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    uv = torch.rand((h, w, 2), generator=g) * 1.1 - 0.05
    gb = aov.GBuffer(albedo=torch.rand((h, w, 3), generator=g), normal=nrm, depth=depth,
                     instance=torch.randint(0, 3, (h, w), generator=g, dtype=torch.int32),
                     prev_uv=uv)
    state = denoise.init_state(h, w, "cpu")
    for _ in range(3):
        rad = torch.rand((h, w, 3), generator=g) * 4
        new_p, img_p = denoise.denoise(state, rad, gb)
        new_r, img_r = svgf.denoise(state._asdict(), rad, gb._asdict())
        assert float((img_p - img_r).abs().max()) <= 1e-5 * float(img_r.abs().max())
        for k in ("color", "moments", "history"):
            assert torch.allclose(getattr(new_p, k), new_r[k], rtol=1e-5, atol=1e-6)
        state = new_p
    tm = tonemap.tonemap(img_p, tonemap.TonemapMode.ACES)
    assert float((tm - svgf.aces(img_p)).abs().max()) < 1e-6


@pytest.mark.parametrize("cell", ["atrium-path", "atrium-frame", "atrium-lanes4"])
def test_the_control_is_not_correct(cell):
    r = harness.run(cell, 41, 0.1, False, device="cpu", overrides=_tiny.overrides(cell),
                    control=True)
    assert r["correct"], r["check"]
    assert any(not ok for *_, ok in r["control"]), r["control"]


def _alter_answers(monkeypatch):
    from stratum_tpu_torch.ops import block_trace

    real = block_trace.block_closest

    def altered(*a, **k):
        h = real(*a, **k)
        bump = (torch.arange(h.t.shape[0]) % 5 == 0) & (h.slot >= 0)
        return h._replace(t=torch.where(bump, h.t * 1.01, h.t))

    monkeypatch.setattr(block_trace, "block_closest", altered)


def _drop_half(monkeypatch):
    from stratum_tpu_torch.ops import block_trace

    real_c, real_o = block_trace.block_closest, block_trace.block_occluded

    def closest(fat, o, d, t_max=None, *a, **k):
        n = o.shape[0] // 2
        h = real_c(fat, o[:n], d[:n], None if t_max is None else t_max[:n], *a, **k)
        miss = torch.full((o.shape[0] - n,), -1, dtype=h.slot.dtype)
        return block_trace._slot_record(torch.cat([h.t, torch.full_like(miss, 0).float()
                                                   + intersect.T_MAX]),
                                        torch.cat([h.slot, miss]))

    def occluded(fat, o, d, t_max, *a, **k):
        n = o.shape[0] // 2
        b = real_o(fat, o[:n], d[:n], t_max[:n], *a, **k)
        return torch.cat([b, torch.zeros(o.shape[0] - n, dtype=torch.bool)])

    monkeypatch.setattr(block_trace, "block_closest", closest)
    monkeypatch.setattr(block_trace, "block_occluded", occluded)


def _state_unchanged(monkeypatch):
    from stratum_tpu_torch.render import denoise, integrator

    real = integrator.render_path_with_counts
    first = {}

    def stale(*a, **k):  # every sample after the first returns the first one
        if "out" not in first:
            first["out"] = real(*a, **k)
        return first["out"]

    monkeypatch.setattr(integrator, "render_path_with_counts", stale)
    monkeypatch.setattr(denoise, "denoise", lambda state, radiance, gbuf, cfg=None:
                        (state, radiance))


def _image_half_zero(monkeypatch):
    from stratum_tpu_torch.render import integrator

    real = integrator.trace_path

    def half(*a, **k):  # the lower half of the lanes' radiance written as zeros
        rad, n_rays = real(*a, **k)
        rad = rad.clone()
        rad[rad.shape[0] // 2:] = 0.0
        return rad, n_rays

    monkeypatch.setattr(integrator, "trace_path", half)


def _weight_altered(monkeypatch):
    from stratum_tpu_torch.render import integrator

    real = integrator.mis_power_heuristic
    monkeypatch.setattr(integrator, "mis_power_heuristic", lambda a, b: real(a, b) * 0.9)


@pytest.mark.parametrize("fault", [_alter_answers, _drop_half, _state_unchanged,
                                   _image_half_zero, _weight_altered],
                         ids=["answer_altered", "half_left_out", "state_unchanged",
                              "image_half_zero", "weight_altered"])
@pytest.mark.parametrize("cell", ["atrium-path", "atrium-frame"])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = harness.run(cell, 43, 0.1, False, device="cpu", overrides=_tiny.overrides(cell))
    assert not r["correct"], r["check"]
