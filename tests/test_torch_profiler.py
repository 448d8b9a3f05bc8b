"""The port's span recorder inside the render path
(stratum_tpu_torch/utils/profiler.py) and the benchmark's readers of its
spans (portbench/progspans.py, portbench/metrics/).

Under torch's profiler a tiny denoised frame records the span tree at the
layer boundaries, with shared call ids and the waves' lane counters; with
stand-in CUDA events, their device extents nest as the host spans do. Off,
the session's next frame records nothing and creates no event. The block
tracer's ``launch`` span carries its list mode and CTAs in every mode and
the list phase's device counters in the culled and global modes only; off,
no counter buffer is made. The readers' arithmetic runs on a made-up
stretch whose numbers are worked out by hand in the comments.
"""

from types import SimpleNamespace

import pytest
import torch

from portbench import devtrace, harness, progspans
from portbench.tests import _tiny
from stratum_tpu_torch.ops import block_trace
from stratum_tpu_torch.render import camera, integrator, session, tonemap
from stratum_tpu_torch.scene import builtin, flatten
from stratum_tpu_torch.utils import cuda_build
from stratum_tpu_torch.utils import profiler as pprofiler

METRICS = ("host_issue_ms.path", "host_issue_ms.lanes", "host_issue_ms.frame",
           "idle_shade_ms.path", "idle_tracer_ms.path", "atrous_ms.frame",
           "live_lanes_pct.path", "list_overflow_pct.path", "reached_keys.path")


@pytest.fixture(scope="module")
def tiny():
    """The tiny atrium of the benchmark's CPU runs, its view and the
    cells' render settings, on the block tracer's plain version."""
    o = _tiny.overrides("atrium")
    g = builtin.atrium(**o["scene_params"])
    scene, _ = flatten.flatten(g.root, device="cpu")
    node, cam = flatten.find_camera(g.root)
    w, h = o["width"], o["height"]
    view = camera.make_view(node.to_world(), cam.fovy, w, h, device="cpu")
    return scene, view, integrator.RenderConfig(width=w, height=h, **o["render"])


class _Event:
    """A stand-in CUDA event: each record() one microsecond later."""

    now = 0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        _Event.now += 1
        self.t = _Event.now

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e-3


@pytest.fixture(scope="module")
def frames(tiny):
    """A tiny session's first denoised frame and its tonemap under torch's
    profiler (``torch.autograd.profiler.profile``, which
    ``torch.profiler.profile`` runs and which sets the flag the recorder
    reads), with stand-in CUDA events, then its next frame with the
    recorder off -> (spans opened and events made by the second, the
    first's records)."""
    scene, view, cfg = tiny
    sess = session.RenderSession(scene, view, cfg, denoise=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pprofiler, "_device_events", lambda: True)
        mp.setattr(torch.cuda, "Event", _Event)
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        with torch.autograd.profiler.profile():
            out = sess.frame()
            tonemap.tonemap(out, tonemap.TonemapMode.ACES)
        recs = pprofiler.records()
    opened, made = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pprofiler.PROFILER, "open", lambda *a: opened.append(a))
        mp.setattr(torch.cuda, "Event", lambda *a, **k: made.append(1))
        tonemap.tonemap(sess.frame())
        off = (len(opened), len(made))
    return off, recs


def test_recorder_off_records_nothing(frames):
    """With torch's profiler off a frame and its tonemap open no span and
    create no event."""
    assert frames[0] == (0, 0)


def test_span_tree_under_torch_profiler(tiny, frames):
    """A denoised frame and its tonemap under torch's profiler: the frame
    holds the sample (camera, 5 bounces each with its closest wave and its
    shading, one deferred shadow wave), the G-buffer and the denoiser
    (temporal, variance, 5 a-trous iterations); the tonemap is a call of
    its own. Every span of a call shares its id; with stand-in events each
    span's device extent lies inside its parent's."""
    _, _, cfg = tiny
    recs = frames[1]
    tops = [i for i, r in enumerate(recs) if r.parent < 0]
    assert [recs[i].name for i in tops] == ["frame", "tonemap"]
    frame, tm = recs[tops[0]].call, recs[tops[1]].call
    assert frame != tm and all(r.call == (tm if r.name == "tonemap" else frame) for r in recs)

    def children(i):
        return [(j, r) for j, r in enumerate(recs) if r.parent == i]

    top = {r.name: j for j, r in children(tops[0])}
    assert set(top) == {"trace_path", "gbuffer", "denoise"}
    path = [r.name for _, r in children(top["trace_path"])]
    assert path == ["camera"] + ["bounce"] * 5 + ["shadow"]
    bounces = [(j, r) for j, r in children(top["trace_path"]) if r.name == "bounce"]
    assert [r.attrs["depth"] for _, r in bounces] == [0, 1, 2, 3, 4]
    lanes = cfg.width * cfg.height
    for j, r in bounces:
        kids = children(j)
        assert [k.name for _, k in kids] == ["closest", "shade"]
        wave = kids[0][1]
        assert wave.attrs["lanes"] == lanes and 0 <= wave.attrs["live"] <= lanes
        below = [k.name for _, k in children(kids[0][0])]
        assert below == (["finalize"] if r.attrs["depth"] == 0 else ["sort", "finalize"])
    assert children(bounces[0][0])[0][1].attrs["live"] == lanes  # every primary lane
    shadow = [r for _, r in children(top["trace_path"]) if r.name == "shadow"][0]
    assert shadow.attrs == {}
    den = children(top["denoise"])
    assert [r.name for _, r in den] == ["temporal", "variance"] + ["atrous"] * 5
    assert [r.attrs["it"] for _, r in den[2:]] == [0, 1, 2, 3, 4]
    for r in recs:
        assert r.host_ns[0] <= r.host_ns[1] and r.device_us[0] < r.device_us[1]
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.host_ns[0] <= r.host_ns[0] and r.host_ns[1] <= p.host_ns[1]
            assert p.device_us[0] < r.device_us[0] and r.device_us[1] < p.device_us[1]


def test_atrous_spans_count_no_kernel_on_the_cpu(frames):
    """On CPU tensors the a-trous iterations take the plain loop: each of
    the five ``atrous`` spans carries its iteration and ``kernels == 0``
    (one a span on the card)."""
    spans = [r for r in frames[1] if r.name == "atrous"]
    assert [r.attrs["it"] for r in spans] == [0, 1, 2, 3, 4]
    assert [r.attrs["kernels"] for r in spans] == [0] * 5


# -- the readers on a made-up stretch -----------------------------------------
# device times of the events (us after the recording's first); the trace's
# clock runs OFFSET later
OFFSET = 1000.0
CLOCK = progspans.Clock(OFFSET, 1.0, 0.0)
TREE = [  # name, parent, call, attrs, host ms, device begin / end
    ("trace_path", -1, 1, {}, 6.0, 0, 100),
    ("camera", 0, 1, {}, 0.5, 0, 8),
    ("bounce", 0, 1, {"depth": 0}, 3.0, 10, 90),
    ("closest", 2, 1, {"lanes": 100, "live": 80}, 1.0, 20, 50),
    ("launch", 3, 1, {"kernels": 2, "mode": "culled", "ctas": 40, "overflow": 2,
                      "reached_keys": 3000}, 0.2, 22, 45),
    ("shade", 2, 1, {}, 2.0, 50, 90),
    ("shadow", 0, 1, {}, 1.0, 91, 98),
    ("launch", 6, 1, {"kernels": 1, "mode": "shared", "ctas": 10}, 0.2, 92, 97),
    ("frame", -1, 2, {}, 4.0, 100, 130),
    ("denoise", 8, 2, {}, 3.0, 100, 130),
    ("atrous", 9, 2, {"it": 0}, 1.0, 105, 115),
    ("atrous", 9, 2, {"it": 1}, 1.0, 115, 125),
    ("tonemap", -1, 3, {}, 1.0, 130, 135),
]
# on the trace's clock: the first launch's two chunk kernels end where its
# end event does, the second launch's one kernel too
INTERVALS = [("elementwise", 0, 5), ("block_trace_kernel<false, true>", 23, 35),
             ("block_trace_kernel<false, true>", 36, 45), ("elementwise", 60, 70),
             ("block_trace_kernel<true, false>", 93, 97), ("elementwise", 106, 114),
             ("elementwise", 116, 120), ("elementwise", 124, 126), ("elementwise", 131, 134)]
# idle, cut at the events and given to the innermost span (us): camera 3,
# trace_path 2 + 1 + 2, bounce 10, closest 2 + 5, launch 1 + 1 + 1, shade
# 10 + 20, shadow 1 + 1, denoise 5 + 4, atrous 1 + 1 + 1 + 4, tonemap 1
IDLE = {"camera": 3, "trace_path": 5, "bounce": 10, "closest": 7, "launch": 3, "shade": 30,
        "shadow": 2, "denoise": 9, "atrous": 7, "tonemap": 1}
UNITS = 2
WANT = {  # per unit: host ms; idle and device us / 1e3; live lanes 80 of 100
    "host_issue_ms.path": 6.0 / UNITS, "host_issue_ms.lanes": 6.0 / UNITS,
    "host_issue_ms.frame": (4.0 + 1.0) / UNITS,
    "idle_shade_ms.path": (3 + 10 + 30) / 1e3 / UNITS,
    "idle_tracer_ms.path": (7 + 3 + 2) / 1e3 / UNITS,
    "atrous_ms.frame": (8 + 4) / 1e3 / UNITS,  # the 124-126 kernel straddles an end
    "live_lanes_pct.path": 80.0,
    "list_overflow_pct.path": 100.0 * 2 / 40,  # the culled launch's 40 CTAs only
    "reached_keys.path": 3000 / 40,
}


def _records(tree=TREE):
    out, t = [], 0
    for name, parent, call, attrs, ms, b, e in tree:
        out.append(pprofiler.Record(name, parent, call, dict(attrs), (t, t + int(ms * 1e6)),
                                    (float(b), float(e))))
        t += 1
    return out


def _intervals():
    return [devtrace.Interval(name, s + OFFSET, e + OFFSET) for name, s, e in INTERVALS]


def _waves(late_us=0.0, drop=False):
    """Five launches over two seconds of events whose trace clock runs
    10 ppm fast and 1000 us later (a single anchor would miss the last by
    20 us); the third ``late_us`` late, or its kernel missing."""
    ends = [100.0, 1e5, 5e5, 1e6, 2e6]
    recs = [pprofiler.Record("launch", -1, i + 1, {"kernels": 1}, (0, 1), (e - 50.0, e))
            for i, e in enumerate(ends)]
    ivs = [devtrace.Interval("block_trace_kernel<false, false>", t - 40.0, t)
           for i, e in enumerate(ends) if not (drop and i == 2)
           for t in [OFFSET + (1 + 1e-5) * e + (late_us if i == 2 else 0.0)]]
    return recs, ivs


@pytest.mark.parametrize("late_us, drop, placed", [(0.0, False, True), (5.0, False, True),
                                                   (60.0, False, False), (0.0, True, False)])
def test_clock_fits_the_launches(late_us, drop, placed):
    """The launches' end events fix the trace clock's offset and rate;
    every launch must land within 20 us of its kernel's end, and a launch
    whose kernel the trace lacks gives no clock."""
    clk = progspans.clock(*_waves(late_us, drop))
    assert (clk is not None) == placed
    if placed:
        assert clk.residual <= late_us + 1e-6 and clk.residual < progspans.TOLERANCE_US
        assert clk.at(2e6) == pytest.approx(OFFSET + (1 + 1e-5) * 2e6, abs=late_us + 1e-6)
    if late_us == 0.0 and not drop:
        assert clk.rate == pytest.approx(1 + 1e-5, abs=1e-12)
        assert clk.offset == pytest.approx(OFFSET, abs=1e-6)


def test_idle_is_cut_at_events_and_given_to_the_innermost_span():
    clk = progspans.clock(_records(), _intervals())
    assert clk == (pytest.approx(OFFSET), pytest.approx(1.0), pytest.approx(0.0, abs=1e-6))
    idle = progspans.idle_by_span(_records(), _intervals(), clk)
    assert idle == pytest.approx(IDLE)
    lone = [("elementwise", 0, 5), ("elementwise", 140, 150)]  # a gap past every span
    ivs = [devtrace.Interval(n, s + OFFSET, e + OFFSET) for n, s, e in lone]
    assert progspans.idle_by_span(_records(), ivs, CLOCK)[""] == pytest.approx(5.0)


def test_device_time_host_time_and_live_lanes():
    recs = _records()
    assert progspans.device_time_in(recs, _intervals(), CLOCK, "atrous") == pytest.approx(12)
    assert progspans.device_time_in(recs, _intervals(), CLOCK, "sort") is None
    assert progspans.host_ms(recs, ("frame", "tonemap")) == pytest.approx(5.0)
    assert progspans.live_pct(recs) == pytest.approx(80.0)


def _read(name, stretch):
    reader = harness.load_file_module(harness.HERE / "metrics" / f"{name}.py", name)
    return reader.read(SimpleNamespace(stretch=stretch))


@pytest.mark.parametrize("name", METRICS)
def test_reader_on_a_made_up_stretch(name, monkeypatch):
    monkeypatch.setattr(progspans, "program_records", _records)
    st = devtrace.Stretch(intervals=_intervals(), spans=[], window_s=1.0, units=UNITS)
    assert _read(name, st) == pytest.approx(WANT[name])
    assert _read(name, None) is None


@pytest.mark.parametrize("mode", ["shared", "culled", "global"])
def test_launch_span_carries_the_list_mode_and_counters(mode):
    """A recorded ``launch`` span keeps its list mode and CTAs; in the
    culled and global modes it also gets the zeroed buffer the kernel adds
    to, whose two words it reads as ``overflow`` and ``reached_keys``."""
    pprofiler.start()
    try:
        span = pprofiler.begin("launch")
        counts = block_trace._list_counts(span, mode, 7, "cpu")
        if counts is not None:
            assert counts.tolist() == [0, 0]
            counts += torch.tensor([2, 300])  # what the CTAs' atomics would add
        pprofiler.end(span)
    finally:
        pprofiler.stop()
    (rec,) = pprofiler.records()
    want = {"mode": mode, "ctas": 7}
    if mode != "shared":
        want.update(overflow=2, reached_keys=300)
    assert (counts is None) == (mode == "shared") and rec.attrs == want


@pytest.mark.parametrize("mode", ["shared", "culled", "global"])
def test_no_counter_buffer_with_the_recorder_off(mode, monkeypatch):
    """Off, ``begin`` gives no span, so no buffer is made and the kernel's
    pointer is null (None through ctypes)."""
    def refuse(*a, **k):
        raise AssertionError("a counter buffer was made with the recorder off")

    monkeypatch.setattr(torch, "zeros", refuse)
    span = pprofiler.begin("launch")
    assert span is None and block_trace._list_counts(span, mode, 7, "cpu") is None


@pytest.mark.parametrize("name", ["list_overflow_pct.path", "reached_keys.path"])
def test_list_readers_without_the_counters(name, monkeypatch):
    """A program whose launch spans carry no list counters (an older tree,
    or only shared-mode launches) gives no number."""
    plain = [(n, p, c, {"kernels": a["kernels"]} if n == "launch" else a, *rest)
             for n, p, c, a, *rest in TREE]
    monkeypatch.setattr(progspans, "program_records", lambda: _records(plain))
    st = devtrace.Stretch(intervals=_intervals(), spans=[], window_s=1.0, units=UNITS)
    assert _read(name, st) is None


@pytest.mark.parametrize("name", METRICS)
def test_reader_without_the_recorder(name, monkeypatch):
    """A program without the recorder (an older tree) gives no number and
    raises nothing."""
    monkeypatch.delattr(pprofiler, "records")
    st = devtrace.Stretch(intervals=_intervals(), spans=[], window_s=1.0, units=UNITS)
    assert _read(name, st) is None


def test_bsdf_spans_count_no_kernel_on_the_cpu(tiny, frames):
    """On CPU tensors the Disney BSDF takes its plain bodies: the frame's
    sample holds an eval (NEE) and a sample ``bsdf`` span in each bounce's
    ``shade``, each with the wave's lanes and ``kernels == 0`` (one a span
    on the card)."""
    _, _, cfg = tiny
    recs = frames[1]
    spans = [r for r in recs if r.name == "bsdf"]
    assert [r.attrs["op"] for r in spans] == ["eval", "sample"] * 5
    assert all(recs[r.parent].name == "shade" for r in spans)
    assert [(r.attrs["lanes"], r.attrs["kernels"]) for r in spans] == [
        (cfg.width * cfg.height, 0)] * 10


def test_disney_on_the_cpu_is_the_plain_body():
    """``disney_eval`` / ``disney_sample`` on CPU tensors, recording and
    not: the plain bodies' outputs bit for bit (NaN where they are NaN),
    no launch counted, one ``bsdf`` span a call while recording."""
    from stratum_tpu_torch.render import disney, shading

    gen = torch.Generator().manual_seed(3)
    n = 512
    row = torch.rand((n, 24), generator=gen)
    row[:, 13] = 1.0 + row[:, 13]  # eta in [1, 2)
    row[::5, 7] = 0.0  # roughness 0
    mat = shading.material_from_row(row)
    wo, wi = torch.randn((n, 3), generator=gen), torch.randn((n, 3), generator=gen)
    wo = wo / wo.norm(dim=-1, keepdim=True)
    wi = wi / wi.norm(dim=-1, keepdim=True)
    u = torch.rand((n, 3), generator=gen)
    want = (disney._disney_eval_plain(mat, wo, wi), disney._disney_sample_plain(mat, wo, u))
    before = cuda_build.launches()
    for on in (False, True):
        if on:
            pprofiler.start()
        try:
            got = (disney.disney_eval(mat, wo, wi), disney.disney_sample(mat, wo, u))
        finally:
            if on:
                pprofiler.stop()
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert torch.equal(torch.isnan(a), torch.isnan(b))
                assert torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))
    assert cuda_build.launches() == before
    spans = [r for r in pprofiler.records() if r.name == "bsdf"]
    assert [(r.attrs["op"], r.attrs["lanes"], r.attrs["kernels"]) for r in spans] == [
        ("eval", n, 0), ("sample", n, 0)]


def test_finalize_spans_count_no_kernel_on_the_cpu(tiny, frames):
    """On CPU tensors ``finalize_hit`` takes its plain body: each closest
    wave of the frame (the sample's five ``closest`` waves, then the
    G-buffer's) holds one ``finalize`` span with the wave's lanes and
    ``kernels == 0`` (one a span on the card)."""
    _, _, cfg = tiny
    recs = frames[1]
    spans = [r for r in recs if r.name == "finalize"]
    assert [recs[r.parent].name for r in spans] == ["closest"] * 5 + ["gbuffer"]
    assert [(r.attrs["lanes"], r.attrs["kernels"]) for r in spans] == [
        (cfg.width * cfg.height, 0)] * 6


def test_finalize_on_the_cpu_is_the_plain_body(tiny):
    """``finalize_hit`` on CPU tensors, recording and not: the plain body's
    tri, bary and payload bit for bit, t passed through, no launch counted,
    one ``finalize`` span a call while recording."""
    scene = tiny[0]
    gen = torch.Generator().manual_seed(5)
    n, rows = 300, scene.slot_payload.shape[0]
    o, d = torch.randn((n, 3), generator=gen), torch.randn((n, 3), generator=gen)
    slot = torch.randint(-1, rows, (n,), generator=gen, dtype=torch.int32)
    h = block_trace._slot_record(torch.rand((n,), generator=gen), slot)
    want = block_trace.finalize_hit_plain(scene.slot_payload, o, d, h)
    before = cuda_build.launches()
    for on in (False, True):
        if on:
            pprofiler.start()
        try:
            got = block_trace.finalize_hit(scene.slot_payload, o, d, h)
        finally:
            if on:
                pprofiler.stop()
        assert got.t is h.t and got.slot is None
        for k, w in zip(("tri", "bary", "payload"), want):
            assert torch.equal(getattr(got, k).view(torch.int32), w.view(torch.int32)), k
    assert cuda_build.launches() == before
    spans = [r for r in pprofiler.records() if r.name == "finalize"]
    assert [(r.attrs["lanes"], r.attrs["kernels"]) for r in spans] == [(n, 0)]
