"""The window and trace arithmetic on made-up readings: a stall inside the
window has to move every window metric."""

from types import SimpleNamespace

import pytest

from portbench import devtrace, harness

HERE = harness.HERE


def _reader(name):
    return harness.load_file_module(HERE / "metrics" / f"{name}.py", name)


def _window(call_s, units=1):
    return SimpleNamespace(wall_s=sum(call_s), calls=len(call_s), units=units, call_s=call_s,
                           setup_s=1.0, flatten_s=0.5, stretch=None)


def test_per_spp_and_frame_means_take_the_whole_window():
    r = _window([0.25] * 100)
    assert _reader("ms_per_spp").read(r) == pytest.approx(250.0)
    assert _reader("ms_per_spp").read(_window([1.0] * 10, units=4)) == pytest.approx(250.0)
    assert _reader("frame_ms").read(r) == pytest.approx(250.0)


def test_p90_is_the_nearest_rank():
    p90 = _reader("frame_ms_p90").p90
    assert p90(list(range(1, 101))) == 90
    assert p90(list(range(1, 11))) == 9
    assert p90([5.0]) == 5.0


@pytest.mark.parametrize("metric", ["ms_per_spp", "frame_ms", "frame_ms_p90"])
def test_a_stall_moves_the_window_metrics(metric):
    calm = [0.3] * 100
    stalled = list(calm)
    for i in range(0, 100, 9):  # 12 calls of 100 stall
        stalled[i] = 0.9
    rd = _reader(metric)
    assert rd.read(_window(stalled)) > rd.read(_window(calm)) * 1.05


def _iv(name, s, e):
    return devtrace.Interval(name, float(s), float(e))


def _stretch(ivs, window_s, units=2, spans=()):
    return devtrace.Stretch(intervals=ivs, spans=list(spans), window_s=window_s, units=units)


def test_idle_share_is_one_minus_the_union_over_the_window():
    ivs = [_iv("a", 0, 400_000), _iv("b", 300_000, 600_000), _iv("c", 800_000, 900_000)]
    st = _stretch(ivs, 1.0)
    assert devtrace.union_us(ivs) == pytest.approx(700_000)
    assert devtrace.busy_s(st) == pytest.approx(0.7)
    assert devtrace.idle_pct(st) == pytest.approx(30.0)
    # a stall of the host: the same work over a longer window
    assert devtrace.idle_pct(_stretch(ivs, 1.4)) == pytest.approx(50.0)
    assert devtrace.idle_pct(_stretch([], 1.0)) is None


def test_kernel_and_glue_split_per_unit():
    ivs = [_iv("void block_trace_kernel<false, 4>(...)", 0, 10_000),
           _iv("void at::native::vectorized_elementwise_kernel<MulFunctor<float>>", 10_000,
               50_000), _iv("Memcpy DtoD (Device -> Device)", 50_000, 52_000)]
    st = _stretch(ivs, 0.1, units=2)
    kern = _reader("trace_kernel_ms.path").read(SimpleNamespace(stretch=st))
    glue = _reader("glue_device_ms.path").read(SimpleNamespace(stretch=st))
    assert kern == pytest.approx(5.0) and glue == pytest.approx(21.0)
    none = SimpleNamespace(stretch=_stretch(ivs[1:], 0.1))
    assert _reader("trace_kernel_ms.path").read(none) is None


def test_spans_from_events_and_the_denoise_reader():
    marks = [("sample", "begin", 1.0), ("sample", "end", 400.0), ("gbuffer", "begin", 410.0),
             ("denoise", "begin", 501.0), ("denoise", "end", 800.0)]
    spans = devtrace.spans_from_events(100.0, marks)
    # a span whose end never came is left out; each begin pairs with its own end
    assert spans == [("sample", 101.0, 500.0), ("denoise", 601.0, 900.0)]
    ivs = [_iv("k1", 150, 450), _iv("atrous", 650, 850), _iv("atrous", 860, 880)]
    st = _stretch(ivs, 0.001, units=1, spans=spans)
    assert _reader("denoise_ms.frame").read(SimpleNamespace(stretch=st)) == pytest.approx(0.22)
    assert devtrace.span_at(st, 700) == "denoise" and devtrace.span_at(st, 550) == "between calls"
    gaps = devtrace.idle_gaps(st)
    assert gaps[0][0].startswith("between calls") and gaps[0][1] == pytest.approx(200e-6)
    assert devtrace.top_ops(st)[0] == ["k1", pytest.approx(300e-6)]


def test_kernel_labels():
    assert devtrace.label("void at::native::elementwise<BinaryFunctor<float, MulFunctor<float>>>") \
        == "MulFunctor"
    assert devtrace.label("void block_trace_kernel<true, 4>(float const*)") == "block_trace_kernel"
