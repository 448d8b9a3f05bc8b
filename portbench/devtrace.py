"""The device's side of a traced run: a ``torch.profiler`` trace of the
device alone (CUDA activity only, so the host pays no per-op record) over
a stretch of the window, cut into intervals, and the arithmetic the
per-layer readers take from it.

Spans: in a traced run the harness records a timing CUDA event where each
of its spans around a call into the program begins and ends. Everything
runs on one stream, so an event's time is where the device stood in the
work when the host reached that point. Event times are read against an
anchor event recorded right after the stretch's one marker kernel
(``torch.cuda._sleep(0)``, the trace's only ``spin_kernel``), whose end
places them on the profiler's clock. Interval times are microseconds on
the profiler's clock.
"""

from __future__ import annotations

import re
from typing import NamedTuple

MARKER = "spin_kernel"


class Interval(NamedTuple):
    name: str
    start: float  # us
    end: float  # us


class Stretch(NamedTuple):
    """A traced stretch of the window."""

    intervals: list  # [Interval] of device work, markers left out, by start
    spans: list  # [(label, start_us, end_us)] on the device's timeline
    window_s: float  # host seconds of the stretch, from a synchronise to one
    units: int  # samples per pixel (path) or frames (interactive) in it


def label(name: str) -> str:
    """A kernel's name cut to its functor or function
    (``...BinaryFunctor<..., MulFunctor<float>>...`` -> ``MulFunctor``)."""
    functors = re.findall(r"(\w+Functor)\b", name)
    if functors:
        return functors[-1]
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return re.split(r"[<(]", name)[0].strip()[:80] or name[:80]


def union_us(intervals) -> float:
    """Length of the union of the intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for iv in sorted(intervals, key=lambda x: x.start):
        if cur_e is None or iv.start > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = iv.start, iv.end
        else:
            cur_e = max(cur_e, iv.end)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_s(st: Stretch) -> float:
    return union_us(st.intervals) / 1e6


def idle_pct(st: Stretch) -> float | None:
    """100 x (1 - busy / window) over the stretch."""
    if not st.intervals or st.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s(st) / st.window_s)


def time_by(st: Stretch, pred) -> float:
    """Summed device time (ms) of the intervals whose name passes ``pred``."""
    return sum(iv.end - iv.start for iv in st.intervals if pred(iv.name)) / 1e3


def time_in_spans(st: Stretch, span_label: str) -> float | None:
    """Summed device time (ms) of the intervals inside spans of one label;
    None where the stretch has no such span."""
    spans = [(s, e) for lab, s, e in st.spans if lab == span_label]
    if not spans:
        return None
    total = 0.0
    for iv in st.intervals:
        for s, e in spans:
            if iv.start >= s and iv.end <= e:
                total += iv.end - iv.start
                break
    return total / 1e3


def span_at(st: Stretch, t: float) -> str:
    for lab, s, e in st.spans:
        if s <= t <= e:
            return lab
    return "between calls"


def top_ops(st: Stretch, n: int = 10) -> list:
    """[[kernel label, seconds]] of the labels with the most device time."""
    acc: dict = {}
    for iv in st.intervals:
        k = label(iv.name)
        acc[k] = acc.get(k, 0.0) + (iv.end - iv.start) / 1e6
    return [[k, v] for k, v in sorted(acc.items(), key=lambda x: -x[1])[:n]]


def idle_gaps(st: Stretch, n: int = 10) -> list:
    """[[what the host was in, seconds]] of the longest gaps between device
    intervals, named by the span around the gap's middle and the kernel
    before it."""
    gaps = []
    ivs = sorted(st.intervals, key=lambda x: x.start)
    end = None
    prev = None
    for iv in ivs:
        if end is not None and iv.start > end:
            mid = (iv.start + end) / 2
            gaps.append((iv.start - end, f"{span_at(st, mid)}: after {label(prev.name)}"))
        if end is None or iv.end > end:
            end, prev = iv.end, iv
    gaps.sort(key=lambda g: -g[0])
    return [[name, g / 1e6] for g, name in gaps[:n]]


def spans_from_events(anchor_us: float, marks: list) -> list:
    """The anchor marker's end on the profiler's clock and the host's
    [(label, "begin" | "end", us after the anchor event)] -> [(label,
    start, end)]: each "begin" paired with the next "end" of its label."""
    out, open_at = [], {}
    for lab, kind, t in marks:
        if kind == "begin":
            open_at[lab] = anchor_us + t
        elif lab in open_at:
            out.append((lab, open_at.pop(lab), anchor_us + t))
    return out


class Tracer:
    """The profiler over one stretch and the events of the spans in it."""

    def __init__(self):
        self.on = False
        self.marks: list = []  # [(label, kind, event)]
        self._prof = None
        self._anchor = None

    def mark(self, lab: str, kind: str):
        if self.on:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((lab, kind, ev))

    def start(self):
        """Start tracing the device; returns once the marker kernel,
        launched after the start, and the anchor event after it have run."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda._sleep(0)
        self._anchor = torch.cuda.Event(enable_timing=True)
        self._anchor.record()
        torch.cuda.synchronize()
        self.on = True

    def stop(self, window_s: float, units: int) -> Stretch:
        """The stretch, once the device has run all of it (the caller
        synchronises). Without its anchor marker in the trace the stretch
        has no spans."""
        from torch.autograd import DeviceType

        self.on = False
        self._prof.stop()
        ivs = []
        for e in self._prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            ivs.append(Interval(e.name, float(e.time_range.start), float(e.time_range.end)))
        ivs.sort(key=lambda x: x.start)
        markers = [iv for iv in ivs if MARKER in iv.name]
        work = [iv for iv in ivs if MARKER not in iv.name]
        spans = []
        if markers:
            marks = [(lab, kind, self._anchor.elapsed_time(ev) * 1e3)
                     for lab, kind, ev in self.marks]
            spans = spans_from_events(markers[0].end, marks)
        self._prof, self._anchor, self.marks = None, None, []
        return Stretch(intervals=work, spans=spans, window_s=window_s, units=units)
