"""The program's own spans and counters in a traced stretch, and the
arithmetic the per-layer readers take from them.

While torch's profiler traces the stretch, the port's recorder
(``stratum_tpu_torch.utils.profiler``) keeps a span at each layer boundary
it passes: host begin and end, and a timing event at each end on the
device. Those event times are relative to the recording's first event;
:func:`clock` places them on the profiler's clock by the trace kernels the
program launches itself. One stream runs the work, so the end event of the
i-th ``launch`` span completes where that launch's last
``block_trace_kernel*`` interval of the stretch ends (a culled-mode launch
enqueues one kernel a chunk; the span counts them as ``kernels``). The
events' clock and the trace's run a few parts per million apart, so the
launches fix an offset and a rate, and every launch checks the fit.

A program without the recorder (an older tree) gives no spans, and every
reader returns None.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

KERNEL = "block_trace_kernel"
TOLERANCE_US = 20.0  # largest gap between a launch's end event and its kernel's end
SHADE = ("camera", "bounce", "shade")  # the integrator's own work
TRACER = ("closest", "shadow", "sort", "prep", "launch", "finalize")  # waves and below


def program_records():
    """The recorder's last recording as a list of records, or None where
    the program has no such recorder."""
    from stratum_tpu_torch.utils import profiler

    read = getattr(profiler, "records", None)
    if read is None or not hasattr(profiler, "Record"):
        return None
    return read()


class Clock(NamedTuple):
    """Device event time t (us after the recording's first event) lands at
    ``offset + rate * t`` on the trace's clock."""

    offset: float
    rate: float
    residual: float  # largest |placed end event - kernel end| over the launches, us

    def at(self, t: float) -> float:
        return self.offset + self.rate * t


def clock(records, intervals, tolerance_us: float = TOLERANCE_US):
    """The :class:`Clock` that places the records' device times on the
    trace's clock: the least-squares line from the launches' end events to
    their last kernels' ends (the two clocks run a few parts per million
    apart). None where there is no launch, a launch has no events, the
    kernel counts differ from the trace's, or a launch's end lands more than
    ``tolerance_us`` from its kernel's."""
    launches = [r for r in records if r.name == "launch" and r.attrs.get("kernels", 1) > 0]
    kernels = sorted((iv for iv in intervals if KERNEL in iv.name), key=lambda iv: iv.start)
    if not launches or any(r.device_us is None for r in launches):
        return None
    if sum(r.attrs.get("kernels", 1) for r in launches) != len(kernels):
        return None
    xs, ys, i = [], [], 0
    for r in launches:
        i += r.attrs.get("kernels", 1)
        xs.append(r.device_us[1])
        ys.append(kernels[i - 1].end)
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    sxx = sum((x - mx) ** 2 for x in xs)
    rate = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx if sxx > 0 else 1.0
    offset = my - rate * mx
    residual = max(abs(offset + rate * x - y) for x, y in zip(xs, ys))
    if residual > tolerance_us:
        return None
    return Clock(offset, rate, residual)


def _levels(records) -> list:
    out = []
    for r in records:
        out.append(0 if r.parent < 0 else out[r.parent] + 1)
    return out


def idle_by_span(records, intervals, clk: Clock) -> dict:
    """Device idle time (us) by the name of the innermost program span
    open there: each gap between the stretch's device intervals is cut at
    the span events inside it, and each piece goes to the deepest span
    whose device extent holds it ("" where none does)."""
    bounds = []  # (time, opens, level, name), swept in time order
    for r, lvl in zip(records, _levels(records)):
        if r.device_us is not None:
            bounds.append((clk.at(r.device_us[0]), True, lvl, r.name))
            bounds.append((clk.at(r.device_us[1]), False, lvl, r.name))
    bounds.sort(key=lambda b: b[0])
    open_: dict = {}  # (level, name) -> spans open
    k = 0

    def advance(t):
        nonlocal k
        while k < len(bounds) and bounds[k][0] <= t:
            _, opens, lvl, name = bounds[k]
            key = (lvl, name)
            open_[key] = open_.get(key, 0) + (1 if opens else -1)
            if not open_[key]:
                del open_[key]
            k += 1

    out: dict = {}
    busy_end = None
    for iv in sorted(intervals, key=lambda iv: iv.start):
        if busy_end is not None and iv.start > busy_end:
            p = busy_end
            advance(p)
            while p < iv.start:
                q = min(iv.start, bounds[k][0]) if k < len(bounds) else iv.start
                if q > p:
                    name = max(open_)[1] if open_ else ""
                    out[name] = out.get(name, 0.0) + (q - p)
                advance(q)
                p = q
        if busy_end is None or iv.end > busy_end:
            busy_end = iv.end
    return out


def device_time_in(records, intervals, clk: Clock, name: str) -> float | None:
    """Summed device time (us) of the intervals that lie inside the device
    extent of a span named ``name``; None where there is no such span."""
    extents = sorted((clk.at(r.device_us[0]), clk.at(r.device_us[1]))
                     for r in records if r.name == name and r.device_us is not None)
    if not extents:
        return None
    starts = [s for s, _ in extents]
    total = 0.0
    for iv in intervals:  # the spans of one name do not overlap
        i = bisect.bisect_right(starts, iv.start) - 1
        if i >= 0 and iv.end <= extents[i][1]:
            total += iv.end - iv.start
    return total


def host_ms(records, names) -> float | None:
    """Summed host time (ms) of the spans named in ``names``; None where
    there is none."""
    sel = [r for r in records if r.name in names]
    if not sel:
        return None
    return sum(r.host_ns[1] - r.host_ns[0] for r in sel) / 1e6


def host_ms_per_unit(r, names) -> float | None:
    """Host ms per unit of a traced run's stretch inside the program's
    spans named in ``names``; None without a stretch or such spans. These
    are read while the profiler traces the stretch, and its cost per
    launch slows the host there."""
    st = r.stretch
    recs = program_records() if st is not None else None
    ms = host_ms(recs, names) if recs else None
    return None if ms is None else ms / st.units


def live_pct(records) -> float | None:
    """100 x live lanes / lanes over the closest waves."""
    waves = [r for r in records if r.name == "closest" and "live" in r.attrs]
    lanes = sum(r.attrs["lanes"] for r in waves)
    if not lanes:
        return None
    return 100.0 * sum(r.attrs["live"] for r in waves) / lanes


def placed(r):
    """(records, intervals, clock) of a traced run's stretch whose spans
    the launches place on the trace's clock, else None."""
    st = r.stretch
    if st is None:
        return None
    recs = program_records()
    if not recs:
        return None
    clk = clock(recs, st.intervals)
    if clk is None:
        return None
    return recs, st.intervals, clk
