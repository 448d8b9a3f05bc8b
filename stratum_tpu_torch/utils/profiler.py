"""The port's span and counter recorder (counterpart of
stratum_tpu/utils/profiler.py; the reference's src/Core/Profiler.{hpp,cpp}:
a CPU sample tree of RAII regions, Profiler.hpp:23-36, and GPU timestamps
per pass, Profiler.cpp:36-130).

A span marks a layer boundary of the program: a ``trace_path`` call, a
bounce, a wave through the tracer, a kernel launch, a denoiser iteration.
It holds its name, its parent span, the id of the top-level call it belongs
to (every span of one ``trace_path`` or one ``RenderSession.frame`` shares
it), a few attributes and counters, and its host begin and end
(``time.perf_counter_ns``). On a CUDA device each span also records a
timing event where it begins and where it ends. One stream runs the work,
so an event completes where the device stood in the work when the host
reached that point, which places the span on the device's timeline.

It records only while torch's profiler runs
(``torch.autograd.profiler._is_profiler_enabled``) or between
:func:`start` and :func:`stop`. Off, a span costs two flag reads and a
branch: :func:`begin` returns None and :func:`end` returns at once, with
no object, no event, no device op and no synchronise. A recording
keeps at most ``MAX_SPANS`` spans in memory; the next recording clears
them. Counters are host integers, or device scalars (live lanes) that stay
on the device until :func:`records` reads them after the recording.

Usage: ``s = begin("bounce", depth=d)`` ... ``end(s)``; entry points open
their span with :func:`enter`, which also marks, while off, that the next
span recorded starts a new recording. An operator's code may wrap a block
in ``with region("label"):`` and bracket frames with
:meth:`Profiler.begin_frame` / :meth:`Profiler.end_frame`, whose
:meth:`Profiler.report` gives the frame rate and the last frame's tree as
the JAX package's profiler does.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _torch_profiler

MAX_SPANS = 200_000  # spans a recording keeps; later ones are counted in `dropped`


_on = False  # between start() and stop()


def recording() -> bool:
    """Whether spans are recorded now."""
    return _on or _torch_profiler._is_profiler_enabled


def _device_events() -> bool:
    """Whether a new recording's spans record CUDA events: where CUDA is
    up."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


class Span:
    __slots__ = ("name", "parent", "call", "attrs", "t0", "t1", "ev0", "ev1")


class Record(NamedTuple):
    """A finished span as plain data."""

    name: str
    parent: int  # index of the parent record, -1 for a top-level call
    call: int  # id of the top-level call
    attrs: dict  # attributes and counters, device scalars read as ints
    host_ns: tuple  # (begin, end), time.perf_counter_ns
    device_us: Optional[tuple]  # (begin, end) in us after the recording's first event


class Profiler:
    """The spans of the current or last recording."""

    def __init__(self):
        self.spans: list = []
        self.dropped = 0
        self._stack: list = []
        self._calls = 0
        self._fresh = True  # the next span recorded starts a new recording
        self._events = False
        self._records = None

    def _new_recording(self):
        self.spans, self._stack, self._records = [], [], None
        self.dropped = self._calls = 0
        self._fresh = False
        self._events = _device_events()

    def open(self, name: str, attrs: dict) -> Optional[Span]:
        if self._fresh:
            self._new_recording()
        if len(self.spans) >= MAX_SPANS:
            self.dropped += 1
            return None
        s = Span()
        s.name, s.attrs, s.t1, s.ev1 = name, attrs, None, None
        s.parent = self._stack[-1] if self._stack else None
        if s.parent is None:
            self._calls += 1
            s.call = self._calls
        else:
            s.call = s.parent.call
        s.t0 = time.perf_counter_ns()
        s.ev0 = None
        if self._events:
            s.ev0 = torch.cuda.Event(enable_timing=True)
            s.ev0.record()
        self.spans.append(s)
        self._stack.append(s)
        self._records = None
        return s

    def close(self, s: Span):
        if self._events:
            s.ev1 = torch.cuda.Event(enable_timing=True)
            s.ev1.record()
        s.t1 = time.perf_counter_ns()
        while self._stack:  # children an exception left open close with it
            if self._stack.pop() is s:
                break

    # -- frames and regions (the JAX package's Profiler.begin_frame / region)
    def begin_frame(self):
        """Close the frame left open and open a new top-level ``frame``
        span, while recording."""
        if self._stack:
            self.close(self._stack[0])
        if recording():
            self.open("frame", {})

    def end_frame(self):
        if self._stack:
            self.close(self._stack[0])

    @contextlib.contextmanager
    def region(self, label: str):
        """A span named ``label`` around the block, while recording."""
        s = self.open(label, {}) if recording() else None
        try:
            yield s
        finally:
            if s is not None:
                self.close(s)

    def records(self) -> list:
        """The recording's finished spans as :class:`Record`s, in the order
        they began; reads the device's counters and events (waiting for the
        device), so call it after the recording."""
        if self._records is not None:
            return self._records
        done = [s for s in self.spans if s.t1 is not None]
        index = {id(s): i for i, s in enumerate(done)}
        base = next((s.ev0 for s in done if s.ev0 is not None), None)
        if base is not None:
            torch.cuda.synchronize()
        out = []
        for s in done:
            attrs = {k: int(v) if torch.is_tensor(v) else v for k, v in s.attrs.items()}
            dev = None
            if base is not None and s.ev0 is not None and s.ev1 is not None:
                dev = (base.elapsed_time(s.ev0) * 1e3, base.elapsed_time(s.ev1) * 1e3)
            parent = -1 if s.parent is None else index.get(id(s.parent), -1)
            out.append(Record(s.name, parent, s.call, attrs, (s.t0, s.t1), dev))
        self._records = out
        return out

    def report(self) -> str:
        """The frame rate over the top-level calls (from one's begin to the
        next's) and the last call's span tree in host ms: the JAX package's
        report."""
        recs = self.records()
        tops = [r for r in recs if r.parent < 0]
        if not tops:
            return ""
        lines = []
        if len(tops) > 1:
            ft = (tops[-1].host_ns[0] - tops[0].host_ns[0]) / (len(tops) - 1) / 1e9
            lines.append(f"frames: {len(tops) - 1}  mean {ft * 1000:.1f} ms "
                         f"({1.0 / max(ft, 1e-9):.1f} fps)")
        last = tops[-1].call
        level: dict = {}
        for i, r in enumerate(recs):
            if r.call != last:
                continue
            level[i] = 0 if r.parent < 0 else level[r.parent] + 1
            lines.append(f"{'  ' * level[i]}{r.name:<24s} "
                         f"{(r.host_ns[1] - r.host_ns[0]) / 1e6:9.2f} ms")
        return "\n".join(lines)


PROFILER = Profiler()


def begin(name: str, depth=None, it=None, lanes=None, live=None) -> Optional[Span]:
    """Open a span while recording (else None). ``depth`` a bounce,
    ``it`` an a-trous iteration, ``lanes`` a wave's lanes (host int),
    ``live`` its live lanes (a device scalar)."""
    if not (_on or _torch_profiler._is_profiler_enabled):
        return None
    attrs = {}
    for key, value in (("depth", depth), ("it", it), ("lanes", lanes), ("live", live)):
        if value is not None:
            attrs[key] = value
    return PROFILER.open(name, attrs)


def enter(name: str) -> Optional[Span]:
    """:func:`begin` for an entry point, which may be a top-level call."""
    if not (_on or _torch_profiler._is_profiler_enabled):
        PROFILER._fresh = True
        return None
    return PROFILER.open(name, {})


def end(span: Optional[Span]):
    if span is not None:
        PROFILER.close(span)


def count(span: Optional[Span], key: str, value):
    """A counter (a host int or a device scalar) or an attribute at a
    span's boundary."""
    if span is not None:
        span.attrs[key] = value


def start():
    """Record from now until :func:`stop`, whether or not torch's profiler
    runs; clears the last recording."""
    global _on
    PROFILER._new_recording()
    _on = True


def stop():
    global _on
    _on = False
    PROFILER._fresh = True


def region(label: str):
    """``with region(label):`` a span around the block, while recording."""
    return PROFILER.region(label)


def records() -> list:
    return PROFILER.records()


def report() -> str:
    return PROFILER.report()
