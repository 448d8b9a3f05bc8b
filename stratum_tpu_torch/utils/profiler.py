"""Hierarchical profiler: a nested wall-time sample tree and a device trace
(counterpart of stratum_tpu/utils/profiler.py; the reference's
src/Core/Profiler.{hpp,cpp}: a static CPU sample tree of RAII regions,
Profiler.hpp:23-36, and GPU timestamps per pass drawn as a timeline,
Profiler.cpp:36-130). A region passed ``sync=`` (a CUDA tensor or device)
synchronises that device before it stops its clock, so its time includes
the queued GPU work; ``device_trace`` records a ``torch.profiler`` trace
and writes it as a Chrome trace (Perfetto, chrome://tracing).
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import torch


@dataclass
class Sample:
    label: str
    start: float = 0.0
    duration: float = 0.0
    children: list = field(default_factory=list)


def _synchronize(sync):
    """Wait for the queued work of ``sync``'s CUDA device (a tensor or a
    device); nothing to wait for on the CPU."""
    dev = sync.device if torch.is_tensor(sync) else torch.device(sync)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Profiler:
    """Singleton-style profiler (the reference's is fully static)."""

    def __init__(self, history: int = 256):
        self._root: Optional[Sample] = None
        self._stack: list[Sample] = []
        self.frame_times = deque(maxlen=history)  # FPS plot ring buffer
        self._frame_start: Optional[float] = None
        self.enabled = True

    # -- frame lifecycle (reference: begin_frame, Application.cpp:19) ------
    def begin_frame(self):
        now = time.perf_counter()
        if self._frame_start is not None:
            self.frame_times.append(now - self._frame_start)
        self._frame_start = now
        self._root = Sample("frame", start=now)
        self._stack = [self._root]

    # -- regions (reference: ProfilerRegion RAII, CommandBuffer.hpp:315) ---
    @contextlib.contextmanager
    def region(self, label: str, sync=None):
        """Time a region. ``sync`` (a tensor or a device) includes that
        device's completion, the analog of the reference's GPU
        timestamps."""
        if not self.enabled:
            yield
            return
        if self._root is None:
            self.begin_frame()
        s = Sample(label, start=time.perf_counter())
        self._stack[-1].children.append(s)
        self._stack.append(s)
        try:
            yield s
        finally:
            if sync is not None:
                _synchronize(sync)
            s.duration = time.perf_counter() - s.start
            self._stack.pop()

    def end_frame(self):
        if self._root is not None and self._frame_start is not None:
            self._root.duration = time.perf_counter() - self._frame_start

    # -- reporting (replaces the ImGui timeline, Profiler.cpp:36-130) ------
    def report(self) -> str:
        lines = []
        if self.frame_times:
            ft = sum(self.frame_times) / len(self.frame_times)
            lines.append(
                f"frames: {len(self.frame_times)}  mean {ft * 1000:.1f} ms "
                f"({1.0 / max(ft, 1e-9):.1f} fps)"
            )

        def walk(s: Sample, depth: int):
            lines.append(
                f"{'  ' * depth}{s.label:<24s} {s.duration * 1000:9.2f} ms"
            )
            for c in s.children:
                walk(c, depth + 1)

        if self._root is not None:
            walk(self._root, 0)
        return "\n".join(lines)

    @contextlib.contextmanager
    def device_trace(self, logdir: str):
        """Record a ``torch.profiler`` trace of the CPU and, where there is
        one, the CUDA device, and write it to ``logdir/trace.json`` (a
        Chrome trace) when the block ends."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        out = Path(logdir)
        out.mkdir(parents=True, exist_ok=True)
        with profile(activities=activities) as prof:
            yield prof
        prof.export_chrome_trace(str(out / "trace.json"))


PROFILER = Profiler()


def region(label: str, sync=None):
    return PROFILER.region(label, sync)
