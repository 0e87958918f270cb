"""Tracing, profiling and structured metrics (sdslam_tpu/utils/profiling.py).

The program's tracing is `span`: a host span at each layer boundary of the
frame path, always on, kept in one process-wide bounded ring that
`spans()` and `dropped()` read. A span records its name, its id, its
parent's id (0 for a root), its request id (the facade call's trajectory
index, shared by every span of that call; -1 outside any call), its host
start and end (`time.perf_counter_ns()`), a count `n` (frames, rows,
keyframes or results, by span) and `frame`, the trajectory index of the
first row a drain applies (-1 on other spans). Each thread nests its own
spans. While a `torch.profiler` runs on the thread, a span also opens
`torch.profiler.record_function(name)`, so it stands on the device trace's
clock; without one it costs two clock reads, a stack push and pop and one
append.

`device_trace(logdir)` wraps a `torch.profiler` trace with CPU and CUDA
activity that writes a Chrome trace into `logdir` (view it in
chrome://tracing or Perfetto); `None` makes it a no-op. `Timer` (the
reference's stopwatch, extra/timer.h), `StageTimes` and `FrameMetrics` are
the JAX module's public names, kept for the API and called by no program
code (on the card a host stopwatch times the enqueue, not the work).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch

log = logging.getLogger("sdslam_tpu_torch")

SPAN_CAPACITY = 65536


class Span(NamedTuple):
    """One recorded span (see the module docstring)."""

    name: str
    id: int
    parent: int
    req: int
    t0_ns: int
    t1_ns: int
    n: int
    frame: int


class SpanRecorder:
    """A bounded ring of finished spans; the oldest go first once it is
    full, and `dropped` counts them."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self._ring = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._added = 0

    def add(self, record: tuple):
        lock = self._lock
        lock.acquire()
        self._ring.append(record)
        self._added += 1
        lock.release()

    def spans(self) -> List[Span]:
        with self._lock:
            return [Span._make(r) for r in self._ring]

    def dropped(self) -> int:
        with self._lock:
            return self._added - len(self._ring)


_RECORDER = SpanRecorder()
_IDS = itertools.count(1)  # next() is atomic under the interpreter lock
_STACKS = threading.local()  # .open: this thread's open spans, innermost last
_profiler_enabled = torch._C._autograd._profiler_enabled
_clock = time.perf_counter_ns


def _open_spans() -> list:
    try:
        return _STACKS.open
    except AttributeError:
        _STACKS.open = []
        return _STACKS.open


class span:
    """Context manager recording span `name` under the thread's innermost
    open span, whose request id `req` defaults to. `.n` may be set inside
    the block where the count is known only there."""

    __slots__ = ("name", "req", "n", "frame", "id", "parent", "t0", "rf", "stack")

    def __init__(self, name: str, req: Optional[int] = None, n: int = 0, frame: int = -1):
        self.name, self.req, self.n, self.frame = name, req, n, frame

    def __enter__(self):
        self.stack = stack = _open_spans()
        if stack:
            up = stack[-1]
            self.parent = up.id
            if self.req is None:
                self.req = up.req
        else:
            self.parent = 0
            if self.req is None:
                self.req = -1
        self.id = next(_IDS)
        stack.append(self)
        self.rf = None
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.stack.pop()
        _RECORDER.add((self.name, self.id, self.parent, self.req, self.t0, t1, self.n,
                       self.frame))
        return False


def frame_span(req: int, n: int = 1):
    """The root span `sdslam.frame` of request `req` (a facade call, or a
    tracker's call made without the facade), or a no-op where a span is
    already open on this thread."""
    return contextlib.nullcontext() if _open_spans() else span("sdslam.frame", req, n)


def spans() -> List[Span]:
    """The finished spans the ring holds, oldest first."""
    return _RECORDER.spans()


def dropped() -> int:
    """Spans the ring has let go since the process started."""
    return _RECORDER.dropped()


class Timer:
    """extra/timer.h: a start/stop stopwatch in milliseconds."""

    def __init__(self, start: bool = False):
        self._t0 = time.perf_counter() if start else None
        self.elapsed_ms = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is not None:
            self.elapsed_ms = (time.perf_counter() - self._t0) * 1000.0
            self._t0 = None
        return self.elapsed_ms


class StageTimes:
    """Accumulates per-stage wall times across frames."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        """Mean ms per call of each stage, stages sorted by name."""
        return {k: 1000.0 * self.totals[k] / max(self.counts[k], 1) for k in sorted(self.totals)}

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.1f}ms" for k, v in self.summary().items())


class FrameMetrics:
    """Structured per-frame metrics (inliers, timings, map size) with JSONL
    export."""

    def __init__(self):
        self.rows: List[dict] = []

    def record(self, **kv):
        self.rows.append(kv)

    def save_jsonl(self, path: str):
        with open(path, "w") as f:
            for r in self.rows:
                f.write(json.dumps(r) + "\n")

    def column(self, key):
        return [r.get(key) for r in self.rows]


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """A torch.profiler trace of the enclosed work (CPU and, where a card
    is present, CUDA activity) written to `logdir/trace.json`. No-op if
    logdir is None."""
    if logdir is None:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
