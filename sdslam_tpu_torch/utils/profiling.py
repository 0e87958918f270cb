"""Tracing, profiling and structured metrics (sdslam_tpu/utils/profiling.py).

`Timer` is the reference's stopwatch (extra/timer.h), `StageTimes` sums
per-stage wall times over frames, `FrameMetrics` records per-frame rows and
writes them as JSONL. `device_trace(logdir)` wraps a `torch.profiler` trace
with CPU and CUDA activity that writes a Chrome trace into `logdir` (view it
in chrome://tracing or Perfetto); `None` makes it a no-op.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

log = logging.getLogger("sdslam_tpu_torch")


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
