"""The traced block of a `--trace 1` run: a fixed number of consecutive
frames under `torch.profiler` (CPU and CUDA activity), with the kernels'
launches recorded, reduced to the readings the per-layer metrics and the
result's `device` and `breakdown` take.

The tracer misses launches right after it starts, so the block idles the
card for 50 ms inside the trace before its frames; only device events
inside the block's own span count. Events are read from the profiler's raw
event list (no Chrome trace is written).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

from perf_bench import roofline

BLOCK = "perf_bench.traced_frames"


def traced_block(feed, n_frames: int, drain) -> dict:
    """Run `feed()` n_frames times, then `drain()` (which waits for the
    card), under the profiler. Returns the reduced readings."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with roofline.LaunchRecorder() as rec, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(0.05)
        with record_function(BLOCK):
            for _ in range(n_frames):
                feed()
            drain()
            torch.cuda.synchronize()
    out = reduce_events(prof.profiler.kineto_results.events(), n_frames)
    out["bound_s"] = rec.bound_seconds()
    out["launches_recorded"] = len(rec.calls)
    return out


def _is_device(e) -> bool:
    """A device operation (kernel, copy, fill); the block's own annotation,
    which the profiler also draws on the device's row, is none."""
    return (e.device_type() == torch.autograd.DeviceType.CUDA and e.name() != BLOCK
            and not e.is_user_annotation())


def _short(name: str) -> str:
    base = name.split("(")[0].strip()
    return base[:120]


def reduce_events(events, n_frames: int) -> dict:
    """Device busy time, idle gaps, launches and the hand-written kernels'
    device time inside the traced block."""
    block = [e for e in events if e.name() == BLOCK
             and e.device_type() == torch.autograd.DeviceType.CPU]
    if not block:
        raise RuntimeError("the traced block's span is missing from the trace")
    t0, t1 = block[0].start_ns(), block[0].end_ns()
    dev = sorted((e for e in events if _is_device(e) and t0 <= e.start_ns() <= t1),
                 key=lambda e: e.start_ns())
    cpu = sorted((e for e in events if not _is_device(e) and e.name() != BLOCK
                  and t0 <= e.start_ns() <= t1), key=lambda e: e.start_ns())
    busy, gaps, cur_s, cur_e = 0, [], None, None
    by_name = defaultdict(int)
    own_ns, kernels = 0, 0
    prev_name = "block start"
    for e in dev:
        s, en = e.start_ns(), e.end_ns()
        name = _short(e.name())
        by_name[name] += en - s
        if not name.startswith(("Memcpy", "Memset")):
            kernels += 1
        if roofline.is_hand_written(e.name()):
            own_ns += en - s
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((s - cur_e, cur_e, s, prev_name, name))
            cur_s, cur_e = s, en
        else:
            cur_e = max(cur_e, en)
        prev_name = name
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps.sort(reverse=True)
    starts = [e.start_ns() for e in cpu]
    window = t1 - t0
    return {
        "window_s": window / 1e9,
        "busy_s": busy / 1e9,
        "kernels": kernels,
        "launches_per_frame": kernels / n_frames,
        "own_device_s": own_ns / 1e9,
        "device_ops": [[n, v / 1e9] for n, v in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[_host_doing(cpu, starts, a, b, p, q), g / 1e9]
                      for g, a, b, p, q in gaps[:10]],
    }


def _host_doing(cpu, starts, a: int, b: int, prev_dev: str, next_dev: str) -> str:
    """What the host ran while the card idled over [a, b]: the innermost
    host op spanning the gap's middle, or else the host ops just before and
    after it (the interpreter ran between them). `starts`: the sorted host
    ops' start times."""
    mid = (a + b) // 2
    k = bisect.bisect_right(starts, mid)
    inside = [e for e in cpu[max(0, k - 2000):k] if e.end_ns() >= mid]
    if inside:
        return f"host in {_short(inside[-1].name())} (before {next_dev})"
    p = _short(max(cpu[max(0, k - 2000):k], key=lambda e: e.end_ns()).name()) if k else "?"
    n = _short(cpu[k].name()) if k < len(cpu) else "?"
    return f"host between {p} and {n} (after {prev_dev}, before {next_dev})"
