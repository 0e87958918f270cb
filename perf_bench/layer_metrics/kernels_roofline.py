"""Kernels K1-K7 (`kernels/*_kernel.py` -> `csrc/*.cu`): the least time
the card could take for the hand-written kernels' launches of the traced
frames (perf_bench/roofline.py, counted from each launch's arguments),
over their device time in the profiler's kernel events, in %."""


def read(ctx):
    t = ctx["trace"]
    if t["own_device_s"] <= 0 or t["launches_recorded"] == 0:
        return None
    return 100.0 * t["bound_s"] / t["own_device_s"]
