"""Device (H100): share (%) of the traced frames' span in which no device
operation ran (profiler timeline: the union of kernel, copy and fill
events against the block's span)."""


def read(ctx):
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t["window_s"] > 0 else None
