"""Device (H100): CUDA kernels of any kind (copies and fills left out) in
the traced frames' span of the profiler's timeline, per frame."""


def read(ctx):
    t = ctx["trace"]
    return t["launches_per_frame"] if t["kernels"] else None
