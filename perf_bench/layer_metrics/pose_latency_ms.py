"""Host loop, pipeline depth (`RGBDTracker.PIPELINE_DEPTH`): median ms
from a frame's hand-off (its `sdslam.frame` start) to the end of the
`sdslam.drain` that brought its pose to the host, over the window's frames
whose row a drain inside a later window call applied, from the program's
spans. `frame_ms_p95` times the call; this times the pose."""

import statistics

from perf_bench.layer_metrics import _spans


def read(ctx):
    w = _spans.window(ctx)
    if w is None:
        return None
    held, roots = w
    lat = []
    for d in held:
        if d.name != "sdslam.drain":
            continue
        for f in range(d.frame, d.frame + d.n):
            if f in roots and f < d.req:
                lat.append((d.t1_ns - roots[f].t0_ns) / 1e6)
    return statistics.median(lat) if lat else None
