"""Per-frame step, the tracking core (`_track_core`: K1 alignment, K4
projection matching, K2 pose GN): median host ms of the window's
`sdslam.track_core` spans, from the program's spans."""

from perf_bench.layer_metrics import _spans


def read(ctx):
    return _spans.median_of(ctx, "sdslam.track_core")
