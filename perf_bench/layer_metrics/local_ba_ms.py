"""Keyframe pass, local BA (`solvers/ba.py`, K3 and K6): median host ms of
the window's `sdslam.kf.local_ba` spans, from the program's spans."""

from perf_bench.layer_metrics import _spans


def read(ctx):
    return _spans.median_of(ctx, "sdslam.kf.local_ba")
