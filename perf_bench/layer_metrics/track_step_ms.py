"""Per-frame step (`RGBDTracker._step`: ORB, the motion filters,
`_track_core`): median ms of the window's non-keyframe steps, from the
tracker's CUDA events (`RGBDTracker.frame_ms["track"]`)."""

import statistics


def read(ctx):
    v = ctx["frame_ms"]["track"]
    return statistics.median(v) if v else None
