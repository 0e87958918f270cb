"""Keyframe pass (`_kf_core`: insertion, fusion, local BA, spawning,
culling): median ms of the window's keyframe steps, from the tracker's
CUDA events (`RGBDTracker.frame_ms["kf"]`, the whole step of a keyframe
frame)."""

import statistics


def read(ctx):
    v = ctx["frame_ms"]["kf"]
    return statistics.median(v) if v else None
