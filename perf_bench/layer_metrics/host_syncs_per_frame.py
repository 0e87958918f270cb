"""Host loop (`pipeline/tracking.py`): device->host syncs the tracker counts
(`RGBDTracker.host_syncs`: keyframe decisions, drains, the keyframe pass's
gates) per frame of the measured window."""


def read(ctx):
    return ctx["host_syncs"] / ctx["frames"] if ctx["frames"] else None
