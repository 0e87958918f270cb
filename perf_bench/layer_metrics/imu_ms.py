"""Per-frame step, the IMU filter (`pipeline/sensors.py` `imu_predict`
and `imu_update`, run in the frame step once IMU samples arrive): over the
window's frames that run it, the median of a frame's summed
`sdslam.motion.imu` spans (host ms), from the program's spans. None where
no window frame holds such a span (no IMU, or a program without it)."""

import statistics
from collections import defaultdict

from perf_bench.layer_metrics import _spans


def read(ctx):
    w = _spans.window(ctx)
    if w is None:
        return None
    per_frame = defaultdict(float)
    for s in w[0]:
        if s.name == "sdslam.motion.imu":
            per_frame[s.req] += _spans.ms(s)
    return statistics.median(per_frame.values()) if per_frame else None
