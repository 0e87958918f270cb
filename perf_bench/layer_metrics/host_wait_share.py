"""Host loop, device->host reads: the share (%) of the window's call time
the host spent blocked in its declared reads (the `sdslam.wait` spans:
drains, the keyframe decision, the culling gate, the loop closer's
results), over the summed wall ms of the window's calls as the harness
logged them. Near 0, the host sets the pace: the untraced counterpart of
`device_idle_share`."""

from perf_bench.layer_metrics import _spans


def read(ctx):
    w = _spans.window(ctx)
    total = sum(c["ms"] for c in ctx["calls"])
    if w is None or total <= 0:
        return None
    return 100.0 * sum(_spans.ms(s) for s in w[0] if s.name == "sdslam.wait") / total
