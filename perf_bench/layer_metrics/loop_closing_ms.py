"""Facade + loop closing (`system.py`, `pipeline/loop_closing.py`): host ms
per window frame in the loop closer, the sum of the window's outermost
`sdslam.loop.*` spans (each keyframe's detection dispatch, each frame's
poll) over the window's frames, from the program's spans."""

from perf_bench.layer_metrics import _spans


def read(ctx):
    w = _spans.window(ctx)
    if w is None:
        return None
    held, _ = w
    by_id = {s.id: s for s in held}

    def in_loop(s):
        return s is not None and s.name.startswith("sdslam.loop.")

    top = [s for s in held if in_loop(s) and not in_loop(by_id.get(s.parent))]
    return sum(_spans.ms(s) for s in top) / len(ctx["calls"]) if top else None
