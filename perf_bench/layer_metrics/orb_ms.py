"""Per-frame step, ORB (`features/frame.py`, `ops/orb.py`, `ops/fast.py`):
median host ms of the window's tracked frames' `sdslam.orb` span (the
extraction right under a call's root; a relocalization's is left out), from
the program's spans. The card idles most of a frame, so this is the host's
enqueue of the extraction."""

from perf_bench.layer_metrics import _spans


def read(ctx):
    w = _spans.window(ctx)
    if w is None:
        return None
    held, roots = w
    ids = {r.id for r in roots.values()}
    return _spans.median_ms(s for s in held if s.name == "sdslam.orb" and s.parent in ids)
