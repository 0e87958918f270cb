"""What the span readers share: the program's spans of the measured window
(`sdslam_tpu_torch.utils.profiling.spans()`, whose request id is one of
the window's facade calls, `ctx["calls"]`), which leaves out set-up, the
final flush, the traced block and `finish()`. None where the program
records no spans, or where a window call has no `sdslam.frame` root (a
dropped span): a missing reading shows instead of a wrong one."""

import statistics


def window(ctx):
    """(the window's spans, {call: its sdslam.frame span}) or None."""
    try:
        from sdslam_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    calls = {c["call"] for c in ctx["calls"]}
    if read is None or not calls:
        return None
    held = [s for s in read() if s.req in calls]
    roots = {s.req: s for s in held if s.name == "sdslam.frame"}
    if len(roots) != len(calls):
        return None
    return held, roots


def ms(s) -> float:
    return (s.t1_ns - s.t0_ns) / 1e6


def median_ms(spans):
    """Median duration (ms) of `spans`, None for none."""
    d = [ms(s) for s in spans]
    return statistics.median(d) if d else None


def median_of(ctx, name: str):
    """Median duration (ms) of the window's spans named `name`."""
    w = window(ctx)
    return None if w is None else median_ms(s for s in w[0] if s.name == name)
