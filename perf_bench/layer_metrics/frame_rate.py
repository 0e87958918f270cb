"""Host loop (the facade's closed loop): frames whose call returned in the
measured window over the window's seconds, the final drain included, as
the harness's clock reads them; the rate the user's sequence is processed
at. The host sets it (the card idles most of a frame), so it follows the
machine's host speed from run to run by more than any bound allows, and is
reported here without one."""


def read(ctx):
    return ctx["frames"] / ctx["window_s"] if ctx["window_s"] > 0 else None
