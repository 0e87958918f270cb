"""Per-frame step, the direct-alignment seed (`pipeline/tracking.py`
`_align_seed`: kernel K1 on the frame's alignment levels, which on a
distorted camera are remapped to its pinhole camera): median host ms of
the window's `sdslam.align` spans, from the program's spans. None where
the program opens no such span."""

from perf_bench.layer_metrics import _spans


def read(ctx):
    return _spans.median_of(ctx, "sdslam.align")
