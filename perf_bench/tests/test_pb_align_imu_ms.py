"""The `align_ms` and `imu_ms` readers (`perf_bench/layer_metrics/`) on
fabricated spans, with `test_pb_spans.py`'s fabricated calls: the
direct-alignment seed's `sdslam.align` span inside each call's
`sdslam.track_core`, and the IMU filter's `sdslam.motion.imu` spans
(predict and update) inside its `sdslam.motion` spans."""

import pytest

from perf_bench.manifest import Manifest
from perf_bench.tests.test_pb_spans import ROOT, Fab, _ctx
from sdslam_tpu_torch.utils import profiling


@pytest.fixture(scope="module")
def readers():
    m = Manifest(ROOT)
    return {n: m.layer_reader(n) for n in ("align_ms", "imu_ms")}


@pytest.fixture
def fab(monkeypatch):
    f = Fab()
    monkeypatch.setattr(profiling, "spans", lambda: list(f.spans))
    return f


def _seed_and_imu(fab, calls, align=4.0, imu=(0.5, 0.7)):
    """Each listed call's `sdslam.align` (`align` ms) under its tracking
    core, and with `imu` its two `sdslam.motion` spans, each holding one
    `sdslam.motion.imu` of the given ms."""
    for s in list(fab.spans):
        if s.req not in calls:
            continue
        if s.name == "sdslam.track_core":
            fab.add("sdslam.align", s.req, s.t0_ns / 1e6 + 0.5, s.t0_ns / 1e6 + 0.5 + align, s.id)
        if s.name == "sdslam.frame" and imu:
            t = s.t0_ns / 1e6
            for k, (t0, ms) in enumerate(((11.0, imu[0]), (42.0, imu[1]))):
                m = fab.add("sdslam.motion", s.req, t + t0, t + t0 + 0.9, s.id)
                fab.add("sdslam.motion.imu", s.req, t + t0 + 0.1, t + t0 + 0.1 + ms, m.id)


def test_align_ms_is_the_median_seed(readers, fab):
    for c in range(5):
        fab.call(c)
    for c, ms in enumerate((3.0, 4.0, 9.0, 5.0, 4.5)):
        _seed_and_imu(fab, {c}, align=ms, imu=None)
    assert readers["align_ms"](_ctx(range(5))) == pytest.approx(4.5)
    assert readers["imu_ms"](_ctx(range(5))) is None  # no IMU


def test_imu_ms_sums_a_frames_predict_and_update(readers, fab):
    for c in range(4):
        fab.call(c)
    _seed_and_imu(fab, {0, 1}, imu=(0.5, 0.7))
    _seed_and_imu(fab, {2, 3}, imu=(1.0, 1.5))
    # per frame 1.2, 1.2, 2.5, 2.5: the median 1.85
    assert readers["imu_ms"](_ctx(range(4))) == pytest.approx(1.85)


def test_only_the_window_counts(readers, fab):
    """Set-up calls 0-1 and a traced call 5 take long; the window is 2-4."""
    for c in range(6):
        fab.call(c)
    _seed_and_imu(fab, {0, 1, 5}, align=50.0, imu=(9.0, 9.0))
    _seed_and_imu(fab, {2, 3, 4}, align=4.0, imu=(0.5, 0.5))
    assert readers["align_ms"](_ctx(range(2, 5))) == pytest.approx(4.0)
    assert readers["imu_ms"](_ctx(range(2, 5))) == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["align_ms", "imu_ms"])
def test_a_dropped_root_reads_nothing(readers, fab, name):
    for c in range(4):
        fab.call(c)
    _seed_and_imu(fab, set(range(4)))
    assert readers[name](_ctx(range(4))) is not None
    fab.spans = [s for s in fab.spans if not (s.name == "sdslam.frame" and s.req == 2)]
    assert readers[name](_ctx(range(4))) is None


@pytest.mark.parametrize("name", ["align_ms", "imu_ms"])
def test_a_program_without_the_spans_reads_nothing(readers, fab, monkeypatch, name):
    """The parent's program opens neither span; a program may record none."""
    for c in range(4):
        fab.call(c)
    assert readers[name](_ctx(range(4))) is None
    monkeypatch.delattr(profiling, "spans")
    assert readers[name](_ctx(range(4))) is None
