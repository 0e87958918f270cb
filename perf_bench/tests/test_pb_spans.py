"""The span readers (`perf_bench/layer_metrics/`: orb_ms, track_core_ms,
local_ba_ms, loop_closing_ms, host_wait_share, pose_latency_ms) on
fabricated spans and a fabricated run context: what each reads, that only
the window's calls count, and None where a window call lost its root span
or the program records no spans."""

from pathlib import Path

import pytest

from perf_bench.manifest import Manifest
from sdslam_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]
NAMES = ("orb_ms", "track_core_ms", "local_ba_ms", "loop_closing_ms", "host_wait_share",
         "pose_latency_ms")
MS = 1_000_000  # ns


class Fab:
    """Spans of fabricated calls: each call `c` starts at c * 100 ms."""

    def __init__(self):
        self.spans, self.next_id = [], 1

    def add(self, name, req, t0_ms, t1_ms, parent=0, n=0, frame=-1):
        s = profiling.Span(name, self.next_id, parent, req, int(t0_ms * MS), int(t1_ms * MS),
                           n, frame)
        self.next_id += 1
        self.spans.append(s)
        return s

    def call(self, c, orb=10.0, core=20.0, wait=1.0, drain_of=None, kf=False, loop=0.0):
        """One facade call: upload, ORB, the tracking core, the keyframe
        decision's wait, on keyframes the pass with local BA, a drain of
        frame `drain_of`, a loop poll of `loop` ms."""
        t = 100.0 * c
        root = self.add("sdslam.frame", c, t, t + 90.0, n=1)
        self.add("sdslam.upload", c, t, t + 1.0, root.id)
        self.add("sdslam.orb", c, t + 1.0, t + 1.0 + orb, root.id)
        self.add("sdslam.track_core", c, t + 12.0, t + 12.0 + core, root.id)
        self.add("sdslam.wait", c, t + 40.0, t + 40.0 + wait, root.id)
        if kf:
            k = self.add("sdslam.kf", c, t + 45.0, t + 70.0, root.id, n=1)
            self.add("sdslam.kf.local_ba", c, t + 50.0, t + 60.0, k.id)
        if drain_of is not None:
            d = self.add("sdslam.drain", c, t + 75.0, t + 78.0, root.id, n=1, frame=drain_of)
            self.add("sdslam.wait", c, t + 75.0, t + 77.0, d.id)
        if loop:
            p = self.add("sdslam.loop.poll", c, t + 80.0, t + 80.0 + loop, root.id)
            self.add("sdslam.wait", c, t + 80.0, t + 80.5, p.id)


@pytest.fixture(scope="module")
def readers():
    m = Manifest(ROOT)
    return {n: m.layer_reader(n) for n in NAMES}


def _ctx(calls, ms=100.0):
    return {"calls": [{"call": c, "lap_idx": c, "ms": ms} for c in calls], "frames": len(calls)}


@pytest.fixture
def fab(monkeypatch):
    f = Fab()
    monkeypatch.setattr(profiling, "spans", lambda: list(f.spans))
    return f


def _run(fab):
    """Set-up calls 0-1, window calls 2-9 (drains 4 behind, a keyframe
    on every third call, a loop poll per call), then the final flush's
    drains outside any call and a traced call 10."""
    for c in range(10):
        fab.call(c, orb=10.0 + c, core=20.0 + c, drain_of=c - 4 if c >= 5 else None,
                 kf=c % 3 == 0, loop=2.0 if c >= 2 else 0.0)
    for f in range(6, 10):  # the final flush: request -1
        d = fab.add("sdslam.drain", -1, 1000.0 + f, 1000.5 + f, n=1, frame=f)
        fab.add("sdslam.wait", -1, 1000.0 + f, 1000.4 + f, d.id)
    fab.call(10, orb=500.0, core=500.0, wait=50.0, drain_of=6, kf=True, loop=40.0)
    return _ctx(range(2, 10))


def test_readers_on_the_window(readers, fab):
    ctx = _run(fab)
    r = {n: readers[n](ctx) for n in NAMES}
    assert r["orb_ms"] == pytest.approx(15.5)  # 12..19 ms over calls 2-9
    assert r["track_core_ms"] == pytest.approx(25.5)
    assert r["local_ba_ms"] == pytest.approx(10.0)  # calls 3, 6, 9
    assert r["loop_closing_ms"] == pytest.approx(2.0)  # the poll only, its wait inside
    # waits: 8 decisions of 1 ms, drains of calls 5-9 at 2 ms, polls at 0.5 ms
    assert r["host_wait_share"] == pytest.approx(100.0 * (8 + 5 * 2 + 8 * 0.5) / 800.0)
    # frames 2-5, drained in calls 6-9 at +78 ms of that call: 400 + 78 - 0
    assert r["pose_latency_ms"] == pytest.approx(478.0)


def test_a_lost_root_reads_nothing(readers, fab):
    ctx = _run(fab)
    fab.spans = [s for s in fab.spans if not (s.name == "sdslam.frame" and s.req == 4)]
    assert all(readers[n](ctx) is None for n in NAMES)


def test_a_program_without_spans_reads_nothing(readers, monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert all(readers[n](_ctx(range(3))) is None for n in NAMES)


def test_a_cell_without_the_layer_reads_nothing(readers, fab):
    """The localize cell: no keyframe pass, no loop closer."""
    for c in range(6):
        fab.call(c, drain_of=c - 4 if c >= 4 else None)
    ctx = _ctx(range(6))
    assert readers["local_ba_ms"](ctx) is None and readers["loop_closing_ms"](ctx) is None
    assert readers["orb_ms"](ctx) == pytest.approx(10.0)
    assert readers["pose_latency_ms"](ctx) == pytest.approx(478.0)


def test_relocalization_orb_is_not_a_tracked_frame(readers, fab):
    fab.call(0, orb=10.0)
    root = fab.add("sdslam.frame", 1, 100.0, 190.0, n=1)
    reloc = fab.add("sdslam.reloc", 1, 100.0, 180.0, root.id)
    fab.add("sdslam.orb", 1, 101.0, 171.0, reloc.id)
    assert readers["orb_ms"](_ctx([0, 1])) == pytest.approx(10.0)
