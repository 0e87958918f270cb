"""The port's span recorder (sdslam_tpu_torch/utils/profiling.py) on the
frame path: the facade's root spans and their request ids, the stages'
nesting, the waits against the tracker's counted host syncs, the bounded
ring's drops, and the profiler annotations entered only while a profiler
runs. CPU, 160x120 frames of io/synthetic.py."""

import collections

import numpy as np
import pytest
import torch

from sdslam_tpu_torch.geometry.camera import CameraModel
from sdslam_tpu_torch.io.synthetic import SyntheticSequence
from sdslam_tpu_torch.pipeline import loop_closing
from sdslam_tpu_torch.pipeline.tracking import RGBDTracker
from sdslam_tpu_torch.system import RGBD, SDSlamSystem
from sdslam_tpu_torch.utils import profiling
from sdslam_tpu_torch.utils.config import MapConfig, ORBConfig, SystemConfig, TrackingConfig

torch.set_num_threads(2)

CAM = CameraModel(fx=160.0, fy=160.0, cx=79.5, cy=59.5, width=160, height=120, bf=16.0)
DEPTH_FACTOR = 5000.0
N_FRAMES = 12
STEP_STAGES = {"sdslam.upload", "sdslam.orb", "sdslam.motion", "sdslam.track_core"}
KF_STAGES = {"sdslam.kf.insert", "sdslam.kf.fuse", "sdslam.kf.local_ba", "sdslam.kf.spawn",
             "sdslam.kf.cull", "sdslam.kf.stats"}


def _config():
    return SystemConfig(camera=CAM, orb=ORBConfig(max_keypoints=256, n_levels=3),
                        map=MapConfig(max_keyframes=16, max_points=2048, max_kps_per_frame=256),
                        tracking=TrackingConfig(depth_map_factor=DEPTH_FACTOR))


@pytest.fixture(scope="module")
def frames():
    """The orbit's frames as an RGB-D camera's payloads (u8 image, u16
    depth): the packed upload path the benchmark takes."""
    seq = SyntheticSequence(CAM, n_frames=N_FRAMES, trajectory="orbit", radius=0.05,
                            yaw_amp=0.03, device="cpu")
    out = []
    for i in range(N_FRAMES):
        ts, img, depth = seq.frame(i)
        out.append((np.clip(np.rint(img.numpy()), 0, 255).astype(np.uint8),
                    np.rint(depth.numpy() * DEPTH_FACTOR).astype(np.uint16), ts))
    return out


@pytest.fixture
def recorder(monkeypatch):
    """A fresh process-wide ring for the test."""
    rec = profiling.SpanRecorder()
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    return rec


def _ancestors(s, by_id):
    out = []
    while s.parent:
        s = by_id[s.parent]
        out.append(s)
    return out


@pytest.fixture(scope="module")
def facade_run(frames):
    """The facade over the orbit, with its spans and its counted syncs."""
    rec = profiling.SpanRecorder()
    saved, profiling._RECORDER = profiling._RECORDER, rec
    try:
        slam = SDSlamSystem(_config(), sensor=RGBD, loop_closing=True, device="cpu")
        syncs0 = slam.tracker.host_syncs
        returned = [slam.track_rgbd(img, dep, ts) for img, dep, ts in frames]
        syncs = slam.tracker.host_syncs - syncs0
    finally:
        profiling._RECORDER = saved
    return slam, rec.spans(), syncs, returned


def test_one_root_per_call_with_its_trajectory_index(facade_run):
    slam, spans, _, _ = facade_run
    roots = [s for s in spans if s.parent == 0]
    assert [s.name for s in roots] == ["sdslam.frame"] * N_FRAMES
    assert [s.req for s in roots] == list(range(N_FRAMES))
    assert len(slam.tracker.trajectory) == N_FRAMES
    by_id = {s.id: s for s in spans}
    for s in spans:  # every span of a call carries the call's request id
        if s.parent:
            assert s.req == _ancestors(s, by_id)[-1].req
    names = collections.Counter(s.name for s in spans)
    assert set(names) >= STEP_STAGES | KF_STAGES | {"sdslam.kf", "sdslam.drain",
                                                     "sdslam.wait", "sdslam.loop.poll"}
    assert names["sdslam.orb"] == N_FRAMES  # one extraction per call, the first included
    assert names["sdslam.track_core"] == N_FRAMES - 1
    assert names["sdslam.loop.poll"] == N_FRAMES
    assert all(names[k] == names["sdslam.kf"] >= 1 for k in KF_STAGES)


def test_children_nest_inside_their_parents(facade_run):
    _, spans, _, _ = facade_run
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent:
            p = by_id[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns, (s, p)
    of = collections.defaultdict(set)
    for s in spans:
        if s.parent:
            of[s.name].add(by_id[s.parent].name)
    for name in STEP_STAGES | {"sdslam.drain", "sdslam.loop.poll", "sdslam.kf"}:
        assert of[name] == {"sdslam.frame"}, (name, of[name])
    for name in KF_STAGES:
        assert of[name] == {"sdslam.kf"}, (name, of[name])
    # a wait says which read it was: the keyframe decision (under the
    # frame), a drain, or the culling gate
    assert of["sdslam.wait"] <= {"sdslam.frame", "sdslam.drain", "sdslam.kf.cull"}
    assert "sdslam.drain" in of["sdslam.wait"] and "sdslam.kf.cull" in of["sdslam.wait"]


def test_waits_match_the_counted_syncs(facade_run):
    _, spans, syncs, _ = facade_run
    by_id = {s.id: s for s in spans}
    loop, tracker = 0, 0
    for s in spans:
        if s.name != "sdslam.wait":
            continue
        if any(a.name.startswith("sdslam.loop.") for a in _ancestors(s, by_id)):
            loop += 1
        else:
            tracker += 1
    assert tracker == syncs > 0
    assert loop == 0  # a CPU result needs no wait, and no Sim3 was verified


def test_drains_cover_each_tracked_frame_once(facade_run):
    slam, spans, _, returned = facade_run
    rows = []
    for s in spans:
        if s.name == "sdslam.drain":
            assert s.n == 1 and s.frame < s.req  # drained by a later call
            rows += range(s.frame, s.frame + s.n)
    pending = [i for i, _ in slam.tracker._pending]
    # the first frame initializes (its pose is on the host at once)
    assert sorted(rows + pending) == list(range(1, N_FRAMES))
    assert len(pending) == RGBDTracker.PIPELINE_DEPTH
    assert isinstance(returned[0], np.ndarray) and isinstance(returned[-1], torch.Tensor)


def test_loop_closer_read_opens_a_wait(recorder):
    """A landed detection result read on the card waits on its copy's
    event: that wait is a child of the loop closer's span."""

    class Event:
        def synchronize(self):
            pass

    rb = loop_closing._Readback(torch.arange(3.0))
    rb.event = Event()
    with profiling.span("sdslam.loop.poll"):
        assert rb.numpy().tolist() == [0.0, 1.0, 2.0]
    wait, poll = recorder.spans()
    assert (wait.name, poll.name, wait.parent) == ("sdslam.wait", "sdslam.loop.poll", poll.id)


def test_tracker_without_the_facade_opens_its_root(recorder, frames):
    tr = RGBDTracker(_config(), device="cpu")
    for img, dep, ts in frames[:3]:
        tr.track(img, dep, ts)
    idx = tr.track_batch(frames[3:6])
    assert idx == [3, 4, 5]
    roots = [s for s in recorder.spans() if s.parent == 0]
    assert [(s.name, s.req, s.n) for s in roots] == [
        ("sdslam.frame", 0, 1), ("sdslam.frame", 1, 1), ("sdslam.frame", 2, 1),
        ("sdslam.frame", 3, 3)]
    names = collections.Counter(s.name for s in recorder.spans() if s.req == 3)
    assert names["sdslam.orb"] == names["sdslam.track_core"] == 3
    assert names["sdslam.upload"] == 1  # the batch's frames travel in one upload


def test_a_full_ring_drops_the_oldest_and_counts(monkeypatch, frames):
    rec = profiling.SpanRecorder(8)
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    slam = SDSlamSystem(_config(), sensor=RGBD, loop_closing=True, device="cpu")
    with profiling.span("probe") as probe:
        pass
    for img, dep, ts in frames[:3]:
        slam.track_rgbd(img, dep, ts)
    held = profiling.spans()
    assert len(held) == 8 and profiling.dropped() > 0
    # the newest are held: the last call's root closes last
    assert held[-1].name == "sdslam.frame" and held[-1].req == 2
    # one thread: the ids since the probe's count every span recorded
    assert profiling.dropped() + len(held) == max(s.id for s in held) - probe.id + 1


def test_profiler_annotations_only_while_profiling(recorder, monkeypatch, frames):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    slam = SDSlamSystem(_config(), sensor=RGBD, loop_closing=True, device="cpu")
    for img, dep, ts in frames[:2]:
        slam.track_rgbd(img, dep, ts)
    assert entered == [] and len(recorder.spans()) > 0
    n0 = len(recorder.spans())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        slam.track_rgbd(*frames[2])
    new = recorder.spans()[n0:]
    assert sorted(entered) == sorted(s.name for s in new)
    events = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {s.name for s in new} <= events
    entered.clear()
    slam.track_rgbd(*frames[3])
    assert entered == []


def test_alignment_seed_sits_in_each_tracking_core_once(facade_run):
    """`sdslam.align`, the direct-alignment seed, is a child of every
    tracked frame's `sdslam.track_core`, once."""
    _, spans, _, _ = facade_run
    by_id = {s.id: s for s in spans}
    cores = {s.id for s in spans if s.name == "sdslam.track_core"}
    aligns = [s for s in spans if s.name == "sdslam.align"]
    assert len(aligns) == len(cores) == N_FRAMES - 1
    assert sorted(s.parent for s in aligns) == sorted(cores)
    for s in aligns:
        assert by_id[s.parent].t0_ns <= s.t0_ns <= s.t1_ns <= by_id[s.parent].t1_ns


def test_imu_spans_only_with_an_active_imu(recorder, frames, facade_run):
    """`sdslam.motion.imu` (the IMU filter's predict and update) opens only
    once IMU samples arrive, inside its `sdslam.motion` span: none in the
    RGB-D facade's run nor before the first sample, two a tracked frame
    after it."""
    assert not any(s.name == "sdslam.motion.imu" for s in facade_run[1])
    tr = RGBDTracker(_config(), device="cpu")
    for i, (img, dep, ts) in enumerate(frames[:6]):
        if i >= 3:
            tr.inject_imu(np.zeros(3), np.array([0.0, -9.81, 0.0]))
        tr.track(img, dep, ts)
    spans = recorder.spans()
    by_id = {s.id: s for s in spans}
    imu = collections.Counter(s.req for s in spans if s.name == "sdslam.motion.imu")
    assert imu == {3: 2, 4: 2, 5: 2}
    assert {by_id[s.parent].name for s in spans if s.name == "sdslam.motion.imu"} == {
        "sdslam.motion"}
