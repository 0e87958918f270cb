"""The port's pipelined tracker (sdslam_tpu_torch/parallel/pipelined.py):
the keyframe mapping pass on a worker thread beside the tracking loop (a
second CUDA stream on the card; the thread alone on the CPU), held to the
gates of tests/test_pipelined.py and to the JAX package's
PipelinedRGBDTracker."""

import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from sdslam_tpu.geometry.camera import CameraModel as JCam
from sdslam_tpu.io.synthetic import SyntheticSequence as JSeq
from sdslam_tpu.parallel.pipelined import PipelinedRGBDTracker as JPipelined
from sdslam_tpu.utils import config as jconfig
from sdslam_tpu_torch.geometry import lie
from sdslam_tpu_torch.geometry.camera import CameraModel as TCam
from sdslam_tpu_torch.io.synthetic import SyntheticSequence
from sdslam_tpu_torch.parallel.pipelined import PipelinedRGBDTracker
from sdslam_tpu_torch.utils import config as tconfig
from sdslam_tpu_torch.utils import profiling
from sdslam_tpu_torch.utils.metrics import ate_rmse

torch.set_num_threads(2)


def _config(config, cam_cls, cam, kps, levels, kfs, pts):
    return config.SystemConfig(
        camera=cam_cls(**cam), orb=config.ORBConfig(max_keypoints=kps, n_levels=levels),
        map=config.MapConfig(max_keyframes=kfs, max_points=pts, max_kps_per_frame=kps),
        tracking=config.TrackingConfig())


def _blocking(tracker, after=lambda: None):
    """Make every poll of the mapping job wait for it (on this instance):
    the swaps then land at the same frames whatever the timing. `after`
    runs after each poll."""
    poll = tracker._poll_map_job

    def blocking(block=False):
        poll(block=True)
        after()

    tracker._poll_map_job = blocking


def _commit(jt):
    """Place the JAX tracker's device state on its tracking device. It
    builds that state from uncommitted arrays at start-up and at each swap,
    and each change of placement recompiles its fused step (~12 s here)
    without changing a value."""
    if jt.dst is not None:
        jt.dst = jax.device_put(jt.dst, jt.track_device)


CAM = dict(fx=160.0, fy=160.0, cx=79.5, cy=59.5, width=160, height=120, bf=16.0)


def test_pipelined_tracks_and_maps(monkeypatch):
    """tests/test_pipelined.py's gates on the port alone (its 14-frame
    orbit at tests/test_dist_align.py's configuration), polls not
    blocking: the passes overlap the tracking loop. The worker's spans
    carry their keyframe's trajectory index and open no span of the
    tracking thread's."""
    monkeypatch.setattr(profiling, "_RECORDER", profiling.SpanRecorder())
    cam = CAM
    cfg = _config(tconfig, TCam, cam, 256, 3, 8, 1024)
    tr = PipelinedRGBDTracker(cfg, device="cpu")
    threads, kf_frames = [], []
    kf_pass = tr._kf_pass

    def spy(*a, **kw):
        threads.append(threading.current_thread())
        kf_frames.append(a[7])  # the keyframe's trajectory index
        return kf_pass(*a, **kw)

    tr._kf_pass = spy
    n = 14
    seq = SyntheticSequence(TCam(**cam), n_frames=n, trajectory="orbit", radius=0.05,
                            yaw_amp=0.03, device="cpu")
    for i in range(n):
        ts, img, depth = seq.frame(i)
        tr.track(img.numpy(), depth.numpy(), ts)
    tr.flush()

    n_kf = int(tr.ms.kf_valid.sum())
    assert n_kf >= 2, "no mapping pass completed"
    est = np.stack([np.asarray(p) for p in tr.trajectory])
    ate = ate_rmse(est, seq.poses.numpy())
    assert ate < 0.02, f"ATE too high: {ate}"
    # the tracking snapshot lives on the tracking device
    assert all(t.device == tr.track_device for v in tr.ms
               for t in (v if isinstance(v, tuple) else (v,)))
    # every mapping pass ran on the worker thread and was swapped in
    assert threads and all(t is not threading.main_thread() for t in threads)
    assert len(threads) == tr.kf_dispatched == len(tr.kf_events) >= 1
    assert tr.map_syncs >= 2 * tr.kf_dispatched  # culling gate + slot, per pass
    spans = profiling.spans()
    by_id = {s.id: s for s in spans}
    passes = [s for s in spans if s.name == "sdslam.kf"]
    assert [s.req for s in passes] == kf_frames and all(s.parent == 0 for s in passes)
    for s in spans:
        root = s
        while root.parent:
            root = by_id[root.parent]
        if root.name == "sdslam.kf":
            assert s.req == root.req
            assert s.name in ("sdslam.kf", "sdslam.wait") or s.name.startswith("sdslam.kf.")
        else:
            # a call's spans, or the final flush's drains
            assert root.name in ("sdslam.frame", "sdslam.drain")
            assert not s.name.startswith("sdslam.kf")
    waits = sum(s.name == "sdslam.wait" for s in spans if s.req in kf_frames
                and by_id.get(s.parent, s).name.startswith("sdslam.kf"))
    assert waits == tr.map_syncs
    with pytest.raises(NotImplementedError, match="track_batch"):
        tr.track_batch([seq.frame(0)])


def test_pipelined_matches_jax():
    """12-frame orbit at tests/test_dist_align.py's configuration through
    both packages' pipelined trackers, every poll blocking.

    The JAX tracker's flush drains through RGBDTracker's burst drain, which
    bypasses its own _drain_one: a keyframe decision drained there starts
    no mapping pass and is recorded as slot -1 in kf_events (and in
    st.last_kf_slot). The port's flush dispatches the pass and records its
    slot. So the JAX events without the -1 entries open the port's, and
    each -1 entry is one more pass at the end of the port's."""
    cam = CAM
    n = 12
    jseq = JSeq(JCam(**cam), n_frames=n, trajectory="orbit", radius=0.05, yaw_amp=0.05)
    frames = [jseq.frame(i) for i in range(n)]
    jt = JPipelined(_config(jconfig, JCam, cam, 256, 3, 8, 1024))
    tt = PipelinedRGBDTracker(_config(tconfig, TCam, cam, 256, 3, 8, 1024), device="cpu")
    _blocking(jt, after=lambda: _commit(jt))
    _blocking(tt)

    def run(tr, after=lambda: None):
        for ts, img, depth in frames:
            tr.track(np.asarray(img), np.asarray(depth), ts)
            after()
        tr.flush()

    # the port's run beside the JAX tracker's (whose time is nearly all
    # compiling): the two share no state
    with ThreadPoolExecutor(1) as pool:
        port_run = pool.submit(run, tt)
        run(jt, after=lambda: _commit(jt))
        port_run.result()

    jax_passes = [e for e in jt.kf_events if e >= 0]
    assert len(jax_passes) >= 2 and tt.kf_events[:len(jax_passes)] == jax_passes
    assert len(tt.kf_events) == len(jt.kf_events) and min(tt.kf_events) >= 0
    for k, (a, b) in enumerate(zip(jt.trajectory, tt.trajectory)):
        d = lie.se3_log(torch.from_numpy(np.asarray(b) @ np.linalg.inv(np.asarray(a)))).numpy()
        assert np.abs(d[:3]).max() < 1e-3 and np.abs(d[3:]).max() < 5e-3, (k, d)
    # the JAX tracker cannot run the track_batch it inherits either (the
    # reason the port's raises NotImplementedError)
    ts, img, depth = frames[0]
    item = (np.asarray(img).astype(np.uint8), (np.asarray(depth) * 1000).astype(np.uint16), ts)
    with pytest.raises((AttributeError, TypeError), match="_step_packed_core|NoneType"):
        jt.track_batch([item])


def test_launch_counters_count_from_threads():
    """The mapping worker and the tracking thread both count kernel
    launches: no increment may be lost when threads switch mid-update."""
    import sys

    from sdslam_tpu_torch import kernels
    from sdslam_tpu_torch.kernels import chol_kernel

    n_threads, n_each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        kernels.reset_counters()
        workers = [threading.Thread(target=lambda: [kernels.count_launch(chol_kernel.__name__)
                                                    for _ in range(n_each)])
                   for _ in range(n_threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
        assert kernels.read_counters()["chol_solve"] == n_threads * n_each
    finally:
        sys.setswitchinterval(old)
        kernels.reset_counters()
