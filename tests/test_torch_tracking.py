"""The slice as a whole: the port's RGBDTracker against sdslam_tpu's at test
size (the small_cfg of tests/test_odometry.py: 320x240, 512 keypoints,
4 levels, 32 keyframe slots, 4096 points), with every kernel on its plain
version on the CPU.

  * one step on state carried across from the JAX tracker;
  * end to end on the 16-frame orbit and forward sequences, against the
    odometry gates and against the JAX trajectory;
  * track_batch against per-frame track.
"""

import numpy as np
import pytest
import torch

from sdslam_tpu.io import synthetic as jsyn
from sdslam_tpu.pipeline.tracking import RGBDTracker as JTracker
from sdslam_tpu_torch import interop
from sdslam_tpu_torch.geometry.camera import CameraModel as TCam
from sdslam_tpu_torch.pipeline import tracking as tt
from sdslam_tpu_torch.utils import config as tcfg
from sdslam_tpu_torch.utils import metrics
from test_odometry import CAM as JCAM
from test_odometry import small_cfg

torch.set_num_threads(2)

TCAM = TCam(*JCAM)
N_FRAMES = 16
CARRY_AT = 6  # the JAX tracker runs frames 0..5; the port steps frame 6
SEQS = {"orbit": dict(radius=0.06, yaw_amp=0.04), "forward": dict(step=0.01)}


def port_cfg():
    j = small_cfg()
    return tcfg.SystemConfig(camera=TCAM, orb=tcfg.ORBConfig(**vars(j.orb)),
                             map=tcfg.MapConfig(**vars(j.map)))


def _frames(name):
    seq = jsyn.SyntheticSequence(JCAM, n_frames=N_FRAMES, trajectory=name, **SEQS[name])
    return [(t, np.asarray(i), np.asarray(d)) for t, i, d in (seq.frame(k) for k in
                                                                range(N_FRAMES))], \
        np.asarray(seq.poses)


def _record_rows(tracker):
    """Keep each drained packed result row, keyed by frame index."""
    rows = {}
    orig = tracker._apply_packed_row

    def rec(idx, p):
        rows[idx] = np.array(p)
        orig(idx, p)

    tracker._apply_packed_row = rec
    return rows


def _np_tree(x):
    if hasattr(x, "_asdict"):
        return {k: _np_tree(v) for k, v in x._asdict().items()}
    if isinstance(x, tuple):
        return tuple(np.array(v) for v in x)
    return np.array(x)  # a copy: the JAX tracker donates its state buffers


@pytest.fixture(scope="module")
def jax_runs():
    """JAX trajectories of both sequences; for the orbit also the state
    after CARRY_AT frames and the drained row of frame CARRY_AT."""
    out = {}
    for name in SEQS:
        frames, gt = _frames(name)
        tj = JTracker(small_cfg())
        rows = _record_rows(tj)
        snap = None
        for k, (ts, img, dep) in enumerate(frames):
            if k == CARRY_AT:
                snap = (_np_tree(tj.ms), _np_tree(tj.dst))
            tj.track(img, dep, ts)
        tj.flush()
        est = np.stack([np.asarray(p) for p in tj.trajectory])
        out[name] = dict(frames=frames, gt=gt, est=est, rows=rows, snap=snap,
                         n_kf=int(tj.ms.n_keyframes()))
    return out


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    out = {}
    for name, j in jax_runs.items():
        tp = tt.RGBDTracker(port_cfg(), device="cpu")
        for ts, img, dep in j["frames"]:
            tp.track(img, dep, ts)
        tp.flush()
        out[name] = tp
    return out


def test_one_step_on_carried_state(jax_runs):
    j = jax_runs["orbit"]
    ms_np, dst_np = j["snap"]
    tp = tt.RGBDTracker(port_cfg(), device="cpu")
    tp.ms = interop.map_state_from_numpy(ms_np)
    tp.dst = interop.device_state_from_numpy(dst_np)
    back = interop.device_state_to_numpy(tp.dst)
    filters = ("ekf", "imu")
    pairs = [(dst_np[k][f], back[k][f]) for k in filters for f in back[k]]
    pairs += [(dst_np[k], back[k]) for k in back if k not in filters]
    assert set(back) == set(dst_np) and set(back["imu"]) == set(dst_np["imu"])
    for a, b in pairs:  # every field, the IMU filter's included, both ways
        np.testing.assert_array_equal(a, b, strict=True)
    tp.st.status = "OK"
    tp.st.frame_id = CARRY_AT
    tp._t0 = j["frames"][0][0]
    rows = _record_rows(tp)
    tp.trajectory = [None] * CARRY_AT
    ts, img, dep = j["frames"][CARRY_AT]
    tp.track(img, dep, ts)
    tp.flush()
    a, b = j["rows"][CARRY_AT], rows[CARRY_AT]
    # pose after align + 2 pose GN solves on identical state: float32 sums
    # in another order move it by ~1e-7
    np.testing.assert_allclose(a[tt.PACK_POSE], b[tt.PACK_POSE], atol=1e-4)
    for f in (tt.PACK_NEED_KF, tt.PACK_INLIERS, tt.PACK_MATCHES, tt.PACK_N_KFS, tt.PACK_N_PTS):
        assert a[f] == b[f], f
    assert b[tt.PACK_INLIERS] > 100


@pytest.mark.parametrize("name", list(SEQS))
def test_end_to_end_gates_and_jax_parity(jax_runs, port_runs, name):
    j, tp = jax_runs[name], port_runs[name]
    est = np.stack([np.asarray(p) for p in tp.trajectory])
    gt = j["gt"]
    assert tp.st.status == "OK"
    ate = metrics.ate_rmse(est, gt, align=False)
    assert ate < 0.02
    if name == "orbit":
        rpe_t, _ = metrics.rpe(est, gt)
        assert rpe_t < 0.01
        assert int(tp.ms.kf_valid.sum()) >= 3
    # the tolerance tests/test_odometry.py accepts between tracker variants
    assert np.abs(est[:, :3, 3] - j["est"][:, :3, 3]).max() < 1e-3
    assert np.abs(est[:, :3, :3] - j["est"][:, :3, :3]).max() < 5e-3
    assert int(tp.ms.kf_valid.sum()) == j["n_kf"]


def test_track_batch_matches_per_frame(jax_runs):
    frames = [(img.astype(np.uint8), (dep * 1000).astype(np.uint16), ts)
              for ts, img, dep in jax_runs["orbit"]["frames"][:10]]
    cfg = port_cfg()
    cfg = tcfg.SystemConfig(camera=cfg.camera, orb=cfg.orb, map=cfg.map,
                            tracking=tcfg.TrackingConfig(depth_map_factor=1000.0))
    t1 = tt.RGBDTracker(cfg, device="cpu")
    for img, dep, ts in frames:
        t1.track(img, dep, ts)
    t1.flush()
    t2 = tt.RGBDTracker(cfg, device="cpu")
    t2.track_batch(frames[:5])  # initialization falls back to track()
    t2.track_batch(frames[5:], uploaded=t2.upload_batch(frames[5:]))
    t2.flush()
    a = np.stack([np.asarray(p) for p in t1.trajectory])
    b = np.stack([np.asarray(p) for p in t2.trajectory])
    assert a.shape == b.shape == (10, 4, 4)
    # the same per-frame step on the same inputs in the same order
    np.testing.assert_array_equal(a, b)
    assert t1.kf_events == t2.kf_events
