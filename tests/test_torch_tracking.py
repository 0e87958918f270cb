"""The slice as a whole: the port's RGBDTracker against sdslam_tpu's at test
size (the small_cfg of tests/test_odometry.py: 320x240, 512 keypoints,
4 levels, 32 keyframe slots, 4096 points), with every kernel on its plain
version on the CPU.

  * one step on state carried across from the JAX tracker;
  * end to end on the 16-frame orbit and forward sequences, against the
    odometry gates and against the JAX trajectory;
  * track_batch against per-frame track;
  * the module's entry points track_step and kf_pipeline on the carried
    state, and reset_reference with and without a pose.
"""

import numpy as np
import pytest
import torch

from sdslam_tpu.io import synthetic as jsyn
from sdslam_tpu.pipeline import tracking as jt
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
KF_AT = 7  # the first keyframe after CARRY_AT on the orbit
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
    """JAX trajectories of both sequences and their drained rows; for the
    orbit also the state before frames CARRY_AT, KF_AT and KF_AT + 1."""
    out = {}
    for name in SEQS:
        frames, gt = _frames(name)
        tj = JTracker(small_cfg())
        rows = _record_rows(tj)
        snaps = {}
        for k, (ts, img, dep) in enumerate(frames):
            if k in (CARRY_AT, KF_AT, KF_AT + 1):
                snaps[k] = (_np_tree(tj.ms), _np_tree(tj.dst))
            tj.track(img, dep, ts)
        tj.flush()
        est = np.stack([np.asarray(p) for p in tj.trajectory])
        out[name] = dict(frames=frames, gt=gt, est=est, rows=rows, snaps=snaps,
                         snap=snaps[CARRY_AT], n_kf=int(tj.ms.n_keyframes()))
        if name == "orbit":  # re-anchored last: nothing above reads it
            out[name]["reset"] = [_reset_state(tj, RESET_SLOT, Tcw)
                                  for Tcw in (None, gt[RESET_AT])]
    return out


RESET_SLOT, RESET_AT = 1, 9  # re-anchor at keyframe slot 1, at frame 9's true pose


def _reset_state(tracker, slot, Tcw):
    """The host pose, reference slot and restarted filters after
    reset_reference(slot, Tcw)."""
    tracker.reset_reference(slot, Tcw)
    dst = _np_tree(tracker.dst)
    return dict(T_last=np.array(tracker.st.T_last, np.float32),
                slot=int(tracker.st.last_kf_slot), ekf=dst["ekf"], imu=dst["imu"],
                dst_slot=int(dst["last_kf_slot"]))


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


def _carried_tracker(j, k):
    """A port tracker on the JAX tracker's state after frames 0..k-1."""
    ms_np, dst_np = j["snaps"][k]
    tp = tt.RGBDTracker(port_cfg(), device="cpu")
    tp.ms = interop.map_state_from_numpy(ms_np, device="cpu")
    tp.dst = interop.device_state_from_numpy(dst_np, device="cpu")
    tp.st.status = "OK"
    tp.st.frame_id = k
    tp._t0 = j["frames"][0][0]
    tp.trajectory = [None] * k
    return tp


def test_one_step_on_carried_state(jax_runs):
    j = jax_runs["orbit"]
    dst_np = j["snap"][1]
    tp = _carried_tracker(j, CARRY_AT)
    back = interop.device_state_to_numpy(tp.dst)
    filters = ("ekf", "imu")
    pairs = [(dst_np[k][f], back[k][f]) for k in filters for f in back[k]]
    pairs += [(dst_np[k], back[k]) for k in back if k not in filters]
    assert set(back) == set(dst_np) and set(back["imu"]) == set(dst_np["imu"])
    for a, b in pairs:  # every field, the IMU filter's included, both ways
        np.testing.assert_array_equal(a, b, strict=True)
    rows = _record_rows(tp)
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


def test_reset_reference_matches_jax(jax_runs, port_runs):
    """reset_reference(slot) re-anchors at the keyframe's pose (each
    package's own map: within 1e-4), reset_reference(slot, Tcw) at Tcw
    (equal); the motion and IMU filters restart the same way."""
    tp = port_runs["orbit"]
    for want, Tcw in zip(jax_runs["orbit"]["reset"], (None, jax_runs["orbit"]["gt"][RESET_AT])):
        got = _reset_state(tp, RESET_SLOT, Tcw)
        assert got["slot"] == got["dst_slot"] == want["slot"] == want["dst_slot"] == RESET_SLOT
        tol = 1e-4 if Tcw is None else 0.0
        np.testing.assert_allclose(got["T_last"], want["T_last"], atol=tol)
        for f in ("ekf", "imu"):
            for k, v in want[f].items():
                np.testing.assert_allclose(got[f][k], v, atol=tol, err_msg=f"{f}.{k}")
    np.testing.assert_array_equal(got["T_last"], np.float32(jax_runs["orbit"]["gt"][RESET_AT]))


def test_track_step_and_kf_pipeline_match_jax(jax_runs, monkeypatch):
    """The JAX module's entry points, on the JAX tracker's state before
    keyframe frame KF_AT: called with the arguments and keywords (the JAX
    static_argnames) that the port's tracker hands its cores for that
    frame, track_step gives the JAX row's inlier, match and alignment
    counts and its packed pose is its TrackOutput's; kf_pipeline gives the
    JAX row's pose (after local BA) and the JAX map after the frame."""
    j = jax_runs["orbit"]
    tp = _carried_tracker(j, KF_AT)
    calls = {}

    def spy(name):
        orig = getattr(tt, name)

        def rec(*args, **kw):
            calls[name] = (args, kw)
            return orig(*args, **kw)
        monkeypatch.setattr(tt, name, rec)

    spy("_track_core")
    spy("_kf_core")
    ts, img, dep = j["frames"][KF_AT]
    tp.track(img, dep, ts)
    tp.flush()
    assert set(calls) == {"_track_core", "_kf_core"}
    row = j["rows"][KF_AT]
    assert row[jt.PACK_NEED_KF] == 1.0

    args, kw = calls["_track_core"]
    assert set(kw) <= {"scale_factor", "n_levels", "align_min_level", "th_radius",
                       "pose_gn_schedule"}
    ot, pt = tt.track_step(*args, **kw)
    pt = pt.numpy()
    assert pt.shape == (19,)
    np.testing.assert_allclose(pt[tt.PACK_POSE], ot.Tcw.numpy().ravel())
    for k in (tt.PACK_INLIERS, tt.PACK_MATCHES):
        assert pt[k] == row[jt.PACK_INLIERS if k == tt.PACK_INLIERS else jt.PACK_MATCHES]
        assert pt[k] > 100, k
    np.testing.assert_allclose(pt[tt.PACK_ALIGN_ERR], row[jt.PACK_ALIGN_ERR], rtol=1e-3)

    args, kw = calls["_kf_core"]
    assert set(kw) <= {"scale_factor", "n_levels", "covis_min", "ba_schedule", "sync"}
    mst, slot_t, row_t, T_t = tt.kf_pipeline(*args, **kw)
    msj = jax_runs["orbit"]["snaps"][KF_AT + 1][0]
    assert int(slot_t) == int(row[jt.PACK_N_KFS]) - 1
    np.testing.assert_array_equal(row_t.numpy(), msj["kf_mp"][int(slot_t)])
    np.testing.assert_allclose(T_t.numpy().ravel(), row[jt.PACK_POSE], atol=1e-4)
    np.testing.assert_allclose(mst.kf_Tcw.numpy(), msj["kf_Tcw"], atol=1e-4)
    np.testing.assert_array_equal(mst.pt_valid.numpy(), msj["pt_valid"])
    assert int(mst.n_points()) > 100
