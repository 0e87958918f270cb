"""The viewers: the port's viewer.py against sdslam_tpu's (renders in
array mode pixel for pixel on one map carried across by interop.py), the
live viewer's endpoints over tests/test_viewer_server.py's fake system,
plane staging from CPU tensors, and the menu actions applied at a frame
boundary of a CPU SDSlamSystem."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdslam_tpu import viewer as jviewer
from sdslam_tpu.geometry.camera import CameraModel as JCam
from sdslam_tpu.mapping import map_state as jM
from sdslam_tpu_torch import interop
from sdslam_tpu_torch import viewer as tviewer
from sdslam_tpu_torch.geometry.camera import CameraModel as TCam
from sdslam_tpu_torch.io import synthetic as tsyn
from sdslam_tpu_torch.mapping import map_state as tM
from sdslam_tpu_torch.system import RGBD, SDSlamSystem
from sdslam_tpu_torch.utils.config import MapConfig, ORBConfig, SystemConfig
from sdslam_tpu_torch.viewer_server import LiveViewer
from test_viewer_server import _get, _post, _Sys

torch.set_num_threads(2)

CAM = dict(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320, height=240, bf=32.0)
PNG = b"\x89PNG\r\n\x1a\n"


def _plane_points(rng, n=200, outliers=40):
    pts = rng.uniform([-1, 0.5, 1.0], [1, 0.5, 3.0], size=(n, 3))
    pts[:, 1] += rng.normal(size=n) * 0.002
    return np.concatenate([pts, rng.uniform(-1, 3, (outliers, 3))]).astype(np.float32)


@pytest.fixture(scope="module")
def maps():
    """One map in both packages: 6 keyframes on an arc with a spanning
    tree, a loop edge, and points each keyframe observes in part."""
    rng = np.random.default_rng(21)
    K, P, N = 8, 300, 64
    d = {k: (tuple(np.asarray(x) for x in v) if k == "kf_pyramid" else np.array(v))
         for k, v in jM.init_map(K, P, N, ((15, 20),))._asdict().items()}
    for k in range(6):
        c, yaw = np.array([0.3 * np.sin(k / 2), 0.0, 0.2 * k]), 0.1 * k
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
        d["kf_Tcw"][k][:3, :3], d["kf_Tcw"][k][:3, 3] = R.T, -R.T @ c
        d["kf_mp"][k] = rng.choice(250, N, replace=False)
        d["kf_kp_valid"][k] = True
    d["kf_valid"][:6] = True
    d["kf_parent"][1:6] = np.arange(5)
    d["loop_edges"][0] = (5, 0)
    d["pt_pos"] = rng.normal(0, 1.0, (P, 3)).astype(np.float32)
    d["pt_valid"][:250] = True
    jms = jM.MapState(**{k: (tuple(jnp.asarray(x) for x in v) if k == "kf_pyramid"
                             else jnp.asarray(v)) for k, v in d.items()})
    traj = [np.asarray(T) for T in d["kf_Tcw"][:6]]
    return jms, interop.map_state_from_numpy(d, device="cpu"), traj


def test_covisibility_and_map_render(maps):
    jms, tms, traj = maps
    cov = tM.covisibility(tms).numpy()
    np.testing.assert_array_equal(cov, np.asarray(jM.covisibility(jms)))
    assert (cov >= 15).sum() > 0  # the covisibility layer draws edges
    for kw in ({}, {"trajectory": traj}, {"show_covisibility": False}):
        a = jviewer.draw_map(jms, **kw)
        b = tviewer.draw_map(tms, **kw)
        assert b.ndim == 3 and b.shape[2] == 3
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("matched", [False, True])
def test_draw_frame(matched):
    rng = np.random.default_rng(22)
    img = rng.uniform(0, 255, (240, 320)).astype(np.float32)
    uv = rng.uniform(0, [320, 240], (150, 2)).astype(np.float32)
    mask = rng.random(150) < 0.6 if matched else None
    a = jviewer.draw_frame(img, uv, matched_mask=mask, state_text="SLAM MODE")
    b = tviewer.draw_frame(torch.from_numpy(img), torch.from_numpy(uv),
                           matched_mask=None if mask is None else torch.from_numpy(mask),
                           state_text="SLAM MODE")
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["plane", "insufficient", "no_plane"])
def test_detect_plane(case):
    rng = np.random.default_rng(23)
    pts = {"plane": _plane_points(rng), "insufficient": np.zeros((2, 3)),
           "no_plane": rng.uniform(-1, 1, (60, 3))}[case]
    a, b = jviewer.detect_plane(pts), tviewer.detect_plane(pts)
    assert (a is None) == (b is None) == (case != "plane")
    if a is not None:
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
        np.testing.assert_array_equal(a[2], b[2])


def test_draw_ar():
    rng = np.random.default_rng(24)
    pts = _plane_points(rng)
    plane = tviewer.detect_plane(pts)
    img = np.full((240, 320), 128, np.uint8)
    Tcw = np.eye(4, dtype=np.float32)
    Tcw[:3, 3] = (0.05, -0.1, 0.2)
    a = jviewer.draw_ar(img, JCam(**CAM), Tcw, plane, points=pts)
    b = tviewer.draw_ar(torch.from_numpy(img), TCam(**CAM), torch.from_numpy(Tcw), plane,
                        points=pts)
    np.testing.assert_array_equal(a, b)
    # the plane frame alone, with and without the points
    for p in (pts, None):
        for x, y in zip(jviewer._plane_frame(plane, p), tviewer._plane_frame(plane, p)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("args", [("NOT_INITIALIZED", 0, 0, 0), ("LOST", 5, 100, 0),
                                  ("OK", 7, 420, 55), ("OK", 7, 420, 55, True)])
def test_status_text(args):
    assert tviewer.status_text(*args) == jviewer.status_text(*args)


def test_viewer_server_endpoints():
    """tests/test_viewer_server.py's endpoint sequence on the port."""
    sysm = _Sys()
    v = LiveViewer(sysm)
    port = v.start(port=0)
    try:
        code, ctype, body = _get(port, "/")
        assert code == 200 and "text/html" in ctype and b"sdslam_tpu" in body
        s = json.loads(_get(port, "/status.json")[2])
        assert s["state"] == "OK" and s["keyframes"] == 2 and s["points"] == 5
        code, ctype, body = _get(port, "/frame.png")
        assert code == 200 and ctype == "image/png" and body[:8] == PNG
        # POSTs only queue; apply_pending applies at a frame boundary
        for path in ("/reset", "/localization/on", "/localization/off"):
            assert _post(port, path) == 200
        assert sysm.calls == []
        assert json.loads(_get(port, "/status.json")[2])["pending_actions"] == 3
        assert v.apply_pending() == ["reset", "localization_on", "localization_off"]
        assert sysm.calls == ["reset", "loc_on", "loc_off"]
        sysm.tracker.ms.pt_pos = np.concatenate(
            [np.random.default_rng(0).uniform(-1, 1, (30, 2)), np.zeros((30, 1))], axis=1)
        sysm.tracker.ms.pt_valid = np.ones(30, bool)
        assert _post(port, "/plane/add") == 200
        for _ in range(50):
            v.apply_pending()
            if v.planes:
                break
        assert len(v.planes) == 1
        assert _post(port, "/plane/clear") == 200
        v.apply_pending()
        assert len(v.planes) == 0
        assert _post(port, "/stop_save") == 200
        assert "stop" not in sysm.calls
        v.apply_pending()
        assert sysm.calls[-1] == "stop" and sysm.stop_requested
        assert json.loads(_get(port, "/status.json")[2])["stop_requested"] is True
        import urllib.error

        with pytest.raises(urllib.error.HTTPError):
            _post(port, "/no/such/action")
    finally:
        v.stop()


def test_plane_staging_from_cpu_tensors():
    """Points held as CPU tensors are ready at once; the plane is fitted on
    a snapshot taken when the action applies."""
    sysm = _Sys()
    v = LiveViewer(sysm)
    pts = _plane_points(np.random.default_rng(25))
    sysm.tracker.ms.pt_pos = torch.from_numpy(pts)
    sysm.tracker.ms.pt_valid = torch.ones(len(pts), dtype=torch.bool)
    v.request("plane_add")
    v.apply_pending()
    assert v._staged_planes == [] and len(v.planes) == 1
    n, d, inl = v.planes[0]["plane"]
    ref = tviewer.detect_plane(pts, seed=0)
    np.testing.assert_array_equal(n, ref[0])
    np.testing.assert_array_equal(v.planes[0]["points"], pts)
    sysm.tracker.ms.pt_pos.zero_()  # the snapshot does not follow the map
    assert np.abs(v.planes[0]["points"]).sum() > 0


def test_after_frame_applies_queued_actions():
    """SDSlamSystem._after_frame applies the viewer's queue on the tracking
    thread: nothing changes until the next frame ends."""
    cam = TCam(**CAM)
    cfg = SystemConfig(camera=cam, orb=ORBConfig(max_keypoints=256, n_levels=3),
                       map=MapConfig(max_keyframes=8, max_points=2048, max_kps_per_frame=256))
    seq = tsyn.SyntheticSequence(cam, n_frames=16, trajectory="orbit", radius=0.06,
                                 yaw_amp=0.04, device="cpu")
    sysm = SDSlamSystem(cfg, sensor=RGBD, loop_closing=False, device="cpu")
    v = LiveViewer(sysm)
    ts, img, dep = seq.frame(0)
    sysm.track_rgbd(img.numpy(), dep.numpy(), ts)
    for a in ("plane_add", "localization_on", "stop_save"):
        v.request(a)
    assert not sysm.localization_only and not sysm.stop_requested
    ts, img, dep = seq.frame(1)
    sysm.track_rgbd(img.numpy(), dep.numpy(), ts)
    assert sysm.localization_only and sysm.stop_requested
    assert v._staged_planes == [] and v._actions == []
    # the renders of a tracked system
    assert v.map_png()[:8] == PNG and v.frame_png()[:8] == PNG
    v.request("reset")
    ts, img, dep = seq.frame(2)
    sysm.track_rgbd(img.numpy(), dep.numpy(), ts)
    assert sysm._live_viewer is v and v.planes == []
    assert sysm.tracker.st.status == "NOT_INITIALIZED"
