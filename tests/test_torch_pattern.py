"""The chessboard slice: the port's features/pattern.py, MonoTracker's
pattern initialization and the CLI's `calibration` against sdslam_tpu.

Boards are rendered as tests/test_pattern.py renders them; the tracker
runs on the poster scene (io/synthetic.PosterSequence: the room texture on
a tilted poster at 0.5 m with a 6x4 board inset) at test_pattern.py's
configuration (320x240, 512 keypoints, 3 levels, 8 keyframe slots). Both
packages make the same host OpenCV calls, so the detections agree to 1e-6.
"""

import numpy as np
import pytest
import torch

from sdslam_tpu import cli as jcli
from sdslam_tpu.features import pattern as jpat
from sdslam_tpu.pipeline.tracking import MonoTracker as JMono
from sdslam_tpu.utils import config as jconfig
from sdslam_tpu_torch import cli as tcli
from sdslam_tpu_torch.features import pattern as tpat
from sdslam_tpu_torch.geometry.camera import CameraModel as TCam
from sdslam_tpu_torch.io import synthetic as tsyn
from sdslam_tpu_torch.pipeline.tracking import MonoTracker as TMono
from sdslam_tpu_torch.utils import config as tconfig
from test_pattern import CAM as JCAM
from test_pattern import board_pose, render_board

torch.set_num_threads(2)

TCAM = TCam(*JCAM)
N_TRACK = 5  # frames tracked after the initialization


def _views(cell=tpat.CELL_SIZE):
    """Six boards at the poses of test_pattern.py's calibration round trip."""
    return [render_board(JCAM, board_pose(z=0.5 + 0.08 * i, rx=0.25 + 0.12 * i,
                                           ry=-0.25 + 0.12 * i, tx=-0.06 + 0.02 * i,
                                           ty=-0.04 + 0.015 * i), cell=cell)
            for i in range(6)]


def test_constants_and_object_points():
    assert tpat.PATTERN_SIZE == jpat.PATTERN_SIZE and tpat.CELL_SIZE == jpat.CELL_SIZE
    for args in ((), ((6, 4), 0.0302), ((7, 5), 0.01)):
        np.testing.assert_array_equal(tpat.board_object_points(*args),
                                      jpat.board_object_points(*args))


@pytest.mark.parametrize("view", [0, 2, 5, "noise", "u8"])
def test_detect_pattern(view):
    if view == "noise":
        img = np.random.default_rng(7).uniform(0, 255, (240, 320)).astype(np.float32)
    elif view == "u8":
        img = np.clip(render_board(JCAM, board_pose()), 0, 255).astype(np.uint8)
    else:
        img = _views()[view]
    a, b = jpat.detect_pattern(img, JCAM), tpat.detect_pattern(img, TCAM)
    assert a.found == b.found
    if view in (0, "noise", "u8"):  # the steep view 5 may go either way
        assert a.found == (view != "noise")
    if a.found:
        np.testing.assert_allclose(b.T_board_cam, a.T_board_cam, atol=1e-6)
        np.testing.assert_allclose(b.corners_uv, a.corners_uv, atol=1e-6)


def test_metric_points_on_board():
    img = render_board(JCAM, board_pose())
    a, b = jpat.detect_pattern(img, JCAM), tpat.detect_pattern(img, TCAM)
    uv = np.concatenate([a.corners_uv, np.random.default_rng(8).uniform(
        0, 320, (200, 2)).astype(np.float32)])
    for margin in (0.0, 0.005):
        ia, Xa = jpat.metric_points_on_board(a, JCAM, uv, margin=margin)
        ib, Xb = tpat.metric_points_on_board(b, TCAM, uv, margin=margin)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_allclose(Xb, Xa, atol=1e-6)
        assert ia[:24].mean() > 0.5 and not ia[24:].all()
    with pytest.raises(ValueError):
        tpat.metric_points_on_board(tpat.PatternResult(False, None, None), TCAM, uv)


@pytest.fixture
def one_cv_thread():
    """calibrateCamera sums in thread order (repeated calls part at ~1e-8
    relative with several threads): one OpenCV thread while comparing."""
    import cv2

    n = cv2.getNumThreads()
    cv2.setNumThreads(1)
    yield
    cv2.setNumThreads(n)


def test_calibrate_from_images(one_cv_thread):
    views = _views(cell=0.0302)
    (ca, ra), (cb, rb) = (jpat.calibrate_from_images(views, cell=0.0302),
                          tpat.calibrate_from_images(views, cell=0.0302))
    assert abs(ra - rb) < 1e-6 and ra < 1.0
    for f in TCam._fields:
        if f in JCAM._fields:
            assert abs(getattr(ca, f) - getattr(cb, f)) < 1e-6, f
    assert abs(cb.fx - JCAM.fx) / JCAM.fx < 0.12
    with pytest.raises(RuntimeError):
        tpat.calibrate_from_images(views[:2], cell=0.0302)


def test_cli_calibration_matches_jax(tmp_path, capsys, one_cv_thread):
    from PIL import Image

    folder = tmp_path / "views"
    folder.mkdir()
    for i, v in enumerate(_views(cell=0.0302)):
        Image.fromarray(np.clip(v, 0, 255).astype(np.uint8)).save(folder / f"v{i}.png")
    ja, tb = str(tmp_path / "jax.yaml"), str(tmp_path / "port.yaml")
    assert jcli.main(["calibration", str(folder), "--out", ja]) == 0
    j_out = capsys.readouterr().out
    assert tcli.main(["calibration", str(folder), "--out", tb]) == 0
    assert capsys.readouterr().out == j_out.replace(ja, tb)
    assert open(tb).read() == open(ja).read()


@pytest.fixture(scope="module")
def poster_runs():
    """Frame 0 (board in view) initializes; N_TRACK more frames of the
    sweep (no still start) follow. One JAX tracker for the module."""
    seq = tsyn.PosterSequence(TCAM, tsyn.poster_trajectory(30, hold=0)[:N_TRACK + 1],
                              device="cpu")
    frames = [seq.frame(i) for i in range(N_TRACK + 1)]
    map_ = dict(max_keyframes=8, max_points=2048, max_kps_per_frame=512)
    orb = dict(max_keypoints=512, n_levels=3)
    tj = JMono(jconfig.SystemConfig(camera=JCAM, orb=jconfig.ORBConfig(**orb),
                                    map=jconfig.MapConfig(**map_),
                                    tracking=jconfig.TrackingConfig(use_pattern=True)))
    tp = TMono(tconfig.SystemConfig(camera=TCAM, orb=tconfig.ORBConfig(**orb),
                                    map=tconfig.MapConfig(**map_),
                                    tracking=tconfig.TrackingConfig(use_pattern=True)),
               device="cpu")
    out = {}
    for ts, img in frames:
        tj.track(img, ts)
        tp.track(img, ts)
        if not out:  # right after the initialization
            out["init"] = (np.asarray(tj.ms.pt_valid), np.asarray(tj.ms.pt_pos),
                           tp.ms.pt_valid.numpy(), tp.ms.pt_pos.numpy(), tp.host_syncs)
    tj.flush()
    tp.flush()
    out.update(tj=tj, tp=tp, gt=seq.poses.numpy())
    return out


def test_pattern_initialization_matches_jax(poster_runs):
    vj, Xj, vp, Xp, syncs = poster_runs["init"]
    assert vj.sum() == vp.sum() >= 20
    np.testing.assert_array_equal(vj, vp)
    np.testing.assert_allclose(Xp[vp], Xj[vj], atol=1e-5)
    # a metric map on the board at 0.5 m
    assert abs(np.median(Xp[vp][:, 2]) - 0.5) < 0.15
    # the image, the keypoints and the inlier count read on the host
    assert syncs == 3
    tj, tp = poster_runs["tj"], poster_runs["tp"]
    assert tj.st.status == tp.st.status == "OK"


def test_pattern_trajectory_matches_jax(poster_runs):
    from scipy.spatial.transform import Rotation

    a = np.stack([np.asarray(p) for p in poster_runs["tj"].trajectory])
    b = np.stack([np.asarray(p) for p in poster_runs["tp"].trajectory])
    assert a.shape == b.shape == (N_TRACK + 1, 4, 4)
    np.testing.assert_array_equal(b[0], np.eye(4, dtype=np.float32))
    ca = -np.einsum("nji,nj->ni", a[:, :3, :3], a[:, :3, 3])
    cb = -np.einsum("nji,nj->ni", b[:, :3, :3], b[:, :3, 3])
    assert np.abs(ca - cb).max() < 1e-3
    rot = Rotation.from_matrix(np.einsum("nij,nkj->nik", a[:, :3, :3].astype(np.float64),
                                         b[:, :3, :3].astype(np.float64)))
    assert np.linalg.norm(rot.as_rotvec(), axis=1).max() < 5e-3
