"""Chessboard pattern detection for metric-scale monocular initialization
and camera calibration (port of sdslam_tpu/features/pattern.py).

Replaces the reference's PatternDetector: a 6x4-inner-corner chessboard
with 28.3 mm cells gives the monocular pipeline true metric scale on the
first frame. The board pose comes from solvePnP, and every keypoint whose
ray hits the board plane inside the board rectangle becomes a metric 3D
point (Get3DPoints / IsInsideRectangle).

Corner detection, PnP and calibration are host OpenCV calls at ingest, with
the flags and the cornerSubPix criteria of the JAX module; they run once
per initialization attempt or per calibration. `cv2` is imported where it
is used. Everything here is numpy on the host, so both packages compute
the same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from sdslam_tpu_torch.geometry.camera import CameraModel

PATTERN_SIZE = (6, 4)  # inner corners
CELL_SIZE = 0.0283  # metres


class PatternResult(NamedTuple):
    found: bool
    T_board_cam: Optional[np.ndarray]  # [4,4] board -> camera
    corners_uv: Optional[np.ndarray]  # [24,2]


def board_object_points(pattern_size=PATTERN_SIZE, cell=CELL_SIZE) -> np.ndarray:
    cols, rows = pattern_size
    pts = np.zeros((cols * rows, 3), np.float32)
    grid = np.mgrid[0:cols, 0:rows].T.reshape(-1, 2)
    pts[:, :2] = grid * cell
    return pts


def _intrinsics(cam: CameraModel) -> np.ndarray:
    """K as float64 from its float32 entries (the JAX module reads its
    float32 cam.K)."""
    K = np.array([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]], np.float32)
    return K.astype(np.float64)


def detect_pattern(img: np.ndarray, cam: CameraModel, pattern_size=PATTERN_SIZE,
                   cell=CELL_SIZE) -> PatternResult:
    """Find the chessboard and the camera pose relative to it
    (SearchChessboard + GetRT). img: [H,W] u8, or any real array clipped
    to [0, 255]."""
    import cv2

    gray = img if img.dtype == np.uint8 else np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    found, corners = cv2.findChessboardCorners(
        gray, pattern_size, flags=cv2.CALIB_CB_ADAPTIVE_THRESH | cv2.CALIB_CB_NORMALIZE_IMAGE)
    if not found:
        return PatternResult(False, None, None)
    corners = cv2.cornerSubPix(
        gray, corners, (5, 5), (-1, -1),
        (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3)).reshape(-1, 2)
    dist = np.array([cam.k1, cam.k2, cam.p1, cam.p2, cam.k3])
    ok, rvec, tvec = cv2.solvePnP(board_object_points(pattern_size, cell).astype(np.float64),
                                  corners.astype(np.float64), _intrinsics(cam), dist)
    if not ok:
        return PatternResult(False, None, None)
    R, _ = cv2.Rodrigues(rvec)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = tvec.ravel()
    return PatternResult(True, T, corners.astype(np.float32))


def metric_points_on_board(result: PatternResult, cam: CameraModel, uv: np.ndarray,
                           pattern_size=PATTERN_SIZE, cell=CELL_SIZE, margin: float = 0.0):
    """Intersect the rays of undistorted keypoints uv [N,2] with the board
    plane and keep the hits inside the board rectangle (Get3DPoints +
    IsInsideRectangle). Returns (mask [N], X_cam [N,3] metric points in
    the camera frame)."""
    if not result.found:
        raise ValueError("metric_points_on_board needs a found pattern")
    T = result.T_board_cam
    R, t = T[:3, :3], T[:3, 3]
    n = R[:, 2]  # board normal in the camera frame
    d = float(n @ t)
    rays = np.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy,
                     np.ones(len(uv))], 1)
    denom = rays @ n
    depth = np.where(np.abs(denom) > 1e-6, d / denom, -1.0)
    X_cam = rays * depth[:, None]
    Xb = (X_cam - t) @ R  # board coordinates
    cols, rows = pattern_size
    w, h = (cols - 1) * cell, (rows - 1) * cell
    inside = ((depth > 0) & (Xb[:, 0] >= -margin) & (Xb[:, 0] <= w + margin)
              & (Xb[:, 1] >= -margin) & (Xb[:, 1] <= h + margin))
    return inside, X_cam.astype(np.float32)


def calibrate_from_images(images, pattern_size=PATTERN_SIZE, cell: float = 0.0302):
    """Camera calibration from chessboard views (Examples/Calibration:
    30.2 mm cells). Returns (CameraModel, rms reprojection error in px)."""
    import cv2

    obj = board_object_points(pattern_size, cell).astype(np.float32)
    obj_pts, img_pts = [], []
    shape = None
    for img in images:
        gray = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
        shape = gray.shape[::-1]
        found, corners = cv2.findChessboardCorners(gray, pattern_size)
        if found:
            obj_pts.append(obj)
            img_pts.append(corners.reshape(-1, 2).astype(np.float32))
    if len(obj_pts) < 3:
        raise RuntimeError("need >= 3 successful chessboard detections")
    # higher-order coefficients are unstable with few views: fix them
    flags = cv2.CALIB_FIX_K3 | cv2.CALIB_ZERO_TANGENT_DIST
    rms, K, dist, _, _ = cv2.calibrateCamera(obj_pts, img_pts, shape, None, None, flags=flags)
    dist = np.concatenate([dist.ravel(), np.zeros(5)])
    cam = CameraModel(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
                      width=shape[0], height=shape[1], k1=float(dist[0]), k2=float(dist[1]),
                      p1=float(dist[2]), p2=float(dist[3]), k3=float(dist[4]))
    return cam, float(rms)
