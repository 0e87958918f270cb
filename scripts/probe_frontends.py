"""Probe what the viewers, the chessboard front-end and the camera need on a
machine with a CUDA card.

    python3 scripts/probe_frontends.py

Prints the card's `nvidia-smi` name and power limit, then one JSON line:

- whether matplotlib imports and renders a PNG with the Agg backend;
- whether OpenCV finds, refines and solves a rendered 6x4 chessboard
  (findChessboardCorners with adaptive threshold, cornerSubPix, solvePnP) at
  640x480, how long findChessboardCorners takes on a frame without a board,
  and whether calibrateCamera recovers fx from six rendered views;
- whether a device->host copy into pinned memory with a recorded
  torch.cuda.Event reports query() False while the copy waits behind device
  work, and True (with the right values) once it lands;
- whether /dev/video0 exists, and the PIL version (MJPG decoding).
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import time

import numpy as np
import torch

FX, W, H = 525.0, 640, 480
PATTERN = (6, 4)


def render_board(T_board_cam, cell: float, fx: float = FX):
    """A chessboard with a one-cell border, warped by its homography onto a
    mid-grey 640x480 frame."""
    import cv2

    cols, rows = PATTERN
    sq = 40
    bw, bh = (cols + 1) * sq, (rows + 1) * sq
    tex = np.zeros((bh, bw), np.uint8)
    for i in range(rows + 1):
        for j in range(cols + 1):
            if (i + j) % 2 == 0:
                tex[i * sq:(i + 1) * sq, j * sq:(j + 1) * sq] = 255
    corners = np.array([[-cell, -cell, 0], [cols * cell, -cell, 0],
                        [cols * cell, rows * cell, 0], [-cell, rows * cell, 0]], np.float64)
    Xc = corners @ T_board_cam[:3, :3].T + T_board_cam[:3, 3]
    uv = np.stack([fx * Xc[:, 0] / Xc[:, 2] + (W - 1) / 2,
                   fx * Xc[:, 1] / Xc[:, 2] + (H - 1) / 2], 1).astype(np.float32)
    src = np.array([[0, 0], [bw, 0], [bw, bh], [0, bh]], np.float32)
    Hm, _ = cv2.findHomography(src, uv)
    img = np.full((H, W), 128, np.uint8)
    warped = cv2.warpPerspective(tex, Hm, (W, H), flags=cv2.INTER_LINEAR, borderValue=128)
    mask = cv2.warpPerspective(np.full_like(tex, 255), Hm, (W, H)) > 0
    img[mask] = warped[mask]
    return img


def board_pose(z, rx, ry, tx, ty):
    import cv2

    T = np.eye(4)
    T[:3, :3] = cv2.Rodrigues(np.array([rx, ry, 0.0]))[0]
    T[:3, 3] = [tx, ty, z]
    return T


def probe_matplotlib():
    try:
        import matplotlib
    except ImportError as e:
        return {"imports": False, "error": str(e)}
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.plot([0, 1], [0, 1])
    buf = io.BytesIO()
    t0 = time.perf_counter()
    fig.savefig(buf, format="png", dpi=80)
    ms = (time.perf_counter() - t0) * 1e3
    plt.close(fig)
    return {"imports": True, "version": matplotlib.__version__,
            "backend": matplotlib.get_backend(),
            "png": buf.getvalue()[:8] == b"\x89PNG\r\n\x1a\n", "savefig_ms": ms}


def probe_cv2():
    try:
        import cv2
    except ImportError as e:
        return {"imports": False, "error": str(e)}
    out = {"imports": True, "version": cv2.__version__}
    cell = 0.0283
    T = board_pose(0.5, 0.3, 0.2, -0.05, -0.03)
    img = render_board(T, cell)
    flags = cv2.CALIB_CB_ADAPTIVE_THRESH | cv2.CALIB_CB_NORMALIZE_IMAGE
    t0 = time.perf_counter()
    found, corners = cv2.findChessboardCorners(img, PATTERN, flags=flags)
    out["find_ms_board"] = (time.perf_counter() - t0) * 1e3
    out["found"] = bool(found)
    if found:
        corners = cv2.cornerSubPix(img, corners, (5, 5), (-1, -1),
                                   (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3))
        obj = np.zeros((PATTERN[0] * PATTERN[1], 3))
        obj[:, :2] = np.mgrid[0:PATTERN[0], 0:PATTERN[1]].T.reshape(-1, 2) * cell
        K = np.array([[FX, 0, (W - 1) / 2], [0, FX, (H - 1) / 2], [0, 0, 1]])
        ok, rvec, tvec = cv2.solvePnP(obj, corners.reshape(-1, 2).astype(np.float64), K,
                                      np.zeros(5))
        out["solvepnp_ok"] = bool(ok)
        out["pnp_trans_err_m"] = float(np.linalg.norm(tvec.ravel() - T[:3, 3]))
    noise = np.random.default_rng(0).uniform(0, 255, (H, W)).astype(np.uint8)
    t0 = time.perf_counter()
    found_noise, _ = cv2.findChessboardCorners(noise, PATTERN, flags=flags)
    out["find_ms_no_board"] = (time.perf_counter() - t0) * 1e3
    out["found_in_noise"] = bool(found_noise)
    views = [render_board(board_pose(0.5 + 0.08 * i, 0.25 + 0.12 * i, -0.25 + 0.12 * i,
                                     -0.06 + 0.02 * i, -0.04 + 0.015 * i), 0.0302)
             for i in range(6)]
    obj = np.zeros((PATTERN[0] * PATTERN[1], 3), np.float32)
    obj[:, :2] = np.mgrid[0:PATTERN[0], 0:PATTERN[1]].T.reshape(-1, 2) * 0.0302
    obj_pts, img_pts = [], []
    for v in views:
        f, c = cv2.findChessboardCorners(v, PATTERN)
        if f:
            obj_pts.append(obj)
            img_pts.append(c.reshape(-1, 2).astype(np.float32))
    out["calib_views_found"] = len(obj_pts)
    if len(obj_pts) >= 3:
        rms, K, _, _, _ = cv2.calibrateCamera(obj_pts, img_pts, (W, H), None, None,
                                              flags=cv2.CALIB_FIX_K3 | cv2.CALIB_ZERO_TANGENT_DIST)
        out["calib_rms_px"] = float(rms)
        out["calib_fx"] = float(K[0, 0])
    return out


def probe_pinned_copy():
    dev = torch.device("cuda", 0)
    x = torch.arange(1 << 22, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))  # keep the stream busy for tens of ms
    y = x * 2.0
    host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
    host.copy_(y, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    first = ev.query()
    t0 = time.perf_counter()
    polls = 0
    while not ev.query():
        polls += 1
        time.sleep(1e-4)
    wait_ms = (time.perf_counter() - t0) * 1e3
    ok = bool(torch.equal(host, torch.arange(1 << 22, dtype=torch.float32) * 2.0))
    z = y.to("cpu", non_blocking=True)
    return {"query_before": bool(first), "query_after": True, "polls": polls,
            "wait_ms": wait_ms, "values_equal": ok, "is_pinned": bool(host.is_pinned()),
            "to_cpu_non_blocking_is_pinned": bool(z.is_pinned())}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_frontends: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip().splitlines()[0], flush=True)
    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = None
    print(json.dumps({"torch": torch.__version__, "card": torch.cuda.get_device_name(0),
                      "matplotlib": probe_matplotlib(), "cv2": probe_cv2(),
                      "pinned_copy": probe_pinned_copy(),
                      "dev_video0": os.path.exists("/dev/video0"), "pil": pil}), flush=True)


if __name__ == "__main__":
    main()
