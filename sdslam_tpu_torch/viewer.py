"""Headless visualization and AR plane fitting (port of sdslam_tpu/viewer.py).

Replaces the reference's Pangolin UI (src/ui/{Viewer,FrameDrawer,MapDrawer,
Plane}) with renders that need no display: the top-down map view and the
frame overlay are drawn with matplotlib (Agg) into PNG files or returned as
RGB arrays, and the AR plane RANSAC (FrameDrawer::DetectPlane) is numpy.

The map may live on any device: each render copies the fields it draws to
the host once (`.cpu()`), which waits for the work queued on their stream;
nothing here synchronizes the whole device. `matplotlib` is imported where
it is used.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sdslam_tpu_torch.mapping import map_state as M
from sdslam_tpu_torch.utils import metrics


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _figure(**kw):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt, plt.subplots(**kw)


def _finish(plt, fig, path, dpi):
    """Save to `path` (returns it) or return the figure as an RGB array."""
    if path:
        fig.savefig(path, dpi=dpi, bbox_inches="tight")
        plt.close(fig)
        return path
    fig.canvas.draw()
    arr = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return arr


def draw_map(ms: M.MapState, trajectory=None, path: Optional[str] = None,
             show_covisibility: bool = True, covis_min: int = 15):
    """Top-down (x-z) map view: points, keyframe positions, trajectory,
    covisibility edges, spanning tree and loop edges (the three graph
    layers of MapDrawer::DrawKeyFrames)."""
    plt, (fig, ax) = _figure(figsize=(7, 7))
    pts = _host(ms.pt_pos)[_host(ms.pt_valid)]
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=1, c="#333333", label="map points")
    kf_mask = _host(ms.kf_valid)
    all_centers = metrics.camera_centers(_host(ms.kf_Tcw))
    centers = all_centers[kf_mask]
    if len(centers):
        ax.scatter(centers[:, 0], centers[:, 2], s=40, marker="s", c="#1f77b4",
                   label="keyframes")
    if show_covisibility and kf_mask.sum() > 1:
        cov = _host(M.covisibility(ms))
        idx = np.flatnonzero(kf_mask)
        for a in idx:
            for b in idx:
                if b > a and cov[a, b] >= covis_min:
                    ca, cb = all_centers[a], all_centers[b]
                    ax.plot([ca[0], cb[0]], [ca[2], cb[2]], c="#aec7e8", lw=0.5)
    # spanning tree (green) and persistent loop edges (red)
    parent = _host(ms.kf_parent)
    for k in np.flatnonzero(kf_mask):
        p = parent[k]
        if p >= 0 and kf_mask[p]:
            ca, cb = all_centers[k], all_centers[p]
            ax.plot([ca[0], cb[0]], [ca[2], cb[2]], c="#2ca02c", lw=0.8)
    shown_loop = False
    for a, b in _host(ms.loop_edges):
        if a >= 0 and b >= 0 and kf_mask[a] and kf_mask[b]:
            ca, cb = all_centers[a], all_centers[b]
            ax.plot([ca[0], cb[0]], [ca[2], cb[2]], c="#d62728", lw=1.2,
                    label=None if shown_loop else "loop edge")
            shown_loop = True
    if trajectory is not None and len(trajectory):
        c = metrics.camera_centers(np.stack([_host(T) for T in trajectory]))
        ax.plot(c[:, 0], c[:, 2], c="#2ca02c", lw=1.5, label="trajectory")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_aspect("equal")
    return _finish(plt, fig, path, 120)


def draw_frame(img, uv, matched_mask=None, state_text: str = "", path: Optional[str] = None):
    """Current frame with its keypoints (FrameDrawer::DrawFrame)."""
    plt, (fig, ax) = _figure(figsize=(8, 6))
    ax.imshow(_host(img), cmap="gray", vmin=0, vmax=255)
    uv = _host(uv)
    if matched_mask is not None:
        mm = _host(matched_mask)
        ax.scatter(uv[~mm, 0], uv[~mm, 1], s=6, c="#d62728", marker="x")
        ax.scatter(uv[mm, 0], uv[mm, 1], s=8, facecolors="none", edgecolors="#2ca02c")
    else:
        ax.scatter(uv[:, 0], uv[:, 1], s=6, c="#2ca02c", marker="o")
    if state_text:
        ax.set_title(state_text, fontsize=10)
    ax.axis("off")
    return _finish(plt, fig, path, 110)


def detect_plane(points: np.ndarray, n_iters: int = 200, th: float = 0.02, seed: int = 0):
    """RANSAC plane fit over map points for AR placement
    (FrameDrawer::DetectPlane). Returns (normal, d, inlier_mask) with the
    plane n.x = d, or None if unsupported."""
    pts = np.asarray(points, np.float64)
    if len(pts) < 3:
        return None
    rng = np.random.default_rng(seed)
    best = (None, None, None, -1)
    for _ in range(n_iters):
        i = rng.choice(len(pts), 3, replace=False)
        a, b, c = pts[i]
        n = np.cross(b - a, c - a)
        nn = np.linalg.norm(n)
        if nn < 1e-9:
            continue
        n = n / nn
        d = float(n @ a)
        inl = np.abs(pts @ n - d) < th
        if inl.sum() > best[3]:
            best = (n, d, inl, int(inl.sum()))
    n, d, inl, cnt = best
    if n is None or cnt < max(10, 0.2 * len(pts)):
        return None
    # least-squares refinement on the inliers
    P = pts[inl]
    centroid = P.mean(0)
    _, _, Vt = np.linalg.svd(P - centroid)
    n = Vt[2]
    d = float(n @ centroid)
    return n.astype(np.float32), d, np.abs(pts @ n - d) < th


def status_text(state: str, n_kfs: int, n_pts: int, n_matches: int,
                localization_only: bool = False) -> str:
    """The reference UI's status line (FrameDrawer::DrawTextInfo)."""
    if state == "NOT_INITIALIZED":
        return "TRYING TO INITIALIZE"
    if state == "LOST":
        return "TRACK LOST. TRYING TO RELOCALIZE"
    mode = "LOCALIZATION | " if localization_only else "SLAM MODE | "
    return f"{mode}KFs: {n_kfs}, MPs: {n_pts}, Matches: {n_matches}"


def _plane_frame(plane, points=None):
    """Orthonormal frame anchored on a detected plane: origin = inlier
    centroid projected to the plane, e1 / e2 spanning it."""
    n, d, inl = plane
    n = np.asarray(n, np.float64)
    if points is not None and np.asarray(inl).sum() >= 3:
        c = np.asarray(points, np.float64)[np.asarray(inl)].mean(0)
    else:
        c = n * d
    origin = c - (n @ c - d) * n
    ref = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
    e1 = np.cross(n, ref)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n, e1)
    return origin, e1, e2, n


def draw_ar(img, cam, Tcw, plane, points=None, cube_size: float = 0.1, grid_half: int = 3,
            path: Optional[str] = None):
    """AR overlay: a cube standing on the detected plane and a grid on it,
    projected into the frame (FrameDrawer::DrawCube / DrawPlane)."""
    origin, e1, e2, n = _plane_frame(plane, points)
    T = _host(Tcw)
    R, t = T[:3, :3], T[:3, 3]

    def project(X):
        Xc = X @ R.T + t
        z = np.maximum(Xc[:, 2], 1e-6)
        return (np.stack([cam.fx * Xc[:, 0] / z + cam.cx, cam.fy * Xc[:, 1] / z + cam.cy], 1),
                Xc[:, 2] > 0.05)

    img = _host(img)
    plt, (fig, ax) = _figure(figsize=(8, 6))
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)
    s = cube_size
    for i in range(-grid_half, grid_half + 1):
        for (a, b) in ((origin + i * s * e1 - grid_half * s * e2,
                        origin + i * s * e1 + grid_half * s * e2),
                       (origin + i * s * e2 - grid_half * s * e1,
                        origin + i * s * e2 + grid_half * s * e1)):
            uv, ok = project(np.stack([a, b]))
            if ok.all():
                ax.plot(uv[:, 0], uv[:, 1], c="#1f77b4", lw=0.8, alpha=0.7)
    # the cube: base on the plane, extruded along -n (toward the camera side)
    up = -n * s
    base = [origin + sx * s / 2 * e1 + sy * s / 2 * e2
            for (sx, sy) in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
    uv, ok = project(np.stack(base + [b + up for b in base]))
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    for (a, b) in edges:
        if ok[a] and ok[b]:
            ax.plot(uv[[a, b], 0], uv[[a, b], 1], c="#2ca02c", lw=1.6)
    ax.axis("off")
    ax.set_xlim(0, img.shape[1])
    ax.set_ylim(img.shape[0], 0)
    return _finish(plt, fig, path, 110)
