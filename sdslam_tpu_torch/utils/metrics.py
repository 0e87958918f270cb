"""Trajectory evaluation: ATE / RPE (numpy; a jax-free copy of
sdslam_tpu/utils/metrics.py, which cannot be imported without JAX)."""

from __future__ import annotations

import numpy as np


def camera_centers(Tcw_list) -> np.ndarray:
    """[N,4,4] world->camera poses -> [N,3] camera centers in world."""
    T = np.asarray(Tcw_list)
    return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])


def umeyama(src, dst, with_scale=False):
    """Least-squares similarity src->dst. Returns (s, R, t)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / ((xs**2).sum() / len(src))) if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def ate_rmse(est_Tcw, gt_Tcw, align=True, with_scale=False) -> float:
    """Absolute trajectory RMSE (meters) after optional Umeyama alignment."""
    pe = camera_centers(est_Tcw)
    pg = camera_centers(gt_Tcw)
    if align:
        s, R, t = umeyama(pe, pg, with_scale)
        pe = (s * (R @ pe.T)).T + t
    err = np.linalg.norm(pe - pg, axis=1)
    return float(np.sqrt((err**2).mean()))


def rpe(est_Tcw, gt_Tcw, delta: int = 1):
    """Relative pose error over frame pairs (i, i+delta):
    (trans_rmse [m], rot_rmse [rad])."""
    est, gt = np.asarray(est_Tcw), np.asarray(gt_Tcw)
    terr, rerr = [], []
    for i in range(len(est) - delta):
        e = (est[i + delta] @ np.linalg.inv(est[i])) @ np.linalg.inv(
            gt[i + delta] @ np.linalg.inv(gt[i])
        )
        terr.append(np.linalg.norm(e[:3, 3]))
        rerr.append(np.arccos(np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)))
    return float(np.sqrt(np.mean(np.square(terr)))), float(np.sqrt(np.mean(np.square(rerr))))
