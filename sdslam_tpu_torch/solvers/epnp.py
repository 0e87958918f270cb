"""EPnP: pose from n 3D-2D correspondences via control points, inside a
batched RANSAC (port of sdslam_tpu/solvers/epnp.py).

Every function takes a leading hypothesis axis on its mask, which replaces
the JAX package's jax.vmap over hypotheses. Eigenvector signs differ
between libraries; the recovered pose does not depend on them (the beta
cases and the positive-depth flip absorb the sign).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sdslam_tpu_torch._util import take
from sdslam_tpu_torch.geometry.camera import CameraModel
from sdslam_tpu_torch.solvers.sim3_solver import _onehot_sets, sample_sets, umeyama_sim3


class PnPResult(NamedTuple):
    success: torch.Tensor
    R: torch.Tensor  # [3,3]
    t: torch.Tensor  # [3]
    inliers: torch.Tensor  # [N]
    n_inliers: torch.Tensor


def _triu(x):
    """The 6 pairs (i < j) of a [...,4,4,...] pair array, row-major."""
    iu = torch.triu_indices(4, 4, 1, device=x.device)
    return x[..., iu[0], iu[1], :]


def _pair_dists(C):
    """[...,4,3] control points -> [...,6] pairwise distances."""
    return torch.linalg.norm(_triu(C[..., :, None, :] - C[..., None, :, :]), dim=-1)


def _control_points(Xw, w):
    """Centroid + principal-axis control points [...,4,3]."""
    wsum = torch.clamp(w.sum(-1), min=1e-6)
    c0 = (Xw * w[..., None]).sum(-2) / wsum[..., None]
    Xc = (Xw - c0[..., None, :]) * w[..., None]
    cov = torch.einsum("...ni,...nj->...ij", Xc, Xc) / wsum[..., None, None]
    lam, V = torch.linalg.eigh(cov)
    lam = torch.clamp(lam, min=1e-9)
    return torch.stack([c0] + [c0 + torch.sqrt(lam[..., k, None]) * V[..., :, k] for k in (2, 1, 0)],
                       dim=-2)


def _barycentric(Xw, C):
    B = torch.stack([C[..., 1, :] - C[..., 0, :], C[..., 2, :] - C[..., 0, :],
                     C[..., 3, :] - C[..., 0, :]], dim=-1)
    rhs = (Xw - C[..., 0, None, :]).transpose(-1, -2)
    a123 = torch.linalg.solve_ex(B + 1e-9 * torch.eye(3, device=Xw.device), rhs)[0]
    a123 = a123.transpose(-1, -2)
    return torch.cat([1.0 - a123.sum(-1, keepdim=True), a123], dim=-1)  # [...,N,4]


def _null_vectors(cam: CameraModel, alphas, uv, w):
    """The two smallest eigenvectors [...,4,3] of the 2n x 12 EPnP system."""
    N = uv.shape[0]
    zero = torch.zeros((N,), device=uv.device)
    row1 = torch.stack([torch.full((N,), cam.fx, device=uv.device), zero, cam.cx - uv[:, 0]], -1)
    row2 = torch.stack([zero, torch.full((N,), cam.fy, device=uv.device), cam.cy - uv[:, 1]], -1)
    r1 = torch.cat([alphas[..., j, None] * row1 for j in range(4)], -1)
    r2 = torch.cat([alphas[..., j, None] * row2 for j in range(4)], -1)
    M = torch.cat([r1 * w[..., None], r2 * w[..., None]], -2)
    _, V = torch.linalg.eigh(M.transpose(-1, -2) @ M)
    shp = V.shape[:-2] + (4, 3)
    return V[..., :, 0].reshape(shp), V[..., :, 1].reshape(shp)


def _reproj_err2(cam: CameraModel, Xw, uv, R, t):
    Xc = torch.einsum("...ij,nj->...ni", R, Xw) + t[..., None, :]
    zs = torch.clamp(Xc[..., 2], min=1e-6)
    u = cam.fx * Xc[..., 0] / zs + cam.cx
    v = cam.fy * Xc[..., 1] / zs + cam.cy
    return (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2, Xc[..., 2]


def _pose_from_controls(cam: CameraModel, Xw, uv, w, alphas, Cc):
    Xc = alphas @ Cc
    # positive depth (the null vector's sign is arbitrary)
    sign = torch.sign(torch.where(w > 0, Xc[..., 2], torch.zeros_like(w)).sum(-1))
    Xc = Xc * torch.where(sign == 0, torch.ones_like(sign), sign)[..., None, None]
    R, t, _ = umeyama_sim3(Xw, Xc, w > 0, fix_scale=True)
    err2, _ = _reproj_err2(cam, Xw, uv, R, t)
    n = torch.clamp((w > 0).sum(-1), min=1)
    return R, t, torch.where(w > 0, err2, torch.zeros_like(err2)).sum(-1) / n


def epnp(cam: CameraModel, Xw, uv, mask):
    """EPnP over the masked correspondences (mask [...,N]: one solve per
    leading index). Returns (R, t, mean squared reprojection error)."""
    w = mask.to(torch.float32)
    C = _control_points(Xw, w)
    alphas = _barycentric(Xw, C)
    v1, v2 = _null_vectors(cam, alphas, uv, w)
    dw = _pair_dists(C)
    # beta case 1: Cc = b v1
    d1 = _pair_dists(v1)
    b1 = (dw * d1).sum(-1) / torch.clamp((d1 * d1).sum(-1), min=1e-9)
    R_a, t_a, e_a = _pose_from_controls(cam, Xw, uv, w, alphas, b1[..., None, None] * v1)
    # beta case 2: Cc = b1 v1 + b2 v2 from [d1^2, 2 d12, d2^2] betas = dw^2
    dv1 = _triu(v1[..., :, None, :] - v1[..., None, :, :])
    dv2 = _triu(v2[..., :, None, :] - v2[..., None, :, :])
    L = torch.stack([(dv1 * dv1).sum(-1), 2 * (dv1 * dv2).sum(-1), (dv2 * dv2).sum(-1)], -1)
    # least squares by the SVD pseudo-inverse, as jnp.linalg.lstsq
    beta = (torch.linalg.pinv(L) @ (dw * dw)[..., None])[..., 0]
    bb1 = torch.sqrt(torch.clamp(beta[..., 0].abs(), min=1e-12))
    bb2 = torch.sign(beta[..., 1]) * torch.sqrt(torch.clamp(beta[..., 2].abs(), min=1e-12))
    Cc = bb1[..., None, None] * v1 + bb2[..., None, None] * v2
    R_b, t_b, e_b = _pose_from_controls(cam, Xw, uv, w, alphas, Cc)
    better_a = e_a <= e_b
    R = torch.where(better_a[..., None, None], R_a, R_b)
    t = torch.where(better_a[..., None], t_a, t_b)
    return R, t, torch.minimum(e_a, e_b)


def _inliers(cam: CameraModel, Xw, uv, valid, R, t, th_px: float):
    err2, z = _reproj_err2(cam, Xw, uv, R, t)
    return valid & (err2 < th_px**2) & (z > 0)


def ransac_epnp(cam: CameraModel, Xw, uv, valid, generator: Optional[torch.Generator] = None,
                sets=None, inlier_th_px: float = 5.99, n_hypotheses: int = 64,
                min_set: int = 6, min_inliers: int = 10) -> PnPResult:
    """EPnP on `n_hypotheses` minimal sets at once, the best by inlier
    count refit on its inliers. `sets` [H, min_set] overrides the draw."""
    N = Xw.shape[0]
    if sets is None:
        sets = sample_sets(valid, n_hypotheses, min_set, generator)
    m = _onehot_sets(sets, N) & valid
    Rs, ts, _ = epnp(cam, Xw, uv, m)
    counts = _inliers(cam, Xw, uv, valid, Rs, ts, inlier_th_px).sum(-1)
    best = torch.argmax(counts)
    inl = _inliers(cam, Xw, uv, valid, take(Rs, best), take(ts, best), inlier_th_px)
    R, t, _ = epnp(cam, Xw, uv, inl)
    inl = _inliers(cam, Xw, uv, valid, R, t, inlier_th_px)
    n = inl.sum()
    return PnPResult(n >= min_inliers, R, t, inl, n)
