"""Pose-only Gauss-Newton on reprojection residuals (port of
sdslam_tpu/solvers/pose_opt.py). The whole solve runs in kernel K2
(kernels/pose_kernel.py): one launch on the card, the plain GN on the CPU."""

from __future__ import annotations

from typing import NamedTuple

import torch

from sdslam_tpu_torch._util import as_device
from sdslam_tpu_torch.geometry import lie
from sdslam_tpu_torch.geometry.camera import CameraModel
from sdslam_tpu_torch.kernels import pose_kernel as pk
from sdslam_tpu_torch.solvers.ba_const import (  # noqa: F401  (the JAX module's names)
    CHI2_MONO, CHI2_STEREO, HUBER_MONO, HUBER_STEREO,
)


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor  # [4,4]
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # int32
    chi2: torch.Tensor  # sum of final inlier chi2


def optimize_pose(
    cam: CameraModel,
    Tcw_init,
    X,  # [N,3] world points
    uv_obs,  # [N,2] undistorted observations
    inv_sigma2,  # [N]
    valid,  # [N] bool
    ur_obs=None,  # [N] virtual right coords (None: mono only)
    rounds: int = 4,
    iters_per_round: int = 10,
    T_prior=None,  # [4,4] pose prior (optional)
    prior_rot_info=0.0,  # 1/sigma^2 on rotation deviation (float or 0-d tensor)
    prior_trans_info=0.0,  # 1/sigma^2 on translation deviation
) -> PoseOptResult:
    """With T_prior set, adds the semi-direct pose-prior term."""
    dev = X.device
    N = X.shape[0]
    if ur_obs is None:
        ur_obs = torch.full((N,), -1.0, device=dev)
    edata = pk.pack_edges(X, uv_obs, ur_obs, inv_sigma2, valid, ur_obs >= 0).contiguous()
    has_prior = T_prior is not None
    Tp_inv = lie.se3_inv(T_prior) if has_prior else torch.eye(4, device=dev)
    info = torch.stack([as_device(prior_rot_info, torch.float32, dev),
                        as_device(prior_trans_info, torch.float32, dev)])
    T, inl, n_inl, chi2 = pk.pose_optimize(
        edata, Tcw_init.to(torch.float32).contiguous(), Tp_inv.contiguous(), info,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
        rounds=rounds, iters=iters_per_round, has_prior=has_prior,
    )
    # ~40 chained 4x4 f32 products per frame drift off SO(3): renormalize
    return PoseOptResult(lie.se3_normalize(T), inl, n_inl, chi2)
