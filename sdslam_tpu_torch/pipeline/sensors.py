"""Constant-velocity EKF motion model (port of the device-resident filter in
sdslam_tpu/pipeline/sensors.py: ekf_init / ekf_predict / ekf_update).

State = body twist [v(3), w(3)]; predicted pose = Exp(x dt) last_pose; the
measurement is the relative twist Log(T_meas last_pose^-1)/dt, innovation
chi2 gated. The 16-state IMU filter is not ported yet (RGB-D runs without
IMU). Every function is sync-free: flags stay 0-d bool tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sdslam_tpu_torch.geometry import lie

CHI2_GATE_6DOF = 16.81
SIGMA_A = 1.0
SIGMA_ALPHA = 1.0
SIGMA_V_MEAS = 0.15
SIGMA_W_MEAS = 0.15


class EKFState(NamedTuple):
    x: torch.Tensor  # [6] twist (v, w)
    P: torch.Tensor  # [6,6] covariance
    last_pose: torch.Tensor  # [4,4] Tcw of the last accepted measurement
    started: torch.Tensor  # bool: one update absorbed
    has_pose: torch.Tensor  # bool: last_pose meaningful


def ekf_init(T0=None, device=None) -> EKFState:
    if T0 is not None:
        device = T0.device
    return EKFState(
        x=torch.zeros(6, device=device),
        P=torch.eye(6, device=device) * 1e2,
        last_pose=(T0.to(torch.float32).clone() if T0 is not None
                   else torch.eye(4, device=device)),
        started=torch.tensor(False, device=device),
        has_pose=torch.tensor(T0 is not None, device=device),
    )


def _diag6(a: float, b: float, device):
    return torch.diag(torch.cat([torch.full((3,), a, device=device),
                                 torch.full((3,), b, device=device)]))


def ekf_predict(s: EKFState, dt):
    """Returns (state, T_pred). Before the first update T_pred = last pose."""
    dt = torch.clamp(torch.as_tensor(dt, device=s.x.device), min=1e-4)
    P = s.P + _diag6(SIGMA_A**2, SIGMA_ALPHA**2, s.x.device) * dt * dt
    T_pred = torch.where(
        s.started, lie.se3_normalize(lie.se3_exp(s.x * dt) @ s.last_pose), s.last_pose
    )
    return s._replace(P=P), T_pred


def ekf_update(s: EKFState, T_meas, dt, ok) -> EKFState:
    """Fuse a tracked pose when `ok` (a 0-d bool tensor); innovation-gated."""
    dt = torch.clamp(torch.as_tensor(dt, device=s.x.device), min=1e-4)
    T_meas = T_meas.to(torch.float32)
    z = lie.se3_log(T_meas @ lie.se3_inv(s.last_pose)) / dt
    R = _diag6(SIGMA_V_MEAS**2, SIGMA_W_MEAS**2, s.x.device)
    y = z - s.x
    S = s.P + R
    m2 = y @ torch.linalg.solve_ex(S, y)[0]
    gated = s.started & (m2 > CHI2_GATE_6DOF * 10)
    K = s.P @ torch.linalg.inv_ex(S)[0]
    x_new = s.x + K @ y
    P_new = (torch.eye(6, device=s.x.device) - K) @ s.P
    seed_only = ok & ~s.has_pose
    accept = ok & s.has_pose & ~gated
    take_pose = ok & (~gated | ~s.started)
    return EKFState(
        x=torch.where(accept, x_new, s.x),
        P=torch.where(accept, P_new, s.P),
        last_pose=torch.where(take_pose | seed_only, T_meas, s.last_pose),
        started=s.started | accept,
        has_pose=s.has_pose | ok,
    )
