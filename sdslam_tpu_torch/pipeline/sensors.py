"""EKF motion models (port of sdslam_tpu/pipeline/sensors.py).

  * The constant-velocity filter on the device (ekf_init / ekf_predict /
    ekf_update): state = body twist [v(3), w(3)]; predicted pose =
    Exp(x dt) last_pose; the measurement is the relative twist
    Log(T_meas last_pose^-1)/dt, innovation chi2 gated.
  * The 16-state IMU filter on the device (IMUState, imu_init /
    imu_predict / imu_update): state [x(3), q(4 wxyz), v(3), w(3), a(3)]
    of the camera pose Tcw, measurement [pose(7), gyro(3),
    accel-minus-gravity(3)], gravity tracked by a low-pass filter. The
    tracker runs it inside the frame step, so it fuses the current frame's
    tracked pose (the fusion sensor).
  * ConstantVelocityEKF: the constant-velocity filter in float64 numpy
    on the host (the EKF class of the reference, for callers that track
    poses on the host).
  * IMUStateEKF: the same 16-state filter in float64 numpy on the host,
    the facade's introspection mirror of the fusion sensor.

Every device function is sync-free: flags stay 0-d bool tensors.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
from scipy.spatial.transform import Rotation as _R

from sdslam_tpu_torch._device import resolve
from sdslam_tpu_torch._util import as_device
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


def ekf_init(T0=None, device="cuda") -> EKFState:
    """A fresh filter at T0 (on T0's device), or at the identity on
    `device` when no pose is given."""
    device = T0.device if T0 is not None else resolve(device)
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


# ---------------------------------------------------------------------------
# 16-state IMU filter on the device
# ---------------------------------------------------------------------------

# noise constants of the reference's IMU sensor model
COV_X2, COV_Q2, COV_V2, COV_W2, COV_A2 = 2.5e-3, 1e-5, 6.25e-4, 6.25e-4, 6.25e-4
SIGMA_X, SIGMA_Q, SIGMA_V, SIGMA_W = 0.05, 0.02, 4.0, 6.0
SIGMA_GYRO, SIGMA_ACC = 2.60, 8.94
GRAVITY_TAU = 0.27


class IMUState(NamedTuple):
    X: torch.Tensor  # [16]: x(3), q(4 wxyz), v(3), w(3), a(3) of the camera Tcw
    P: torch.Tensor  # [16,16]
    gravity: torch.Tensor  # [3] low-pass filtered accelerometer gravity
    updated: torch.Tensor  # bool: one update absorbed


def _diag_blocks(blocks, device):
    """diag of (size, value) runs; a value may be a 0-d tensor."""
    return torch.diag(torch.cat([as_device(v, torch.float32, device).expand(n)
                                 for n, v in blocks]))


def imu_init(device="cuda") -> IMUState:
    device = resolve(device)
    P = _diag_blocks(((3, COV_X2), (4, COV_Q2), (3, COV_V2), (3, COV_W2), (3, COV_A2)), device)
    X = _diag_blocks(((16, 1.0),), device)[3]  # the identity quaternion, fills only
    return IMUState(X=X, P=P, gravity=torch.zeros(3, device=device),
                    updated=torch.zeros((), dtype=torch.bool, device=device))


def _jquat_from_w(w):
    """Quaternion [w,x,y,z] from a rotation vector, branchless near 0."""
    a2 = torch.sum(w * w)
    a = torch.sqrt(torch.clamp(a2, min=1e-24))
    s = torch.where(a2 < 1e-12, 0.5 - a2 / 48.0, torch.sin(a / 2.0) / a)
    return torch.cat([torch.cos(a / 2.0)[None], s * w])


def _jquat_jac_left(q):
    """d(p (x) q)/dp for fixed q."""
    w, x, y, z = q
    return torch.stack([torch.stack(r) for r in (
        (w, -x, -y, -z), (x, w, z, -y), (y, -z, w, x), (z, y, -x, w))])


def _jquat_jac_right(q):
    """d(q (x) p)/dp for fixed q."""
    w, x, y, z = q
    return torch.stack([torch.stack(r) for r in (
        (w, -x, -y, -z), (x, w, -z, y), (y, z, w, -x), (z, -y, x, w))])


def _jdq_by_dw(q, w, dt):
    """d(q (x) exp(w dt))/dw: [4,3], branchless."""
    n2 = torch.sum(w * w)
    n = torch.sqrt(torch.clamp(n2, min=1e-24))
    small = n2 < 1e-12
    beta = n * dt / 2.0
    sb, cb = torch.sin(beta), torch.cos(beta)
    u = w / torch.where(small, torch.ones_like(n), n)
    eye = torch.eye(3, device=w.device)
    uu = u[:, None] * u[None, :]
    m_top = (-dt / 2.0) * sb * u
    sb_n = torch.where(small, dt / 2.0, sb / n)
    m_body = (dt / 2.0) * cb * uu + sb_n * (eye - uu)
    m_body = torch.where(small, eye * (dt / 2.0), m_body)
    return _jquat_jac_right(q) @ torch.cat([m_top[None, :], m_body], 0)


def _jvec7_to_pose(v):
    T = torch.eye(4, device=v.device)
    T[:3, :3] = lie.quat_to_mat(lie.quat_normalize(v[3:7]))
    T[:3, 3] = v[:3]
    return T


def _jpose_to_vec7(T):
    return torch.cat([T[:3, 3], lie.mat_to_quat(T[:3, :3])])


def imu_predict(s: IMUState, dt):
    """Propagate; returns (state, predicted camera Tcw). Before the first
    update dt is treated as 0."""
    dt = torch.where(s.updated, torch.clamp(torch.as_tensor(dt, device=s.X.device), min=0.0),
                     0.0)
    X = s.X
    q, w = X[3:7], X[10:13]
    dq = _jdq_by_dw(q, w, dt)
    eye3 = torch.eye(3, device=X.device)
    jF = torch.eye(16, device=X.device)
    jF[0:3, 7:10] = eye3 * dt
    jF[7:10, 13:16] = eye3 * dt
    jF[3:7, 3:7] = _jquat_jac_left(_jquat_from_w(w * dt))
    jF[3:7, 10:13] = dq
    # process noise G Pn G^T
    Pn = _diag_blocks(((3, (SIGMA_V * dt) ** 2), (3, (SIGMA_W * dt) ** 2),
                       (3, (SIGMA_ACC * dt) ** 2)), X.device)
    G = torch.zeros((16, 9), device=X.device)
    G[0:3, 0:3] = eye3 * dt
    G[7:10, 0:3] = eye3
    G[7:10, 6:9] = eye3 * dt
    G[10:13, 3:6] = eye3
    G[13:16, 6:9] = eye3
    G[3:7, 3:6] = dq
    Q = G @ Pn @ G.T
    # x += v dt; q (x)= exp(w dt); v += a dt
    Xn = X.clone()
    Xn[0:3] = X[0:3] + X[7:10] * dt
    Xn[3:7] = lie.quat_mul(q, _jquat_from_w(w * dt))
    Xn[7:10] = X[7:10] + X[13:16] * dt
    P = jF @ s.P @ jF.T + Q
    return s._replace(X=Xn, P=P), _jvec7_to_pose(Xn[:7])


def imu_update(s: IMUState, Tcw, gyro, accel, dt, ok) -> IMUState:
    """Fuse the current frame's tracked pose and the raw IMU sample when
    `ok` (a 0-d bool tensor). The first measurement seeds the state."""
    dt = torch.clamp(torch.as_tensor(dt, device=s.X.device), min=1e-4)
    alpha = GRAVITY_TAU / (GRAVITY_TAU + dt)
    gravity = torch.where(s.updated, alpha * s.gravity + (1 - alpha) * accel, accel)
    z = torch.cat([_jpose_to_vec7(Tcw), gyro, accel - gravity])
    # hemisphere-align the measured quaternion against the state
    flip = torch.sum(z[3:7] * s.X[3:7]) < 0
    z = torch.cat([z[0:3], z[3:7] * torch.where(flip, -1.0, 1.0), z[7:]])
    h = torch.cat([s.X[0:7], s.X[10:13], s.X[13:16]])
    jH = torch.zeros((13, 16), device=s.X.device)
    jH[0:7, 0:7] = torch.eye(7, device=s.X.device)
    jH[7:10, 10:13] = torch.eye(3, device=s.X.device)
    jH[10:13, 13:16] = torch.eye(3, device=s.X.device)
    Rm = _diag_blocks(((3, (SIGMA_X * dt) ** 2), (4, (SIGMA_Q * dt) ** 2),
                       (3, (SIGMA_GYRO * dt) ** 2), (3, (SIGMA_ACC * dt) ** 2)), s.X.device)
    y = z - h
    S = jH @ s.P @ jH.T + Rm
    Kg = s.P @ jH.T @ torch.linalg.inv_ex(S)[0]
    Xn = s.X + Kg @ y
    Pn = s.P - Kg @ S @ Kg.T
    Xn = torch.cat([Xn[0:3], lie.quat_normalize(Xn[3:7]), Xn[7:]])
    X_seed = torch.cat([z[0:7], torch.zeros(9, device=s.X.device)])
    X_out = torch.where(s.updated, Xn, X_seed)
    P_out = torch.where(s.updated, Pn, s.P)
    return IMUState(
        X=torch.where(ok, X_out, s.X),
        P=torch.where(ok, P_out, s.P),
        gravity=torch.where(ok, gravity, s.gravity),
        updated=s.updated | ok,
    )


# ---------------------------------------------------------------------------
# The constant-velocity filter in float64 numpy on the host
# ---------------------------------------------------------------------------


def _np_se3_exp(xi: np.ndarray) -> np.ndarray:
    rho, phi = xi[:3], xi[3:]
    R = _R.from_rotvec(phi).as_matrix()
    th2 = float(phi @ phi)
    K = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]])
    if th2 < 1e-10:
        V = np.eye(3) + 0.5 * K
    else:
        th = np.sqrt(th2)
        V = np.eye(3) + (1 - np.cos(th)) / th2 * K + (th - np.sin(th)) / (th2 * th) * (K @ K)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T


def _np_se3_log(T: np.ndarray) -> np.ndarray:
    phi = _R.from_matrix(T[:3, :3]).as_rotvec()
    th2 = float(phi @ phi)
    K = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]])
    if th2 < 1e-10:
        Vinv = np.eye(3) - 0.5 * K
    else:
        th = np.sqrt(th2)
        half = 0.5 * th
        cot = half * np.cos(half) / np.sin(half)
        Vinv = np.eye(3) - 0.5 * K + (1 - cot) / th2 * (K @ K)
    return np.concatenate([Vinv @ T[:3, 3], phi])


@dataclasses.dataclass
class ConstantVelocityEKF:
    """Constant-velocity EKF over the body twist (EKF.cc): predicted pose =
    Exp(x dt) last_pose, measurement = Log(T_meas last_pose^-1) / dt."""

    sigma_a: float = SIGMA_A  # twist random walk (m/s^2)
    sigma_alpha: float = SIGMA_ALPHA  # rad/s^2
    sigma_v_meas: float = SIGMA_V_MEAS  # m/s
    sigma_w_meas: float = SIGMA_W_MEAS  # rad/s

    x: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(6))
    P: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(6) * 1e2)
    last_pose: Optional[np.ndarray] = None  # [4,4] Tcw
    started: bool = False

    def restart(self):
        """EKF::Restart (on tracking failure or relocalization)."""
        self.x = np.zeros(6)
        self.P = np.eye(6) * 1e2
        self.last_pose = None
        self.started = False

    def predict(self, dt: float) -> Optional[np.ndarray]:
        """Returns the predicted Tcw (None before the first update)."""
        if not self.started or self.last_pose is None:
            return None
        Q = np.diag([self.sigma_a**2] * 3 + [self.sigma_alpha**2] * 3) * max(dt, 1e-4) ** 2
        self.P = self.P + Q
        return (_np_se3_exp(self.x * dt) @ self.last_pose).astype(np.float32)

    def update(self, T_meas: np.ndarray, dt: float) -> bool:
        """Fuse a tracked pose. Returns False if the chi2 gate rejects it
        (the pose is then not absorbed into the velocity)."""
        T_meas = np.asarray(T_meas, np.float32)
        if self.last_pose is None:
            self.last_pose = T_meas
            return True
        dt = max(dt, 1e-4)
        rel = T_meas @ np.linalg.inv(self.last_pose)
        z = _np_se3_log(rel.astype(np.float64)) / dt
        R = np.diag([self.sigma_v_meas**2] * 3 + [self.sigma_w_meas**2] * 3) / dt**2 * dt**2
        y = z - self.x
        S = self.P + R
        m2 = float(y @ np.linalg.solve(S, y))
        if self.started and m2 > CHI2_GATE_6DOF * 10:
            return False
        K = self.P @ np.linalg.inv(S)
        self.x = self.x + K @ y
        self.P = (np.eye(6) - K) @ self.P
        self.last_pose = T_meas
        self.started = True
        return True


# ---------------------------------------------------------------------------
# The same 16-state filter in float64 numpy on the host
# ---------------------------------------------------------------------------


def _quat_mul(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Hamilton product, [w,x,y,z] convention."""
    pw, px, py, pz = p
    qw, qx, qy, qz = q
    return np.array([
        pw * qw - px * qx - py * qy - pz * qz,
        pw * qx + px * qw + py * qz - pz * qy,
        pw * qy - px * qz + py * qw + pz * qx,
        pw * qz + px * qy - py * qx + pz * qw,
    ])


def _quat_from_w(w: np.ndarray) -> np.ndarray:
    """Quaternion from a rotation vector."""
    angle = float(np.linalg.norm(w))
    if angle <= 0.0:
        return np.array([1.0, 0.0, 0.0, 0.0])
    s = np.sin(angle / 2.0) / angle
    return np.array([np.cos(angle / 2.0), s * w[0], s * w[1], s * w[2]])


def _quat_jac_left(q: np.ndarray) -> np.ndarray:
    """d(p (x) q)/dp for fixed q: 4x4."""
    w, x, y, z = q
    return np.array([[w, -x, -y, -z], [x, w, z, -y], [y, -z, w, x], [z, y, -x, w]])


def _quat_jac_right(q: np.ndarray) -> np.ndarray:
    """d(q (x) p)/dp for fixed q: 4x4."""
    w, x, y, z = q
    return np.array([[w, -x, -y, -z], [x, w, -z, y], [y, z, w, -x], [z, -y, x, w]])


def _dq_by_dw(q: np.ndarray, w: np.ndarray, dt: float) -> np.ndarray:
    """d(q (x) exp(w dt))/dw: 4x3."""
    n = float(np.linalg.norm(w))
    if n == 0.0:
        return np.vstack([np.zeros((1, 3)), np.eye(3) * (dt / 2.0)])
    beta = n * dt / 2.0
    sb, cb = np.sin(beta), np.cos(beta)
    u = w / n
    m = np.zeros((4, 3))
    m[0] = (-dt / 2.0) * sb * u
    for i in range(3):
        for j in range(3):
            if i == j:
                m[i + 1, j] = (dt / 2.0) * cb * u[i] * u[i] + (sb / n) * (1.0 - u[i] * u[i])
            else:
                m[i + 1, j] = u[i] * u[j] * ((dt / 2.0) * cb - sb / n)
    return _quat_jac_right(q) @ m


def _pose_to_vec7(T: np.ndarray) -> np.ndarray:
    """[t(3), q(4 wxyz)] from a 4x4 pose."""
    q = _R.from_matrix(np.asarray(T, float)[:3, :3]).as_quat()  # xyzw
    return np.concatenate([np.asarray(T, float)[:3, 3], [q[3], q[0], q[1], q[2]]])


def _vec7_to_pose(v: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    w, x, y, z = v[3:7]
    T[:3, :3] = _R.from_quat([x, y, z, w]).as_matrix()
    T[:3, 3] = v[:3]
    return T


class IMUStateEKF:
    """The 16-state IMU filter in float64 on the host: state [x(3), q(4
    wxyz), v(3), w(3), a(3)], measurement [pose(7), gyro(3),
    accel-minus-gravity(3)], gravity low-pass alpha = 0.27/(0.27 + dt)."""

    def __init__(self):
        self.restart()

    def restart(self):
        self.X = np.zeros(16)
        self.X[3] = 1.0  # identity quaternion
        self.P = np.zeros((16, 16))
        self.P[0:3, 0:3] = np.eye(3) * COV_X2
        self.P[3:7, 3:7] = np.eye(4) * COV_Q2
        self.P[7:10, 7:10] = np.eye(3) * COV_V2
        self.P[10:13, 10:13] = np.eye(3) * COV_W2
        self.P[13:16, 13:16] = np.eye(3) * COV_A2
        self.gravity = np.zeros(3)
        self.updated = False

    def _F(self, X: np.ndarray, dt: float) -> np.ndarray:
        """x += v dt; q (x)= exp(w dt); v += a dt."""
        Xn = X.copy()
        Xn[0:3] = X[0:3] + X[7:10] * dt
        Xn[3:7] = _quat_mul(X[3:7], _quat_from_w(X[10:13] * dt))
        Xn[7:10] = X[7:10] + X[13:16] * dt
        return Xn

    def _jF(self, X: np.ndarray, dt: float) -> np.ndarray:
        J = np.eye(16)
        J[0:3, 7:10] = np.eye(3) * dt
        J[7:10, 13:16] = np.eye(3) * dt
        J[3:7, 3:7] = _quat_jac_left(_quat_from_w(X[10:13] * dt))
        J[3:7, 10:13] = _dq_by_dw(X[3:7], X[10:13], dt)
        return J

    def _Q(self, X: np.ndarray, dt: float) -> np.ndarray:
        """Process noise G Pn G^T."""
        Pn = np.zeros((9, 9))
        Pn[0:3, 0:3] = np.eye(3) * (SIGMA_V * dt) ** 2
        Pn[3:6, 3:6] = np.eye(3) * (SIGMA_W * dt) ** 2
        Pn[6:9, 6:9] = np.eye(3) * (SIGMA_ACC * dt) ** 2
        G = np.zeros((16, 9))
        G[0:3, 0:3] = np.eye(3) * dt
        G[7:10, 0:3] = np.eye(3)
        G[7:10, 6:9] = np.eye(3) * dt
        G[10:13, 3:6] = np.eye(3)
        G[13:16, 6:9] = np.eye(3)
        G[3:7, 3:6] = _dq_by_dw(X[3:7], X[10:13], dt)
        return G @ Pn @ G.T

    def _R_meas(self, dt: float) -> np.ndarray:
        Rm = np.zeros((13, 13))
        Rm[0:3, 0:3] = np.eye(3) * (SIGMA_X * dt) ** 2
        Rm[3:7, 3:7] = np.eye(4) * (SIGMA_Q * dt) ** 2
        Rm[7:10, 7:10] = np.eye(3) * (SIGMA_GYRO * dt) ** 2
        Rm[10:13, 10:13] = np.eye(3) * (SIGMA_ACC * dt) ** 2
        return Rm

    def predict(self, dt: float) -> np.ndarray:
        """Propagate; returns the predicted camera pose. Before the first
        update dt is treated as 0."""
        if not self.updated:
            dt = 0.0
        dt = max(dt, 0.0)
        jF = self._jF(self.X, dt)
        Q = self._Q(self.X, dt)
        self.X = self._F(self.X, dt)
        self.P = jF @ self.P @ jF.T + Q
        return _vec7_to_pose(self.X[:7])

    def update(self, pose: np.ndarray, gyro, accel, dt: float):
        """Fuse a tracked pose and the raw IMU sample; the first
        measurement seeds the state."""
        dt = max(dt, 1e-4)
        alpha = GRAVITY_TAU / (GRAVITY_TAU + dt)
        accel = np.asarray(accel, float)
        if not self.updated:
            self.gravity = accel.copy()
        else:
            self.gravity = alpha * self.gravity + (1 - alpha) * accel
        z = np.concatenate([_pose_to_vec7(pose), np.asarray(gyro, float), accel - self.gravity])
        if not self.updated:
            self.X[:] = 0.0
            self.X[0:7] = z[0:7]
            self.updated = True
            return
        # q and -q are one rotation: align the measured quaternion's sign
        if np.dot(z[3:7], self.X[3:7]) < 0:
            z[3:7] = -z[3:7]
        h = np.concatenate([self.X[0:7], self.X[10:13], self.X[13:16]])
        jH = np.zeros((13, 16))
        jH[0:7, 0:7] = np.eye(7)
        jH[7:10, 10:13] = np.eye(3)
        jH[10:13, 13:16] = np.eye(3)
        Rm = self._R_meas(dt)
        y = z - h
        S = jH @ self.P @ jH.T + Rm
        K = self.P @ jH.T @ np.linalg.inv(S)
        self.X = self.X + K @ y
        self.P = self.P - K @ S @ K.T
        n = np.linalg.norm(self.X[3:7])
        if n > 1e-9:
            self.X[3:7] /= n

    def angular_rate(self) -> np.ndarray:
        return self.X[10:13].copy()

    def pose(self) -> np.ndarray:
        return _vec7_to_pose(self.X[:7])
