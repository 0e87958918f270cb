"""The 16-state IMU filter of the port against sdslam_tpu's, on the cases of
tests/test_imu_ekf.py: the device filter (imu_init / imu_predict /
imu_update, float32) and the host mirror IMUStateEKF (float64) with its
helpers, within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdslam_tpu.pipeline import sensors as js
from sdslam_tpu_torch.pipeline import sensors as ts
from test_imu_ekf import _rot

TOL = 1e-5


def _rotation_stream(n=40, w=(0.0, 0.0, 0.6), dt=1.0 / 30.0):
    """tests/test_imu_ekf.py::test_filter_tracks_constant_rotation's
    measurements: (pose, gyro, accel, dt) per step, the first one seeding."""
    w = np.asarray(w)
    g_body = np.array([0.0, -9.81, 0.0])
    T = np.eye(4)
    out = [(T, w, g_body, dt)]
    for _ in range(n):
        v = js._pose_to_vec7(T)
        v[3:7] = js._quat_mul(v[3:7], js._quat_from_w(w * dt))
        T = js._vec7_to_pose(v)
        out.append((T, w, g_body, dt))
    return out


@pytest.mark.parametrize("what", ["vec7", "jF", "dq_by_dw"])
def test_host_helpers(what):
    rng = np.random.default_rng(3)
    if what == "vec7":
        T = _rot()
        np.testing.assert_allclose(ts._pose_to_vec7(T), js._pose_to_vec7(T), atol=TOL)
        v = js._pose_to_vec7(T)
        np.testing.assert_allclose(ts._vec7_to_pose(v), js._vec7_to_pose(v), atol=TOL)
    elif what == "jF":
        X = rng.normal(size=16) * 0.3
        X[3:7] /= np.linalg.norm(X[3:7])
        a, b = ts.IMUStateEKF(), js.IMUStateEKF()
        np.testing.assert_allclose(a._jF(X, 0.04), b._jF(X, 0.04), atol=TOL)
        np.testing.assert_allclose(a._F(X, 0.04), b._F(X, 0.04), atol=TOL)
        np.testing.assert_allclose(a._Q(X, 0.04), b._Q(X, 0.04), atol=TOL)
    else:
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        for w in (rng.normal(size=3), np.zeros(3)):
            np.testing.assert_allclose(ts._dq_by_dw(q, w, 0.05), js._dq_by_dw(q, w, 0.05),
                                       atol=TOL)
            dev = ts._jdq_by_dw(torch.tensor(q, dtype=torch.float32),
                                torch.tensor(w, dtype=torch.float32), torch.tensor(0.05))
            ref = js._jdq_by_dw(jnp.asarray(q, jnp.float32), jnp.asarray(w, jnp.float32), 0.05)
            np.testing.assert_allclose(dev.numpy(), np.asarray(ref), atol=TOL)


def test_host_filter_constant_rotation():
    """The host mirrors through the constant-rotation stream, then one
    more prediction; plus restart."""
    a, b = ts.IMUStateEKF(), js.IMUStateEKF()
    for T, w, g, dt in _rotation_stream():
        np.testing.assert_allclose(a.predict(dt), b.predict(dt), atol=TOL)
        a.update(T, w, g, dt)
        b.update(T, w, g, dt)
        np.testing.assert_allclose(a.X, b.X, atol=TOL)
        np.testing.assert_allclose(a.P, b.P, atol=TOL)
        np.testing.assert_allclose(a.gravity, b.gravity, atol=TOL)
    np.testing.assert_allclose(a.predict(1 / 30), b.predict(1 / 30), atol=TOL)
    np.testing.assert_allclose(a.angular_rate(), b.angular_rate(), atol=TOL)
    a.restart()
    assert not a.updated and np.allclose(a.X[3:7], [1, 0, 0, 0]) and np.allclose(a.gravity, 0)


@pytest.mark.parametrize("gate", ["every_step", "skip_odd"])
def test_device_filter_constant_rotation(gate):
    """imu_predict / imu_update on the same stream, float32 on both sides;
    with `skip_odd` every other update is masked off (ok = False), the
    tracker's frames without an IMU sample."""
    sj, st = js.imu_init(), ts.imu_init(device="cpu")
    for f in ("X", "P", "gravity"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)))
    for k, (T, w, g, dt) in enumerate(_rotation_stream()):
        ok = gate == "every_step" or k % 2 == 0
        sj, Tj = js.imu_predict(sj, jnp.float32(dt))
        st, Tt = ts.imu_predict(st, torch.tensor(dt, dtype=torch.float32))
        np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=TOL)
        args_j = (jnp.asarray(T, jnp.float32), jnp.asarray(w, jnp.float32),
                  jnp.asarray(g, jnp.float32), jnp.float32(dt), jnp.asarray(ok))
        args_t = (torch.tensor(T, dtype=torch.float32), torch.tensor(w, dtype=torch.float32),
                  torch.tensor(g, dtype=torch.float32), torch.tensor(dt, dtype=torch.float32),
                  torch.tensor(ok))
        sj = js.imu_update(sj, *args_j)
        st = ts.imu_update(st, *args_t)
        assert bool(st.updated) == bool(sj.updated)
        np.testing.assert_allclose(st.X.numpy(), np.asarray(sj.X), atol=TOL)
        np.testing.assert_allclose(st.gravity.numpy(), np.asarray(sj.gravity), atol=TOL)
        np.testing.assert_allclose(st.P.numpy(), np.asarray(sj.P), atol=TOL,
                                   rtol=TOL)
