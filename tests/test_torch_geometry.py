"""Lie-group, camera and config parity between sdslam_tpu and the PyTorch
port on seeded random inputs (both sides float32 on the CPU)."""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdslam_tpu.geometry import camera as jcam
from sdslam_tpu.geometry import lie as jlie
from sdslam_tpu.utils import config as jcfg
from sdslam_tpu_torch.geometry import camera as tcam
from sdslam_tpu_torch.geometry import lie as tlie
from sdslam_tpu_torch.utils import config as tcfg

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# float32 Lie maps through trig and 3x3 products: a few ulps of 1.0
TOL = 1e-5


def _xi(rng, n, max_angle):
    """Tangents with rotation angles spread over [0, max_angle], plus the
    tiny-angle series branch."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = np.concatenate([rng.uniform(0, max_angle, n - 4), [0.0, 1e-6, 1e-3, max_angle]])
    rho = rng.normal(size=(n, 3)) * 0.5
    return np.concatenate([rho, axis * ang[:, None]], 1).astype(np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("fn", ["se3_exp", "se3_exp_log", "so3_exp", "hat", "inv_apply",
                                "normalize", "left_jacobians"])
def test_lie_parity(fn):
    rng = np.random.default_rng(11)
    xi = _xi(rng, 64, np.pi - 0.1)
    X = rng.normal(size=(64, 3)).astype(np.float32)
    jx, tx = jnp.asarray(xi), torch.from_numpy(xi)
    if fn == "se3_exp":
        _close(jlie.se3_exp(jx), tlie.se3_exp(tx))
    elif fn == "se3_exp_log":
        T = np.array(jlie.se3_exp(jx))
        _close(jlie.se3_log(jnp.asarray(T)), tlie.se3_log(torch.from_numpy(T)), 1e-4)
        # the port's log inverts its exp over the whole range
        np.testing.assert_allclose(tlie.se3_log(tlie.se3_exp(tx)).numpy(), xi, atol=1e-4)
    elif fn == "so3_exp":
        _close(jlie.so3_exp(jx[:, 3:]), tlie.so3_exp(tx[:, 3:]))
    elif fn == "hat":
        _close(jlie.hat(jx[:, :3]), tlie.hat(tx[:, :3]), 0)
    elif fn == "inv_apply":
        T = np.array(jlie.se3_exp(jx))
        jT, tT = jnp.asarray(T), torch.from_numpy(T)
        _close(jlie.se3_inv(jT), tlie.se3_inv(tT))
        _close(jlie.se3_apply(jT, jnp.asarray(X)), tlie.se3_apply(tT, torch.from_numpy(X)))
    elif fn == "normalize":
        T = np.array(jlie.se3_exp(jx))
        T[:, :3, :3] += rng.normal(size=(64, 3, 3)).astype(np.float32) * 1e-4
        _close(jlie.se3_normalize(jnp.asarray(T)), tlie.se3_normalize(torch.from_numpy(T)))
    elif fn == "left_jacobians":
        _close(jlie.so3_left_jacobian(jx[:, 3:]), tlie.so3_left_jacobian(tx[:, 3:]))
        _close(jlie.so3_left_jacobian_inv(jx[:, 3:]), tlie.so3_left_jacobian_inv(tx[:, 3:]))


def _sim3_xi(rng, n, max_angle):
    """Sim(3) tangents: the SE(3) spread of _xi plus sigma in [-0.5, 0.5],
    with the small-sigma series branch (|sigma| < 1e-5) on a quarter."""
    sigma = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    sigma[: n // 4] = rng.uniform(-5e-6, 5e-6, n // 4)
    return np.concatenate([_xi(rng, n, max_angle), sigma[:, None]], 1)


@pytest.mark.parametrize("fn", ["sim3_exp", "sim3_exp_log", "sim3_inv_apply", "se3_embed"])
def test_sim3_parity(fn):
    """Sim(3) against the JAX package over rotations up to 3 rad, with the
    small-angle and small-sigma branches: exp, inv and the decomposition
    within 2e-5 (entries up to s = e^0.5 ~ 1.6, a few float32 ulps), apply
    within 4e-5 (coordinates up to ~5); exp/log round trips within 1e-4 on
    both sides (float32 Strasdat coefficients)."""
    rng = np.random.default_rng(5)
    xi = _sim3_xi(rng, 64, 3.0)
    X = rng.normal(size=(64, 3)).astype(np.float32)
    jx, tx = jnp.asarray(xi), torch.from_numpy(xi)
    if fn == "sim3_exp":
        _close(jlie.sim3_exp(jx), tlie.sim3_exp(tx), 2e-5)
    elif fn == "sim3_exp_log":
        S = np.array(jlie.sim3_exp(jx))
        _close(jlie.sim3_log(jnp.asarray(S)), tlie.sim3_log(torch.from_numpy(S)), 1e-4)
        np.testing.assert_allclose(tlie.sim3_log(tlie.sim3_exp(tx)).numpy(), xi, atol=1e-4)
        np.testing.assert_allclose(np.asarray(jlie.sim3_log(jlie.sim3_exp(jx))), xi, atol=1e-4)
    elif fn == "sim3_inv_apply":
        S = np.array(jlie.sim3_exp(jx))
        jS, tS = jnp.asarray(S), torch.from_numpy(S)
        _close(jlie.sim3_inv(jS), tlie.sim3_inv(tS), 2e-5)
        _close(jlie.sim3_apply(jS, jnp.asarray(X)), tlie.sim3_apply(tS, torch.from_numpy(X)),
               4e-5)
        for a, b in zip(jlie.sim3_Rts(jS), tlie.sim3_Rts(tS)):
            _close(a, b, 2e-5)
    elif fn == "se3_embed":
        T = np.array(jlie.se3_exp(jx[:, :6]))
        _close(jlie.sim3_to_se3(jlie.se3_to_sim3(jnp.asarray(T))),
               tlie.sim3_to_se3(tlie.se3_to_sim3(torch.from_numpy(T))))


CAM_ARGS = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480,
                k1=0.262, k2=-0.953, p1=-0.0054, p2=0.0026, k3=1.163, bf=40.0)


@pytest.mark.parametrize("distorted", [False, True], ids=["pinhole", "radtan"])
def test_camera_parity(distorted):
    args = CAM_ARGS if distorted else {k: CAM_ARGS[k] for k in
                                        ("fx", "fy", "cx", "cy", "width", "height", "bf")}
    jc, tc = jcam.CameraModel(**args), tcam.CameraModel(**args)
    rng = np.random.default_rng(3)
    Xc = rng.uniform([-1, -1, -0.2], [1, 1, 4], size=(200, 3)).astype(np.float32)
    uv = rng.uniform([0, 0], [640, 480], size=(200, 2)).astype(np.float32)
    d = rng.uniform(-0.5, 4, size=200).astype(np.float32)
    for distort in (False, True):
        juv, jz = jcam.project(jc, jnp.asarray(Xc), distort=distort)
        tuv, tz = tcam.project(tc, torch.from_numpy(Xc), distort=distort)
        ok = np.abs(Xc[:, 2]) > 0.05  # projection of near-zero depth is unbounded
        np.testing.assert_allclose(np.asarray(juv)[ok], tuv.numpy()[ok], rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(np.asarray(jz), tz.numpy())
    _close(jcam.backproject(jc, jnp.asarray(uv), jnp.asarray(d), undistort=distorted),
           tcam.backproject(tc, torch.from_numpy(uv), torch.from_numpy(d), undistort=distorted),
           1e-4)
    # pixel coordinates ~300: float32 resolution is ~3e-5 px
    _close(jcam.undistort_pixels(jc, jnp.asarray(uv)),
           tcam.undistort_pixels(tc, torch.from_numpy(uv)), 1e-3)
    np.testing.assert_array_equal(np.asarray(jcam.in_image(jc, jnp.asarray(uv), 5.0)),
                                  tcam.in_image(tc, torch.from_numpy(uv), 5.0).numpy())
    _close(jcam.virtual_right(jc, jnp.asarray(uv[:, 0]), jnp.asarray(d)),
           tcam.virtual_right(tc, torch.from_numpy(uv[:, 0]), torch.from_numpy(d)), 1e-3)


@pytest.mark.parametrize("name", ["TUM1.yaml", "TUM2.yaml", "EuRoC.yaml", "Example.yaml",
                                  None])
def test_config_load_parity(name):
    path = None if name is None else str(ROOT / "configs" / name)
    a = dataclasses.asdict(jcfg.load_config(path))
    b = dataclasses.asdict(tcfg.load_config(path))
    a["camera"] = a["camera"]._asdict() if hasattr(a["camera"], "_asdict") else a["camera"]
    b["camera"] = b["camera"]._asdict() if hasattr(b["camera"], "_asdict") else b["camera"]
    assert a == b
