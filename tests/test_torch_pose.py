"""Pose-only GN: the port's optimize_pose (kernel K2's plain version on the
CPU) against sdslam_tpu's optimize_pose(fused=False), with and without a
pose prior, including prior deviations past the 0.5 rad range of the TPU
kernel's series log; and the views the K2 wrapper returns of the kernel's
output buffer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdslam_tpu.geometry import camera as jcam
from sdslam_tpu.geometry import lie as jlie
from sdslam_tpu.solvers import pose_opt as jpo
from sdslam_tpu_torch.geometry.camera import CameraModel as TCam
from sdslam_tpu_torch.kernels import pose_kernel as pk
from sdslam_tpu_torch.solvers import pose_opt as tpo

torch.set_num_threads(2)

CAM_ARGS = dict(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320, height=240, bf=32.0)
JC, TC = jcam.CameraModel(**CAM_ARGS), TCam(**CAM_ARGS)


def _problem(seed, n=512):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1.5, -1.0, 1.0], [1.5, 1.0, 3.5], size=(n, 3)).astype(np.float32)
    xi = np.array([0.05, -0.02, 0.03, 0.02, -0.04, 0.01], np.float32)
    T_gt = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    uv, z = jcam.project(JC, jlie.se3_apply(jnp.asarray(T_gt), jnp.asarray(X)))
    uv = np.array(uv) + rng.normal(size=(n, 2)).astype(np.float32) * 0.5
    out = rng.uniform(size=n) < 0.1
    uv[out] += 25.0
    stereo = rng.uniform(size=n) < 0.7
    ur = np.where(stereo, uv[:, 0] - CAM_ARGS["bf"] / np.asarray(z), -1.0).astype(np.float32)
    octave = rng.integers(0, 4, size=n)
    isig = (1.0 / 2.0 ** (2.0 * octave)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.85
    init = np.array([0.03, 0.02, -0.02, 0.01, 0.01, -0.02], np.float32)
    T_init = np.asarray(jlie.se3_exp(jnp.asarray(init))) @ T_gt
    return X, uv, ur, isig, valid, T_init, T_gt


# rotation axis of the prior's deviation from the true pose (unit length)
AXIS = np.array([1.0, -0.3, 0.2]) / np.sqrt(1.13)


@pytest.mark.parametrize("prior_rot", [None, 0.05, 0.7, 1.2, np.pi - 0.1],
                         ids=["no_prior", "prior_0.05rad", "prior_0.7rad", "prior_1.2rad",
                              "prior_pi-0.1rad"])
def test_optimize_pose_matches_xla(prior_rot):
    X, uv, ur, isig, valid, T_init, T_gt = _problem(5)
    kw_j, kw_t = {}, {}
    if prior_rot is not None:
        dev = np.concatenate([[0.02, -0.01, 0.03], prior_rot * AXIS]).astype(np.float32)
        T_prior = np.asarray(jlie.se3_exp(jnp.asarray(dev))) @ T_gt
        # weak enough that the reprojection edges still dominate, strong
        # enough that the full-range log moves the answer
        kw_j = dict(T_prior=jnp.asarray(T_prior), prior_rot_info=50.0, prior_trans_info=20.0)
        kw_t = dict(T_prior=torch.from_numpy(T_prior), prior_rot_info=50.0,
                    prior_trans_info=20.0)
    a = jpo.optimize_pose(JC, jnp.asarray(T_init), jnp.asarray(X), jnp.asarray(uv),
                          jnp.asarray(isig), jnp.asarray(valid), ur_obs=jnp.asarray(ur),
                          rounds=2, iters_per_round=5, fused=False, **kw_j)
    b = tpo.optimize_pose(TC, torch.from_numpy(T_init), torch.from_numpy(X),
                          torch.from_numpy(uv), torch.from_numpy(isig), torch.from_numpy(valid),
                          ur_obs=torch.from_numpy(ur), rounds=2, iters_per_round=5, **kw_t)
    # 10 GN steps with float32 normal equations; LU (JAX) vs LU here
    np.testing.assert_allclose(np.asarray(a.Tcw), b.Tcw.numpy(), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(a.inliers), b.inliers.numpy())
    assert int(a.n_inliers) == int(b.n_inliers)
    np.testing.assert_allclose(float(a.chi2), float(b.chi2), rtol=1e-3)


def test_mono_only_edges():
    X, uv, _, isig, valid, T_init, _ = _problem(9)
    a = jpo.optimize_pose(JC, jnp.asarray(T_init), jnp.asarray(X), jnp.asarray(uv),
                          jnp.asarray(isig), jnp.asarray(valid), rounds=4, iters_per_round=10,
                          fused=False)
    b = tpo.optimize_pose(TC, torch.from_numpy(T_init), torch.from_numpy(X),
                          torch.from_numpy(uv), torch.from_numpy(isig), torch.from_numpy(valid),
                          rounds=4, iters_per_round=10)
    np.testing.assert_allclose(np.asarray(a.Tcw), b.Tcw.numpy(), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(a.inliers), b.inliers.numpy())


def test_kernel_output_views_contract():
    """The views the K2 wrapper makes of the kernel's one output buffer
    have the plain version's types and shapes, without a copy: T [4,4] f32
    (the kernel writes the bottom row [0, 0, 0, 1]), the inlier mask [N]
    bool, n_inliers 0-d int32 and chi2 0-d f32."""
    X, uv, ur, isig, valid, T_init, _ = _problem(3, n=64)
    edata = pk.pack_edges(*(torch.from_numpy(a) for a in (X, uv, ur, isig, valid)),
                          torch.from_numpy(ur >= 0))
    eye = torch.eye(4)
    plain = pk.pose_optimize_plain(edata, torch.from_numpy(T_init), eye, torch.zeros(2),
                                   *(CAM_ARGS[k] for k in ("fx", "fy", "cx", "cy", "bf")),
                                   rounds=2, iters=5, has_prior=False)
    Tp, mp, n_p, cp = plain
    N = X.shape[0]
    # the bytes the kernel writes for these results
    out = torch.zeros(pk.OUT_HEAD + N, dtype=torch.uint8)
    head = out[:pk.OUT_HEAD]
    head.view(torch.float32)[:16] = Tp.reshape(-1)
    head.view(torch.float32)[16] = cp
    head.view(torch.int32)[17] = n_p
    out[pk.OUT_HEAD:] = mp.to(torch.uint8)
    views = pk._views(out, N)
    for v, p in zip(views, plain):
        assert (v.dtype, v.shape) == (p.dtype, p.shape)
        assert torch.equal(v, p)
        assert v.untyped_storage().data_ptr() == out.untyped_storage().data_ptr()  # no copy
    assert torch.equal(Tp[3], torch.tensor([0.0, 0.0, 0.0, 1.0]))
