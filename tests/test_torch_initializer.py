"""The monocular two-view bootstrap of the port against sdslam_tpu's, on the
cases of tests/test_initializer.py (general scene, planar scene, 20%
outliers, pure rotation), both sides fed the same RANSAC samples (the JAX
solver's own jax.random.choice draw from its key), and the initialization
window search, exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdslam_tpu.features import matching as jm
from sdslam_tpu.solvers import initializer as ji
from sdslam_tpu_torch.features import matching as tm
from sdslam_tpu_torch.geometry.camera import CameraModel as TCam
from sdslam_tpu_torch.solvers import initializer as ti
from test_initializer import CAM as JCAM
from test_initializer import make_pair, project
from test_torch_matching import _desc, _flip, _t
from test_torch_mono import _jax_draw

torch.set_num_threads(2)

TCAM = TCam(*JCAM)
CASES = {
    "general": dict(seed=0, key=0, kw={}),
    "planar": dict(seed=1, key=1, kw=dict(planar=True)),
    "outliers": dict(seed=2, key=2, kw=dict(n_out=50)),
    "pure_rotation": dict(seed=3, key=3, kw=None),
}


def _pure_rotation(rng):
    """tests/test_initializer.py::test_pure_rotation_rejected's input."""
    from sdslam_tpu.geometry import lie

    n = 200
    X = rng.uniform([-1.2, -0.9, 1.5], [1.2, 0.9, 3.5], size=(n, 3)).astype(np.float32)
    R = np.asarray(lie.so3_exp(jnp.asarray(np.array([0.0, 0.08, 0.0], np.float32))))
    uv1 = project(X)
    uv2 = project(X @ R.T)
    ok = (uv2[:, 0] > 0) & (uv2[:, 0] < 320) & (uv2[:, 1] > 0) & (uv2[:, 1] < 240)
    return uv1, uv2, ok


@pytest.mark.parametrize("case", list(CASES))
def test_initialize_two_view_parity(case):
    """success and used_homography equal; R21 within 1e-4, t21 within 1e-3; the
    inlier sets equal up to 1%; the triangulated inliers within 1e-3
    relative (float32 SVDs from two LAPACK builds)."""
    c = CASES[case]
    rng = np.random.default_rng(c["seed"])
    if c["kw"] is None:
        uv1, uv2, valid = _pure_rotation(rng)
    else:
        uv1, uv2, valid, *_ = make_pair(rng, **c["kw"])
    key = jax.random.key(c["key"])
    rj = ji.initialize_two_view(JCAM, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid), key)
    samples = torch.from_numpy(np.asarray(_jax_draw(key, jnp.asarray(valid))).astype(np.int64))
    rt = ti.initialize_two_view(TCAM, torch.from_numpy(uv1), torch.from_numpy(uv2),
                                torch.from_numpy(valid), samples)
    assert bool(rt.success) == bool(rj.success)
    assert bool(rt.used_homography) == bool(rj.used_homography)
    if case == "pure_rotation":
        assert not bool(rt.success)
        return
    assert bool(rt.success)
    np.testing.assert_allclose(rt.R21.numpy(), np.asarray(rj.R21), atol=1e-4)
    # t21 at 1e-3 (ROADMAP.md section 3): on the F path both float32 solvers
    # sit 1.2e-4 to 5e-4 from a float64 solve of the same samples
    np.testing.assert_allclose(rt.t21.numpy(), np.asarray(rj.t21), atol=1e-3)
    inl_j, inl_t = np.asarray(rj.inliers), rt.inliers.numpy()
    assert (inl_j != inl_t).sum() <= 0.01 * inl_j.sum()
    both = inl_j & inl_t
    Xj, Xt = np.asarray(rj.X1)[both], rt.X1.numpy()[both]
    assert (np.linalg.norm(Xt - Xj, axis=1) / np.linalg.norm(Xj, axis=1)).max() < 1e-3


def test_search_for_initialization_exact():
    """Two frames' keypoints (some off level 0, some rotated descriptors and
    angles): the same f2 -> f1 assignment and distances."""
    rng = np.random.default_rng(7)
    n1, n2 = 300, 280
    uv1 = rng.uniform([0, 0], [320, 240], size=(n1, 2)).astype(np.float32)
    d1 = _desc(rng, n1)
    src = rng.integers(0, n1, n2)
    uv2 = (uv1[src] + rng.normal(scale=20.0, size=(n2, 2))).astype(np.float32)
    d2 = _flip(rng, d1[src], 6)
    oct1 = np.where(rng.uniform(size=n1) < 0.8, 0, 2).astype(np.int32)
    oct2 = np.where(rng.uniform(size=n2) < 0.7, 0, 1).astype(np.int32)
    ang1 = rng.uniform(-np.pi, np.pi, n1).astype(np.float32)
    ang2 = (ang1[src] + rng.normal(scale=0.05, size=n2)).astype(np.float32)
    ang2[:30] += 1.5  # rotation-inconsistent matches
    v1, v2 = rng.uniform(size=n1) < 0.95, rng.uniform(size=n2) < 0.95
    args = (uv1, d1, v1, oct1, ang1, uv2, d2, v2, oct2, ang2)
    rj = jm.search_for_initialization(*(jnp.asarray(a) for a in args))
    rt = tm.search_for_initialization(*(_t(a) for a in args))
    np.testing.assert_array_equal(rt.kp_to_query.numpy(), np.asarray(rj.kp_to_query))
    np.testing.assert_array_equal(rt.kp_dist.numpy(), np.asarray(rj.kp_dist))
    assert int(rt.count()) > 50
