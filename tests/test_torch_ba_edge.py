"""K7 (the flat per-edge BA pass): the port's ba_edge_terms on the CPU (its
plain version) against sdslam_tpu's Pallas kernel in interpret mode, on
edges packed from tests/test_ba.py::make_ba_problem (mono and stereo
observations, a fixed camera, masked edges and inactive points), E = 1000
(not a multiple of the Pallas kernel's 128 lanes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdslam_tpu.ops.pallas import ba_edge_kernel as jbe
from sdslam_tpu_torch.kernels import ba_edge_kernel as tbe
from test_ba import CAM, make_ba_problem

E = 1000


def _packed(seed=5):
    """[27, E] channel-major edges of a synthetic map: every (keyframe,
    keypoint) observation of a point, the first E of them."""
    rng = np.random.default_rng(seed)
    ms, *_ = make_ba_problem(rng, noise_px=0.5, stereo=True)
    kf_mp = np.asarray(ms.kf_mp)
    k, i = np.nonzero(kf_mp >= 0)
    k, i = k[:E], i[:E]
    p = kf_mp[k, i]
    assert len(p) == E
    T = np.asarray(ms.kf_Tcw)[k].reshape(E, 16)
    X = np.asarray(ms.pt_pos)[p]
    uv = np.asarray(ms.kf_uv_und)[k, i]
    ur = np.asarray(ms.kf_uright)[k, i]
    stereo = (ur >= 0) & (rng.uniform(size=E) < 0.5)  # half the edges mono
    octave = rng.integers(0, 4, E)
    planes = [T.T, X.T, uv.T, np.where(stereo, ur, -1.0)[None],
              (1.0 / 4.0 ** octave)[None], stereo[None],
              (rng.uniform(size=E) < 0.9)[None],  # edge valid
              (k > 0)[None],  # camera 0 fixed
              (rng.uniform(size=E) < 0.95)[None]]  # point active
    return np.concatenate([np.asarray(a, np.float32).reshape(-1, E) for a in planes])


@pytest.mark.parametrize("use_huber", [True, False])
def test_ba_edge_terms_matches_pallas_interpret(use_huber):
    """Both float32 sides within 1e-5 of each channel's largest entry of the
    same math in float64, and within 2e-5 of each other (ROADMAP.md section
    3: the residual channels cancel ~300 px to ~1 px, and the two float32
    evaluations err on opposite sides of the float64 one)."""
    packed = _packed()
    assert packed.shape == (tbe.N_IN, E)
    cam = (CAM.fx, CAM.fy, CAM.cx, CAM.cy, CAM.bf)
    before = tbe.LAUNCHES
    out = tbe.ba_edge_terms(torch.from_numpy(packed), *cam, use_huber).numpy()
    assert tbe.LAUNCHES == before  # CPU tensors take the plain version
    ref = np.asarray(jbe.ba_edge_terms(jnp.asarray(packed), *cam, use_huber, interpret=True))
    ref64 = tbe.ba_edge_terms_plain(torch.from_numpy(packed).double(), *cam, use_huber).numpy()
    assert out.shape == ref.shape == ref64.shape == (tbe.N_OUT, E)
    scale = np.abs(ref64).max(axis=1)
    for got, tol in ((out, 1e-5), (ref, 1e-5), (ref, 2e-5)):
        against = ref64 if tol == 1e-5 else out
        err = np.abs(got - against).max(axis=1)
        assert np.all(err <= tol * scale), (tol, np.flatnonzero(err > tol * scale))
    assert np.count_nonzero(ref[54]) > 0.8 * E  # rho of the valid edges
