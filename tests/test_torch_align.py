"""Direct image alignment: the port's image_align.align (kernel K1's plain
version on the CPU) against sdslam_tpu's align(fused=False) XLA loop on a
rendered frame pair."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdslam_tpu.features.frame import ORBExtractor
from sdslam_tpu.geometry import camera as jcam
from sdslam_tpu.geometry import lie as jlie
from sdslam_tpu.io import synthetic as jsyn
from sdslam_tpu.ops import pyramid as jpyr
from sdslam_tpu.solvers import image_align as jia
from sdslam_tpu.utils.config import ORBConfig
from sdslam_tpu_torch.kernels import align_kernel as tak
from sdslam_tpu_torch.solvers import image_align as tia

torch.set_num_threads(2)

CAM = jcam.CameraModel(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320, height=240, bf=32.0)


@pytest.fixture(scope="module")
def pair():
    seq = jsyn.SyntheticSequence(CAM, n_frames=16, trajectory="orbit", radius=0.06,
                                 yaw_amp=0.04)
    _, img0, dep0 = seq.frame(0)
    _, img1, _ = seq.frame(2)
    ext = ORBExtractor(CAM, ORBConfig(max_keypoints=512, n_levels=4))
    feats, pyr0, d, _ = ext._run_depth(img0, dep0, 1.0)
    pyr1 = jpyr.build_pyramid(img1, 4)
    valid = np.asarray(feats.valid & (d > 0))
    X = np.asarray(jcam.backproject(CAM, feats.uv_und, jnp.maximum(d, 1e-3)))
    T_rel = np.asarray(seq.poses[2] @ jlie.se3_inv(seq.poses[0]))
    xi = jnp.asarray([0.004, -0.003, 0.002, 0.002, -0.003, 0.001], jnp.float32)
    T_init = np.asarray(jlie.se3_exp(xi) @ T_rel)
    return ([np.asarray(p) for p in pyr0], [np.asarray(p) for p in pyr1],
            np.asarray(feats.uv), X, valid, T_init)


@pytest.mark.parametrize("start,max_level,min_level", [(2, 3, 2), (0, 3, 1)],
                         ids=["kf_store_levels", "full_pyramid"])
def test_align_matches_xla_loop(pair, start, max_level, min_level):
    pyr0, pyr1, uv, X, valid, T_init = pair
    kw = dict(scale_factor=2.0, max_level=max_level, min_level=min_level, start_level=start)
    a = jia.align(tuple(jnp.asarray(p) for p in pyr0[start:]),
                  tuple(jnp.asarray(p) for p in pyr1[start:]), jnp.asarray(uv), jnp.asarray(X),
                  jnp.asarray(valid), jnp.asarray(T_init), CAM.fx, CAM.fy, CAM.cx, CAM.cy,
                  fused=False, **kw)
    b = tia.align(tuple(torch.from_numpy(p) for p in pyr0[start:]),
                  tuple(torch.from_numpy(p) for p in pyr1[start:]), torch.from_numpy(uv),
                  torch.from_numpy(X), torch.from_numpy(valid), torch.from_numpy(T_init),
                  CAM.fx, CAM.fy, CAM.cx, CAM.cy, **kw)
    # same GN iterations; sums and the 6x6 solve (cho_solve vs the cached
    # damped inverse) round differently in the last float32 bits
    np.testing.assert_allclose(np.asarray(a.T_cur_ref), b.T_cur_ref.numpy(), atol=1e-4)
    np.testing.assert_allclose(float(a.error), float(b.error), rtol=1e-4)
    assert int(a.n_meas) == int(b.n_meas)
    assert float(b.error) < 0.01


def test_precompute_level_parity(pair):
    pyr0, _, uv, X, valid, _ = pair
    s = 0.25
    a = jia._precompute_level(jnp.asarray(pyr0[2]), jnp.asarray(uv * s), jnp.asarray(X),
                              jnp.asarray(valid), CAM.fx * s, CAM.fy * s)
    b = tia._precompute_level(torch.from_numpy(pyr0[2]), torch.from_numpy(uv * s),
                              torch.from_numpy(X), torch.from_numpy(valid), CAM.fx * s,
                              CAM.fy * s)
    np.testing.assert_array_equal(np.asarray(a[2]), b[2].numpy())
    np.testing.assert_allclose(np.asarray(a[0]), b[0].numpy(), atol=1e-3)  # intensities ~255
    # J = image gradient x projection Jacobian, entries up to ~1e3: float32
    # products round at ~1e-5 of the largest entry
    ja = np.asarray(a[1])
    np.testing.assert_allclose(ja, b[1].numpy(), atol=1e-5 * np.abs(ja).max())


def test_level_plain_matches_wrapper_on_cpu(pair):
    """On CPU tensors the K1 wrapper is exactly its plain version."""
    pyr0, pyr1, uv, X, valid, T_init = pair
    s = 0.25
    patch, J, ok = tia._precompute_level(torch.from_numpy(pyr0[2]), torch.from_numpy(uv * s),
                                         torch.from_numpy(X), torch.from_numpy(valid),
                                         CAM.fx * s, CAM.fy * s)
    args = (torch.from_numpy(pyr1[2]), torch.from_numpy(X), patch, J, ok,
            tia.damped_hessian_inverse(J, ok), torch.from_numpy(T_init),
            CAM.fx * s, CAM.fy * s, CAM.cx * s, CAM.cy * s, 30)
    before = tak.LAUNCHES
    a = tak.align_level(*args)
    b = tak.align_level_plain(*args)
    assert tak.LAUNCHES == before  # no kernel launch for CPU tensors
    for x, y in zip(a, b):
        assert torch.equal(x, y)
