"""Direct image alignment: the port's image_align.align (kernel K1's plain
version on the CPU) against sdslam_tpu's align(fused=False) XLA loop on a
rendered frame pair; one level (align_level) against the JAX level loop
_align_level, at full and ragged point counts; and the kernel's output
contract (the views the wrapper returns)."""

import pathlib
import re

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
from sdslam_tpu_torch.kernels import _build
from sdslam_tpu_torch.kernels import align_kernel as tak
from sdslam_tpu_torch.solvers import image_align as tia

torch.set_num_threads(2)

CAM = jcam.CameraModel(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320, height=240, bf=32.0)


@pytest.fixture(scope="module")
def rendered():
    seq = jsyn.SyntheticSequence(CAM, n_frames=16, trajectory="orbit", radius=0.06,
                                 yaw_amp=0.04)
    _, img0, dep0 = seq.frame(0)
    _, img1, _ = seq.frame(2)
    return seq, img0, dep0, img1


@pytest.fixture(scope="module")
def pair(rendered):
    seq, img0, dep0, img1 = rendered
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


def _level_inputs(rendered, n_pts, level=2, seed=3):
    """One level's IC-LK inputs for n_pts random points of frame 0 (depth
    from the render), as the port precomputes them."""
    seq, img0, dep0, img1 = rendered
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(20, CAM.width - 20, n_pts),
                   rng.uniform(20, CAM.height - 20, n_pts)], -1).astype(np.float32)
    dep = np.asarray(dep0)
    d = dep[np.round(uv[:, 1]).astype(int), np.round(uv[:, 0]).astype(int)]
    X = np.asarray(jcam.backproject(CAM, jnp.asarray(uv), jnp.maximum(jnp.asarray(d), 1e-3)))
    s = 0.5**level
    ref = torch.from_numpy(np.array(jpyr.build_pyramid(img0, 4)[level]))
    cur = np.array(jpyr.build_pyramid(img1, 4)[level])
    patch, J, ok = tia._precompute_level(ref, torch.from_numpy(uv * s), torch.from_numpy(X),
                                         torch.from_numpy(d > 0), CAM.fx * s, CAM.fy * s)
    T_rel = np.asarray(seq.poses[2] @ jlie.se3_inv(seq.poses[0]))
    xi = jnp.asarray([0.004, -0.003, 0.002, 0.002, -0.003, 0.001], jnp.float32)
    T_init = np.asarray(jlie.se3_exp(xi) @ T_rel)
    return cur, X, patch, J, ok, T_init, (CAM.fx * s, CAM.fy * s, CAM.cx * s, CAM.cy * s)


@pytest.mark.parametrize("n_pts", [1024, 1000, 4096], ids=["N1024", "ragged_N1000", "N4096"])
def test_align_level_matches_jax_level_loop(rendered, n_pts):
    """K1's function (plain on the CPU) against the JAX level loop
    (_align_level, fused=False) on the same precomputed level; N = 1000
    leaves the card's 8-CTA split ragged; N = 4096 is past the points whose
    invariants the card's CTAs stage (the rest read from global memory)."""
    cur, X, patch, J, ok, T_init, intr = _level_inputs(rendered, n_pts)
    Hinv = tia.damped_hessian_inverse(J, ok)
    T, chi2, n = tak.align_level(torch.from_numpy(cur), torch.from_numpy(X), patch, J, ok, Hinv,
                                 torch.from_numpy(T_init), *intr, 30)
    Tj, chi2j, nj = jia._align_level(jnp.asarray(cur), jnp.asarray(T_init), jnp.asarray(X),
                                     jnp.asarray(patch.numpy()), jnp.asarray(J.numpy()),
                                     jnp.asarray(ok.numpy()), *intr, 30, fused=False)
    # the 6x6 solve (cho_solve vs the cached damped inverse) and the sums
    # round differently in the last float32 bits
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_allclose(float(chi2), float(chi2j), rtol=1e-4)
    assert int(n) == int(nj)


def test_kernel_output_views_contract(rendered):
    """The views the wrapper makes of the kernel's output words have the
    plain version's types and shapes: T [4,4] f32 with the bottom row
    [0, 0, 0, 1], chi2 0-d f32, n_px 0-d int32; the GN iteration count is
    the fourth word after T."""
    cur, X, patch, J, ok, T_init, intr = _level_inputs(rendered, 64)
    args = (torch.from_numpy(cur), torch.from_numpy(X), patch, J, ok,
            tia.damped_hessian_inverse(J, ok), torch.from_numpy(T_init), *intr, 30)
    Tp, chi2p, np_, it = tak.align_level_steps(*args)
    assert torch.equal(Tp[3], torch.tensor([0.0, 0.0, 0.0, 1.0]))
    # the words the kernel writes for these results
    out = torch.zeros(tak.OUT_SHAPE, dtype=torch.float32)
    out[:4] = Tp
    out[4, 0] = chi2p
    out.view(torch.int32)[4, 1:3] = torch.tensor([int(np_), it], dtype=torch.int32)
    views = tak._views(out)
    for v, p in zip(views, (Tp, chi2p, np_)):
        assert (v.dtype, v.shape) == (p.dtype, p.shape)
        assert torch.equal(v, p)
        assert v.untyped_storage().data_ptr() == out.untyped_storage().data_ptr()  # no copy
    assert tak._iterations(out).dtype == torch.int32 and int(tak._iterations(out)) == it


def test_kernel_bound_matches_wrapper():
    """csrc/sd_align.cuh splits each CTA's share of the points where
    kernels/align_kernel.py says it does: the first STAGE_MAX points are
    staged in shared memory (the most whose invariants, J 24 + patch 4 +
    mask 1 bytes per tap and X 12 bytes per point, fit AL_DYN_MAX), the rest
    are read from global memory; no bound on N is left in the wrapper or
    the sources."""
    src = (_build.CSRC / "sd_align.cuh").read_text()
    define = {k: int(re.search(rf"#define {k} (\d+)", src).group(1))
              for k in ("AL_STAGE_MAX", "AL_DYN_MAX", "AL_CLUSTER", "AL_PATCH")}
    assert (define["AL_STAGE_MAX"], define["AL_CLUSTER"], define["AL_PATCH"]) == (
        tak.STAGE_MAX, tak.CLUSTER, tak.PATCH)
    pt_bytes = define["AL_PATCH"] * 29 + 12
    assert tak.STAGE_MAX * pt_bytes <= define["AL_DYN_MAX"] < (tak.STAGE_MAX + 1) * pt_bytes
    # shares of 1/8 of the points: whole up to 8 x STAGE_MAX = 3872, capped past it
    assert [tak.staged_points(n) for n in (1000, 1024, 3872, 3880, 4096, 8192)] == [
        125, 128, 484, 484, 484, 484]
    for path in (_build.CSRC / "sd_align.cuh", _build.CSRC / "align_level.cu",
                 pathlib.Path(tak.__file__)):
        assert not re.search(r"\b(AL_)?N_MAX\b", path.read_text()), path
