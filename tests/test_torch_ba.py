"""Bundle-adjustment parity: the port's Schur assembly (kernel K3's plain
version on the CPU) against sdslam_tpu's XLA fallback on the multi-view
problems of tests/test_ba.py, both K3 output modes against each other, and
one local BA on a map carried across from the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdslam_tpu.mapping import map_state as JM
from sdslam_tpu.solvers import ba as jba
from sdslam_tpu_torch import interop
from sdslam_tpu_torch.geometry import lie as tlie
from sdslam_tpu_torch.geometry.camera import CameraModel as TCam
from sdslam_tpu_torch.kernels import ba_schur_kernel as bsk
from sdslam_tpu_torch.mapping import map_state as TM
from sdslam_tpu_torch.solvers import ba as tba
from test_ba import CAM as JC
from test_ba import make_ba_problem

torch.set_num_threads(2)

TC = TCam(*JC)
M_OBS = 10


def _numpy_map(ms):
    return {k: (v if k == "kf_pyramid" else np.asarray(v)) for k, v in ms._asdict().items()}


def _rel_close(a, b, rel=1e-4):
    """|a - b| <= rel * max|a|: float32 sums over hundreds of edges in
    another order (and the Ze vs Zt route to Z Z^T) round differently."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(a).max(), 1e-30)
    assert np.abs(a - b).max() <= rel * scale, (np.abs(a - b).max(), scale)


def _terms_inputs(seed, stereo, m_obs=M_OBS):
    ms, *_ = make_ba_problem(np.random.default_rng(seed), noise_px=0.3, stereo=stereo)
    obs_kf, obs_kp = JM.build_obs_lists(ms, m_obs)
    cam_active = np.asarray(ms.kf_valid).copy()
    cam_active[0] = False
    return ms, obs_kf, obs_kp, cam_active


def _port_terms(ms, obs_kf, obs_kp, cam_active, lam):
    tms = interop.map_state_from_numpy(_numpy_map(ms), device="cpu")
    es = tba._prep_edges(torch.from_numpy(np.asarray(obs_kf)), torch.from_numpy(
        np.asarray(obs_kp)), tms.kf_uv_und, tms.kf_uright, tms.kf_octave, 2.0, tms.K)
    obs_ok = torch.from_numpy(np.asarray(obs_kf) >= 0)
    return tba._schur_terms(TC, tms.kf_Tcw, tms.pt_pos, es, obs_ok,
                            torch.from_numpy(cam_active), tms.pt_valid, True,
                            torch.tensor(lam))


def _check_schur_terms(stereo, m_obs=M_OBS):
    ms, obs_kf, obs_kp, cam_active = _terms_inputs(3, stereo, m_obs)
    lam = 1e-3
    es = jba._prep_edges(obs_kf, obs_kp, ms.kf_uv_und, ms.kf_uright, ms.kf_octave, 2.0, ms.K)
    a = jba._schur_terms(JC, ms.kf_Tcw, ms.pt_pos, es, obs_kf >= 0, jnp.asarray(cam_active),
                         ms.pt_valid, True, jnp.asarray(lam, jnp.float32))
    b = _port_terms(ms, obs_kf, obs_kp, cam_active, lam)
    # S0, bs, Hpp_inv, W_pm, ybp, cost
    for i in (0, 1, 2, 3, 4):
        _rel_close(a[i], b[i].numpy())
    _rel_close(float(a[5]), float(b[5]))
    assert np.abs(np.asarray(a[0])).max() > 1.0  # a real system, not an empty one
    return obs_kf


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_schur_terms_match_xla(stereo):
    _check_schur_terms(stereo)


def test_schur_terms_match_xla_global_width():
    """Global BA's observation width (max_obs 16; local BA packs 10). The
    problem has 8 keyframe slots, so planes 8-15 hold only empty edges."""
    obs_kf = _check_schur_terms(True, 16)
    assert np.asarray(obs_kf).shape[1] == 16


def test_schur_zt_and_ze_modes_agree(monkeypatch):
    """K3 emits the per-camera factor Zt in-kernel for K <= ZT_MAX_K and
    edge-level Ze otherwise; both routes give the same reduced system."""
    ms, obs_kf, obs_kp, cam_active = _terms_inputs(5, True)
    zt = _port_terms(ms, obs_kf, obs_kp, cam_active, 1e-4)
    monkeypatch.setattr(bsk, "ZT_MAX_K", 0)
    ze = _port_terms(ms, obs_kf, obs_kp, cam_active, 1e-4)
    for x, y in zip(zt[:5], ze[:5]):
        _rel_close(x.numpy(), y.numpy(), 1e-5)


def test_edge_schur_plain_output_layout():
    """The plain K3's Ze channels fold into Zt exactly as the kernel's
    in-kernel scatter does (row j*6K + k*6 + i)."""
    ms, obs_kf, obs_kp, cam_active = _terms_inputs(6, True)
    tms = interop.map_state_from_numpy(_numpy_map(ms), device="cpu")
    es = tba._prep_edges(torch.from_numpy(np.asarray(obs_kf)), torch.from_numpy(
        np.asarray(obs_kp)), tms.kf_uv_und, tms.kf_uright, tms.kf_octave, 2.0, tms.K)
    K = tms.K
    Mo, P = es.ur_obs.shape
    E = Mo * P
    T16 = tms.kf_Tcw.reshape(K, 16).T @ es.cam_onehot.reshape(E, K).T
    ok = torch.from_numpy(np.asarray(obs_kf) >= 0).T.float()
    packed = torch.cat([T16.reshape(16, Mo, P), tms.pt_pos.T[:, None, :].expand(3, Mo, P),
                        es.uv_obs.permute(2, 0, 1), es.ur_obs[None], es.inv_sigma2[None],
                        es.stereo.float()[None], ok[None], torch.ones(1, Mo, P),
                        torch.ones(1, Mo, P), es.cam_idx[None]]).contiguous()
    lam = torch.tensor(1e-4)
    e1, r1, zt = bsk.ba_edge_schur(packed, lam, *TC[:4], TC.bf, True, K, emit_zt=True)
    e2, r2, none = bsk.ba_edge_schur(packed, lam, *TC[:4], TC.bf, True, K, emit_zt=False)
    assert none is None and e1.shape[0] == 51 and e2.shape[0] == 69
    assert torch.equal(e1, e2[:51]) and torch.equal(r1, r2)
    Ze = e2[51:].reshape(3, 6, Mo, P)
    zt_from_ze = torch.einsum("jimp,mpk->jkip", Ze, es.cam_onehot).reshape(18 * K, P)
    torch.testing.assert_close(zt, zt_from_ze, rtol=0, atol=1e-5 * float(zt.abs().max()))


def test_local_ba_on_carried_map():
    ms, T_gt, X_gt, n_kf, n_pt = make_ba_problem(
        np.random.default_rng(11), noise_px=0.2, pose_noise=0.01, pt_noise=0.01, stereo=True)
    a = jba.local_ba(JC, ms, center_kf=5, covis_min=15)
    tms = interop.map_state_from_numpy(_numpy_map(ms), device="cpu")
    b = tba.local_ba(TC, tms, center_kf=5, covis_min=15)
    # 8 LM iterations of float32 normal equations: poses agree to ~1e-5
    np.testing.assert_allclose(np.asarray(a.kf_Tcw), b.kf_Tcw.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.pt_pos), b.pt_pos.numpy(), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(a.kf_mp), b.kf_mp.numpy())
    # and BA moved the poses (a no-op would pass the comparison too)
    moved = np.abs(b.kf_Tcw.numpy()[1:n_kf] - np.asarray(ms.kf_Tcw)[1:n_kf]).max()
    assert moved > 1e-3
    err = tlie.se3_log(b.kf_Tcw[1:n_kf] @ tlie.se3_inv(torch.from_numpy(T_gt[1:])))
    assert float(err.abs().max()) < 5e-3


def test_local_ba_with_default_incidence_matches_jax():
    """local_ba given the incidence at its default dtype (bfloat16 in both
    packages), as code written against the JAX API passes it."""
    ms, *_ = make_ba_problem(np.random.default_rng(11), noise_px=0.2, pose_noise=0.01,
                             pt_noise=0.01, stereo=True)
    a = jba.local_ba(JC, ms, center_kf=5, covis_min=15, inc=JM.incidence_matrix(ms))
    tms = interop.map_state_from_numpy(_numpy_map(ms), device="cpu")
    inc = TM.incidence_matrix(tms)
    assert inc.dtype == torch.bfloat16
    b = tba.local_ba(TC, tms, center_kf=5, covis_min=15, inc=inc)
    np.testing.assert_allclose(np.asarray(a.kf_Tcw), b.kf_Tcw.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.pt_pos), b.pt_pos.numpy(), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(a.kf_mp), b.kf_mp.numpy())
    assert np.abs(b.kf_Tcw.numpy() - np.asarray(ms.kf_Tcw)).max() > 1e-3

def test_bundle_adjust_matches_xla():
    ms, T_gt, *_ = make_ba_problem(np.random.default_rng(2), noise_px=0.3, stereo=True)
    cam_active = np.asarray(ms.kf_valid).copy()
    cam_active[0] = False
    a = jba.bundle_adjust(JC, ms, jnp.asarray(cam_active), ms.pt_valid)
    tms = interop.map_state_from_numpy(_numpy_map(ms), device="cpu")
    b = tba.bundle_adjust(TC, tms, torch.from_numpy(cam_active), tms.pt_valid)
    np.testing.assert_allclose(np.asarray(a.kf_Tcw), b.kf_Tcw.numpy(), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(a.obs_inlier), b.obs_inlier.numpy())
    assert TM.covisibility(tms).max() > 15


@pytest.mark.parametrize("lists", ["given", "built"])
def test_apply_ba_result_matches_jax(lists):
    """apply_ba_result with the observation lists BA ran on, and without
    them (built from the map with max_obs, JAX's default 16): the same
    result written back and the same observations erased, on one BA
    result with every 7th observation flagged an outlier."""
    ms, *_ = make_ba_problem(np.random.default_rng(2), noise_px=0.3, stereo=True)
    obs_kf, obs_kp = JM.build_obs_lists(ms, 16)
    cam_active = np.asarray(ms.kf_valid).copy()
    cam_active[0] = False
    a = jba.bundle_adjust(JC, ms, jnp.asarray(cam_active), ms.pt_valid)
    inl = np.asarray(a.obs_inlier).copy()
    inl[:, ::7] = False
    a = a._replace(obs_inlier=jnp.asarray(inl))
    b = tba.BAResult(*(torch.from_numpy(np.array(v)) for v in a))
    tms = interop.map_state_from_numpy(_numpy_map(ms), device="cpu")
    if lists == "given":
        ja = jba.apply_ba_result(ms, a, obs_kf, obs_kp)
        ta = tba.apply_ba_result(tms, b, torch.from_numpy(np.array(obs_kf)),
                                 torch.from_numpy(np.array(obs_kp)))
    else:
        ja = jba.apply_ba_result(ms, a)
        ta = tba.apply_ba_result(tms, b)
    np.testing.assert_array_equal(np.asarray(ja.kf_mp), ta.kf_mp.numpy())
    np.testing.assert_array_equal(np.asarray(ja.kf_Tcw), ta.kf_Tcw.numpy())
    np.testing.assert_array_equal(np.asarray(ja.pt_pos), ta.pt_pos.numpy())
    erased = (np.asarray(ms.kf_mp) >= 0).sum() - (ta.kf_mp.numpy() >= 0).sum()
    assert erased > 10
