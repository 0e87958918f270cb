"""Bundle adjustment with Schur-complement elimination of landmarks
(port of sdslam_tpu/solvers/ba.py: local BA and global BA).

Edges live in observation-major [Mo, P] planes. Per LM iteration the edge
pass, the per-point 3x3 elimination and the per-camera Schur-factor scatter
run in kernel K3 (kernels/ba_schur_kernel.py); the per-camera sums and
S = Hcc - Z Z^T stay torch.matmul (XLA matmuls in the JAX package). The
dense [6K, 6K] Cholesky solve runs in kernel K6 (kernels/chol_kernel.py)
up to its N_MAX and in torch.linalg above it. Fixed cameras stay in the
system under a huge diagonal prior (static shapes).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sdslam_tpu_torch._util import scatter_set, scatter_set2, topk_stable
from sdslam_tpu_torch.geometry import lie
from sdslam_tpu_torch.geometry.camera import CameraModel
from sdslam_tpu_torch.kernels import ba_schur_kernel as bsk
from sdslam_tpu_torch.kernels import chol_kernel as chol
from sdslam_tpu_torch.mapping import map_state as M
from sdslam_tpu_torch.solvers.ba_const import (  # noqa: F401 (re-exported)
    CHI2_MONO, CHI2_STEREO, FIXED_PRIOR, HUBER_MONO, HUBER_STEREO,
)

INT32_MAX = 2**31 - 1


class BAResult(NamedTuple):
    kf_Tcw: torch.Tensor  # [K,4,4]
    pt_pos: torch.Tensor  # [P,3]
    obs_inlier: torch.Tensor  # [P,M] bool
    chi2: torch.Tensor  # mean inlier chi2


class _EdgeStatic(NamedTuple):
    """Per-edge observation data fixed across LM iterations, [Mo, P]."""

    uv_obs: torch.Tensor  # [Mo,P,2]
    ur_obs: torch.Tensor  # [Mo,P]
    inv_sigma2: torch.Tensor  # [Mo,P]
    stereo: torch.Tensor  # [Mo,P] bool
    cam_onehot: torch.Tensor  # [Mo,P,K] f32
    cam_idx: torch.Tensor  # [Mo,P] f32


def _prep_edges(obs_kf, obs_kp, kf_uv_und, kf_uright, kf_octave, scale_factor, K):
    c = torch.clamp(obs_kf, 0, K - 1).T.long()
    k = torch.clamp(obs_kp, 0, kf_uv_und.shape[1] - 1).T.long()
    fields = torch.cat([kf_uv_und, kf_uright[..., None],
                        kf_octave.to(torch.float32)[..., None]], dim=-1)
    g = fields[c, k]
    ur_obs = g[..., 2]
    onehot = (c[..., None] == torch.arange(K, device=c.device)).to(torch.float32)
    return _EdgeStatic(g[..., :2], ur_obs, 1.0 / scale_factor ** (2.0 * g[..., 3]),
                       ur_obs >= 0, onehot, c.to(torch.float32))


def _schur_terms(cam, kf_Tcw, pt_pos, es: _EdgeStatic, obs_ok, cam_active, pt_active,
                 use_huber: bool, lm_lambda):
    """Edge pass + Schur assembly without the camera prior/solve. Returns
    (S0 [6K,6K], bs [K,6], Hpp_inv [P,3,3], W_pm [18,Mo,P], ybp [P,3],
    cost_cur, Uflat [E,K])."""
    K = kf_Tcw.shape[0]
    Mo, P = es.ur_obs.shape
    E = Mo * P
    dev = pt_pos.device
    Uflat = es.cam_onehot.reshape(E, K)
    T16 = kf_Tcw.reshape(K, 16).T @ Uflat.T  # [16,E]
    cam_act_e = (Uflat @ cam_active.to(torch.float32)).reshape(Mo, P)
    pt_act_e = pt_active[None, :].expand(Mo, P).to(torch.float32)
    packed = torch.cat([
        T16.reshape(16, Mo, P),
        pt_pos.T[:, None, :].expand(3, Mo, P),
        es.uv_obs[None, ..., 0], es.uv_obs[None, ..., 1], es.ur_obs[None],
        es.inv_sigma2[None], es.stereo.to(torch.float32)[None],
        obs_ok.T.to(torch.float32)[None], cam_act_e[None], pt_act_e[None], es.cam_idx[None],
    ], dim=0).contiguous()
    emit_zt = K <= bsk.ZT_MAX_K
    edge, rows, zt = bsk.ba_edge_schur(packed, lm_lambda, cam.fx, cam.fy, cam.cx, cam.cy,
                                       cam.bf, use_huber, K, emit_zt=emit_zt)
    W_pm = edge[0:18]
    HG = (edge[18:45].reshape(27, E) @ Uflat).T  # [K,27]
    Vyb = (edge[45:51].reshape(6, E) @ Uflat).T  # [K,6]
    s00, s01, s02, s11, s12, s22 = (rows[i] for i in range(6))
    Hpp_inv = torch.stack([torch.stack([s00, s01, s02], -1),
                           torch.stack([s01, s11, s12], -1),
                           torch.stack([s02, s12, s22], -1)], -2)
    ybp = rows[6:9].T
    cost_cur = rows[9].sum()
    if zt is not None:
        K6 = 6 * K
        S_dense = -(zt[0:K6] @ zt[0:K6].T + zt[K6:2 * K6] @ zt[K6:2 * K6].T
                    + zt[2 * K6:] @ zt[2 * K6:].T)
    else:
        S_dense = _schur_S_from_ze(edge[51:69], es.cam_onehot, K)
    # the 21 packed upper-triangle columns, row-major as triu_indices lists them
    r, c = torch.triu_indices(6, 6, device=dev)
    Hcc = torch.zeros((K, 6, 6), device=dev)
    Hcc[:, r, c] = HG[:, :21]
    Hcc[:, c, r] = HG[:, :21]
    bs = HG[:, 21:] - Vyb
    eyeK = torch.eye(K, device=dev)
    S = S_dense.reshape(K, 6, K, 6) + torch.einsum("kij,kl->kilj", Hcc, eyeK)
    return S.reshape(6 * K, 6 * K), bs, Hpp_inv, W_pm, ybp, cost_cur, Uflat


def _schur_S_from_ze(Ze, cam_onehot, K: int):
    """-Z Z^T from edge-level Ze [18, Mo, P] (channel j*6+i)."""
    P = Ze.shape[2]
    Zb = torch.einsum("cmp,mpk->pck", Ze, cam_onehot)  # [P,18,K]
    Z4 = Zb.permute(2, 1, 0).reshape(K, 3, 6, P)  # (k, j, i, p)
    Zt = [Z4[:, j].reshape(K * 6, P) for j in range(3)]
    return -(Zt[0] @ Zt[0].T + Zt[1] @ Zt[1].T + Zt[2] @ Zt[2].T)


def _apply_prior_and_solve(S0, bs, cam_active, lm_lambda, K: int):
    """Trace-scaled damping / fixed-camera prior on the reduced system,
    then the dense Cholesky solve for the camera step (kernel K6 when the
    system fits it, decided from the shape alone)."""
    S4 = S0.reshape(K, 6, K, 6)
    KI = torch.arange(K, device=S0.device)
    tr_S = torch.diagonal(S4[KI, :, KI, :], dim1=-2, dim2=-1).sum(-1)
    diag_scale = torch.clamp(tr_S / 6.0, min=1e-6)
    prior = torch.where(cam_active, lm_lambda * diag_scale,
                        torch.full_like(diag_scale, FIXED_PRIOR))
    S = S0 + torch.diag(prior.repeat_interleave(6))
    # K6 up to its shared-memory bound; the library factor and solve above
    solve = chol.chol_solve_dense if 6 * K <= chol.N_MAX else chol.chol_solve_dense_plain
    dc = solve(S, bs.reshape(K * 6)).reshape(K, 6)
    return dc * cam_active[:, None]


def _back_substitute(dc, Uflat, W_pm, Hpp_inv, ybp, pt_active):
    """Landmark step dp = ybp - Hpp^-1 W^T dc (point-local)."""
    _, Mo, P = W_pm.shape
    dc_e = (dc.T @ Uflat.T).reshape(6, Mo, P)
    Wt_dc = torch.einsum("ijmp,imp->pj", W_pm.reshape(6, 3, Mo, P), dc_e)
    return (ybp - torch.einsum("pij,pj->pi", Hpp_inv, Wt_dc)) * pt_active[:, None]


def _gn_iteration(cam, kf_Tcw, pt_pos, es, obs_ok, cam_active, pt_active, use_huber: bool,
                  lm_lambda):
    """One damped GN step: Schur terms + prior + dense solve + back-sub."""
    K = kf_Tcw.shape[0]
    S0, bs, Hpp_inv, W_pm, ybp, cost_cur, Uflat = _schur_terms(
        cam, kf_Tcw, pt_pos, es, obs_ok, cam_active, pt_active, use_huber, lm_lambda)
    dc = _apply_prior_and_solve(S0, bs, cam_active, lm_lambda, K)
    dp = _back_substitute(dc, Uflat, W_pm, Hpp_inv, ybp, pt_active)
    kf_new = torch.where(cam_active[:, None, None], lie.se3_exp(dc) @ kf_Tcw, kf_Tcw)
    return kf_new, pt_pos + dp, cost_cur


def _edge_chi2(cam, kf_Tcw, pt_pos, es: _EdgeStatic, obs_ok):
    """chi2 [P,M] + (ok, stereo) [P,M] masks, residuals only."""
    Mo, P, K = es.cam_onehot.shape
    E = Mo * P
    T16 = kf_Tcw.reshape(K, 16).T @ es.cam_onehot.reshape(E, K).T
    Xw = pt_pos.T[:, None, :].expand(3, Mo, P).reshape(3, E)
    x = T16[0] * Xw[0] + T16[1] * Xw[1] + T16[2] * Xw[2] + T16[3]
    y = T16[4] * Xw[0] + T16[5] * Xw[1] + T16[6] * Xw[2] + T16[7]
    z = T16[8] * Xw[0] + T16[9] * Xw[1] + T16[10] * Xw[2] + T16[11]
    zi = 1.0 / torch.clamp(z, min=1e-6)
    u = cam.fx * x * zi + cam.cx
    v = cam.fy * y * zi + cam.cy
    ur = u - cam.bf * zi
    stereo = es.stereo.reshape(E)
    uv_obs = es.uv_obs.reshape(E, 2)
    r0 = u - uv_obs[:, 0]
    r1 = v - uv_obs[:, 1]
    r2 = torch.where(stereo, ur - es.ur_obs.reshape(E), torch.zeros_like(ur))
    chi2 = (r0 * r0 + r1 * r1 + r2 * r2) * es.inv_sigma2.reshape(E)
    ok = obs_ok.T.reshape(E) & (z > 0.05)
    return chi2.reshape(Mo, P).T, ok.reshape(Mo, P).T, es.stereo.T


def _robust_cost(cam, kf_Tcw, pt_pos, es, obs_ok):
    """Total Huber-robustified cost over included edges."""
    chi2, ok, stereo = _edge_chi2(cam, kf_Tcw, pt_pos, es, obs_ok)
    delta = torch.where(stereo, torch.full_like(chi2, HUBER_STEREO),
                        torch.full_like(chi2, HUBER_MONO))
    d2 = delta * delta
    rho = torch.where(chi2 <= d2, chi2, 2.0 * delta * torch.sqrt(chi2 + 1e-12) - d2)
    return torch.sum(torch.where(ok, rho, torch.zeros_like(rho)))


def _chi2(cam, kf_Tcw, pt_pos, es, obs_ok):
    chi2, ok, stereo = _edge_chi2(cam, kf_Tcw, pt_pos, es, obs_ok)
    th = torch.where(stereo, torch.full_like(chi2, CHI2_STEREO), torch.full_like(chi2, CHI2_MONO))
    inlier = obs_ok & ok & (chi2 <= th)
    mean = torch.sum(torch.where(inlier, chi2, torch.zeros_like(chi2))) / torch.clamp(
        inlier.sum(), min=1)
    return chi2, inlier, mean


def _ba_core(cam, kf_Tcw, pt_pos, es, obs_ok, cam_act, pt_act, iters1: int, iters2: int,
             lm_lambda: float):
    """The two-stage LM schedule (outlier pass between the stages) with
    deferred accept/reject: a worse step is rolled back at the start of
    the next iteration. Sync-free: accept decisions stay on the device."""

    def stage(kf_Tcw, pt_pos, obs_ok, n_iters):
        T, X = kf_Tcw, pt_pos
        Tb, Xb = kf_Tcw, pt_pos
        cb = torch.full((), float("inf"), device=pt_pos.device)
        lam = torch.full((), lm_lambda, device=pt_pos.device)
        for _ in range(n_iters):
            T_new, X_new, cost_cur = _gn_iteration(cam, T, X, es, obs_ok, cam_act, pt_act,
                                                   True, lam)
            accept = cost_cur <= cb
            Tb = torch.where(accept, T, Tb)
            Xb = torch.where(accept, X, Xb)
            cb = torch.minimum(cost_cur, cb)
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                              torch.clamp(lam * 8.0, max=1e3))
            T = torch.where(accept, T_new, Tb)
            X = torch.where(accept, X_new, Xb)
        take = _robust_cost(cam, T, X, es, obs_ok) <= cb
        return torch.where(take, T, Tb), torch.where(take, X, Xb)

    kf_Tcw, pt_pos = stage(kf_Tcw, pt_pos, obs_ok, iters1)
    _, inlier, _ = _chi2(cam, kf_Tcw, pt_pos, es, obs_ok)
    obs_ok2 = obs_ok & inlier
    kf_Tcw, pt_pos = stage(kf_Tcw, pt_pos, obs_ok2, iters2)
    _, inlier, mean = _chi2(cam, kf_Tcw, pt_pos, es, obs_ok2)
    return kf_Tcw, pt_pos, obs_ok2 & inlier, mean


def bundle_adjust(cam: CameraModel, ms: M.MapState, cam_active, pt_active,
                  scale_factor: float = 2.0, iters1: int = 4, iters2: int = 6,
                  max_obs: int = 16, lm_lambda: float = 1e-4, obs_kf=None,
                  obs_kp=None) -> BAResult:
    """Two-stage BA over the whole pool (cameras in cam_active optimized)."""
    if obs_kf is None:
        obs_kf, obs_kp = M.build_obs_lists(ms, max_obs)
    obs_ok = obs_kf >= 0
    es = _prep_edges(obs_kf, obs_kp, ms.kf_uv_und, ms.kf_uright, ms.kf_octave,
                     scale_factor, ms.K)
    n_obs = obs_ok.sum(1)
    n_stereo = (obs_ok & es.stereo.T).sum(1)
    pt_act = pt_active & ms.pt_valid & ((n_obs >= 2) | (n_stereo >= 1))
    cam_act = cam_active & ms.kf_valid
    obs_ok = obs_ok & pt_act[:, None]
    T, X, obs_in, mean = _ba_core(cam, ms.kf_Tcw, ms.pt_pos, es, obs_ok, cam_act, pt_act,
                                  iters1, iters2, lm_lambda)
    return BAResult(T, X, obs_in, mean)


def local_ba(cam: CameraModel, ms: M.MapState, center_kf, scale_factor: float = 2.0,
             covis_min: int = 15, max_obs: int = 10, covis=None, max_local_kfs: int = 24,
             max_local_pts: int = 2048, iters1: int = 3, iters2: int = 5,
             inc=None) -> M.MapState:
    """Local BA around a keyframe: it, its covisible neighbours and their
    points are optimized; frontier KFs observing those points stay fixed.
    The problem is compacted to [KL] camera and [PL] point slots first."""
    K, P, N, dev = ms.K, ms.P, ms.N, ms.device
    KL = min(max_local_kfs, K)
    PL = min(max_local_pts, P)
    c = M._idx(center_kf, dev)
    cov = M.covisibility(ms) if covis is None else covis
    local = cov.index_select(0, c.reshape(1))[0] >= covis_min
    local = local.index_fill(0, c.reshape(1), True) & ms.kf_valid
    fid_i = torch.where(ms.kf_valid, ms.kf_frame_id, torch.full_like(ms.kf_frame_id, INT32_MAX))
    oldest = torch.argmin(fid_i)
    local = local.index_fill(0, oldest.reshape(1), False)
    obs = M.observation_table(ms)
    if inc is not None:
        pt_local = ((local.to(inc.dtype) @ inc) > 0) & ms.pt_valid
        frontier = ((inc @ pt_local.to(inc.dtype)) > 0) & ms.kf_valid & ~local
    else:
        contrib = torch.where(local[:, None], obs, torch.full_like(obs, -1))
        pt_local = scatter_set(torch.zeros(P, dtype=torch.bool, device=dev),
                               torch.where(contrib >= 0, contrib, P), True) & ms.pt_valid
        hit = (obs >= 0) & pt_local[torch.clamp(obs, 0, P - 1).long()]
        frontier = hit.any(1) & ms.kf_valid & ~local

    # camera compaction: locals first, then the newest frontier anchors
    fid = ms.kf_frame_id.to(torch.float32)
    fid = fid / torch.clamp(fid.max(), min=1.0)
    zero = torch.zeros_like(fid)
    score = torch.where(local, zero + 4.0, zero) + torch.where(frontier, zero + 2.0, zero) + fid
    top_score, cam_idx = topk_stable(score, KL)
    cam_in = top_score >= 2.0
    sub_T = ms.kf_Tcw[cam_idx]
    cam_act = local[cam_idx] & cam_in
    any_fixed = (cam_in & ~cam_act).any()
    sel_fid = torch.where(cam_in, ms.kf_frame_id[cam_idx],
                          torch.full_like(ms.kf_frame_id[cam_idx], INT32_MAX))
    oldest_sel = torch.argmin(sel_fid).reshape(1)
    cam_act = cam_act.index_copy(0, oldest_sel, cam_act[oldest_sel] & any_fixed)

    # point compaction + compact observation lists (rows = compact cameras)
    pt_idx, pt_in, pt_remap = M.compact_indices(pt_local, PL)
    sub_X = ms.pt_pos[pt_idx.long()]
    obs_c = torch.where(cam_in[:, None], obs[cam_idx], torch.full_like(obs[cam_idx], -1))
    obs_cp = torch.where(obs_c >= 0, pt_remap[torch.clamp(obs_c, 0, P - 1).long()],
                         torch.full_like(obs_c, -1))
    obs_row, obs_kp = M.obs_lists_from_table(obs_cp, PL, max_obs)
    obs_ok = obs_row >= 0
    row_s = torch.clamp(obs_row, 0, KL - 1).long()
    kp_s = torch.clamp(obs_kp, 0, N - 1).long()
    c_orig = cam_idx[row_s]
    fields = torch.cat([ms.kf_uv_und, ms.kf_uright[..., None],
                        ms.kf_octave.to(torch.float32)[..., None]], dim=-1)
    g = fields[c_orig.T, kp_s.T]  # [M,PL,4]
    ur_obs = g[..., 2]
    onehot = ((row_s.T[..., None] == torch.arange(KL, device=dev)) & obs_ok.T[..., None]).to(
        torch.float32)
    es = _EdgeStatic(g[..., :2], ur_obs, 1.0 / scale_factor ** (2.0 * g[..., 3]), ur_obs >= 0,
                     onehot, row_s.T.to(torch.float32))
    n_obs = obs_ok.sum(1)
    n_stereo = (obs_ok & es.stereo.T).sum(1)
    pt_act = pt_in & ((n_obs >= 2) | (n_stereo >= 1))
    obs_ok = obs_ok & pt_act[:, None]

    T_new, X_new, obs_in, _ = _ba_core(cam, sub_T, sub_X, es, obs_ok, cam_act, pt_act,
                                       iters1, iters2, 1e-4)

    kf_Tcw = scatter_set(ms.kf_Tcw, torch.where(cam_act, cam_idx, K), T_new)
    pt_pos = scatter_set(ms.pt_pos, torch.where(pt_act, pt_idx, P), X_new)
    bad = obs_ok & ~obs_in
    kf_mp = scatter_set2(ms.kf_mp, torch.where(bad, c_orig, K), kp_s, -1)
    return ms._replace(kf_Tcw=kf_Tcw, pt_pos=pt_pos, kf_mp=kf_mp)


def apply_ba_result(ms: M.MapState, res: BAResult, obs_kf=None, obs_kp=None,
                    max_obs: int = 16) -> M.MapState:
    """Write a BA result back into the map and erase the observations it
    flagged as outliers (obs_kf, obs_kp: the observation lists BA ran on;
    built from the map with `max_obs` when not given)."""
    if obs_kf is None:
        obs_kf, obs_kp = M.build_obs_lists(ms, max_obs)
    bad = (obs_kf >= 0) & ~res.obs_inlier
    kf_mp = scatter_set2(ms.kf_mp, torch.where(bad, obs_kf, ms.K),
                         torch.clamp(obs_kp, 0, ms.N - 1), -1)
    return ms._replace(kf_Tcw=res.kf_Tcw, pt_pos=res.pt_pos, kf_mp=kf_mp)


def global_ba(cam: CameraModel, ms: M.MapState, fixed_kf: int = 0, scale_factor: float = 2.0,
              iters: int = 10, max_obs: int = 16) -> M.MapState:
    """Full-map BA with one gauge-fixing keyframe slot. At K > ZT_MAX_K
    keyframe slots, K3 runs its emit_zt=False branch."""
    cam_active = ms.kf_valid & (torch.arange(ms.K, device=ms.device) != fixed_kf)
    obs_kf, obs_kp = M.build_obs_lists(ms, max_obs)
    res = bundle_adjust(cam, ms, cam_active, ms.pt_valid, scale_factor=scale_factor,
                        iters1=iters // 2, iters2=iters, max_obs=max_obs, obs_kf=obs_kf,
                        obs_kp=obs_kp)
    return apply_ba_result(ms, res, obs_kf, obs_kp)
