"""Distributed bundle adjustment over the ranks of a process group (port of
sdslam_tpu/parallel/dist_ba.py).

Landmarks and their observation blocks are split over the ranks; each rank
runs the single-device BA's edge pass and per-point elimination on its
points (solvers/ba.py `_prep_edges` -> `_schur_terms`: kernel K3 on the
card), the reduced camera system S [6K,6K] and gradient are summed over
the ranks with one all-reduce, the damped dense solve is replicated on
every rank (`_apply_prior_and_solve`: kernel K6 while 6K <= its N_MAX, the
library solve above) and each rank back-substitutes its own points.

Communication per iteration: one all-reduce of 6K*6K + 6K floats,
independent of the number of points.
"""

from __future__ import annotations

import numpy as np
import torch

from sdslam_tpu_torch.geometry import lie
from sdslam_tpu_torch.geometry.camera import CameraModel
from sdslam_tpu_torch.mapping import map_state as M
from sdslam_tpu_torch.parallel import multihost as mh
from sdslam_tpu_torch.solvers import ba as ba_mod


def make_distributed_gn_step(cam: CameraModel, K: int, scale_factor: float = 2.0,
                             use_huber: bool = True, lm_lambda: float = 1e-4, group=None):
    """One distributed GN iteration. Point-indexed arguments are this
    rank's shard, camera arguments replicated:
      step(kf_Tcw, pt_pos, obs_kf, obs_kp, obs_ok, kf_uv_und, kf_uright,
           kf_octave, cam_active, pt_active) -> (kf_Tcw', pt_pos')
    (S0, bs) are plain sums over edges and are summed over the ranks;
    (Hpp_inv, W, ybp) are point-local and never leave the rank. The
    damping prior scales with the summed system's trace, so it applies
    after the sum."""

    def step(kf_Tcw, pt_pos, obs_kf, obs_kp, obs_ok, kf_uv_und, kf_uright, kf_octave,
             cam_active, pt_active):
        es = ba_mod._prep_edges(obs_kf, obs_kp, kf_uv_und, kf_uright, kf_octave, scale_factor, K)
        S0, bs, Hpp_inv, W_pm, ybp, _, Uflat = ba_mod._schur_terms(
            cam, kf_Tcw, pt_pos, es, obs_ok, cam_active, pt_active, use_huber, lm_lambda)
        S0 = mh.all_reduce_sum(S0, group)
        bs = mh.all_reduce_sum(bs, group)
        dc = ba_mod._apply_prior_and_solve(S0, bs, cam_active, lm_lambda, K)
        dp = ba_mod._back_substitute(dc, Uflat, W_pm, Hpp_inv, ybp, pt_active)
        kf_new = torch.where(cam_active[:, None, None], lie.se3_exp(dc) @ kf_Tcw, kf_Tcw)
        return kf_new, pt_pos + dp

    return step


def _pad_rows(x: torch.Tensor, n: int, value) -> torch.Tensor:
    """x with rows of `value` appended up to n rows."""
    if x.shape[0] == n:
        return x
    pad = torch.full((n - x.shape[0],) + tuple(x.shape[1:]), value, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])


def gn_steps(cam: CameraModel, kf_Tcw, pt_pos, obs_kf, obs_kp, obs_ok, kf_uv_und, kf_uright,
             kf_octave, cam_active, pt_active, iters: int, scale_factor: float = 2.0,
             group=None):
    """`iters` distributed GN iterations of a whole problem given on every
    rank (full point arrays, replicated camera arrays, all tensors on one
    device). Points are padded with inactive rows up to a multiple of the
    world size, split, iterated and gathered. Returns (kf_Tcw [K,4,4],
    pt_pos [P,3]), the same on every rank."""
    K, P = kf_Tcw.shape[0], pt_pos.shape[0]
    w, _ = mh.world(group)
    Pp = -(-P // w) * w  # inactive padding points: the shards must be equal
    pts = (_pad_rows(pt_pos, Pp, 0.0), _pad_rows(obs_kf, Pp, -1), _pad_rows(obs_kp, Pp, 0),
           _pad_rows(obs_ok, Pp, False), _pad_rows(pt_active, Pp, False))
    X, okf, okp, ook, pact = (mh.global_put(a, mh.SHARDED, a.device, group) for a in pts)
    step = make_distributed_gn_step(cam, K, scale_factor, group=group)
    T = kf_Tcw
    for _ in range(iters):
        T, X = step(T, X, okf, okp, ook, kf_uv_und, kf_uright, kf_octave, cam_active, pact)
    return T, mh.gather_rows(X, group)[:P]


def distributed_bundle_adjust(cam: CameraModel, ms: M.MapState, cam_active, pt_active,
                              iters: int = 10, scale_factor: float = 2.0, max_obs: int = 8,
                              group=None) -> M.MapState:
    """Full distributed BA over a MapState held by every rank."""
    obs_kf, obs_kp = M.build_obs_lists(ms, max_obs)
    obs_ok = obs_kf >= 0
    n_obs = obs_ok.sum(1)
    ur = ms.kf_uright[torch.clamp(obs_kf, 0, ms.K - 1).long(),
                      torch.clamp(obs_kp, 0, ms.N - 1).long()]
    n_stereo = (obs_ok & (ur >= 0)).sum(1)
    pt_act = pt_active & ms.pt_valid & ((n_obs >= 2) | (n_stereo >= 1))
    obs_ok = obs_ok & pt_act[:, None]
    cam_act = cam_active & ms.kf_valid
    T, X = gn_steps(cam, ms.kf_Tcw, ms.pt_pos, obs_kf, obs_kp, obs_ok, ms.kf_uv_und,
                    ms.kf_uright, ms.kf_octave, cam_act, pt_act, iters, scale_factor, group)
    return ms._replace(kf_Tcw=T, pt_pos=X)


# -- rank bodies (multihost.launch) ------------------------------------------------


def rank_bundle_adjust(device, cam: CameraModel, ms_np: dict, cam_active, pt_active,
                       iters: int = 10):
    """One rank of `distributed_bundle_adjust` on a map given as numpy
    (interop.map_state_to_numpy); returns {"kf_Tcw", "pt_pos", "ms",
    "launches"} (arrays as numpy)."""
    from sdslam_tpu_torch import interop

    ms = interop.map_state_from_numpy(ms_np, device)
    ca = torch.as_tensor(np.asarray(cam_active), device=device)
    pa = torch.as_tensor(np.asarray(pt_active), device=device)
    out, stats = mh.measure(device, lambda: distributed_bundle_adjust(
        cam, ms, ca, pa, iters=iters, group=mh.global_mesh()))
    return {"kf_Tcw": mh.fetch_replicated(out.kf_Tcw), "pt_pos": mh.fetch_replicated(out.pt_pos),
            **stats}


def rank_gn_steps(device, cam: CameraModel, problem, cam_active, iters: int):
    """One rank of `gn_steps` on a make_dist_ba_problem tuple (io/synthetic,
    numpy), every point active; returns {"T", "X", "ms", "launches"}."""
    T0, X0, obs_kf, obs_kp, kf_uv, kf_ur, kf_oct = (torch.as_tensor(np.asarray(a), device=device)
                                                    for a in problem[:7])
    ca = torch.as_tensor(np.asarray(cam_active), device=device)
    pa = torch.ones(X0.shape[0], dtype=torch.bool, device=device)
    group = mh.global_mesh()
    (T, X), stats = mh.measure(device, lambda: gn_steps(
        cam, T0, X0, obs_kf, obs_kp, obs_kf >= 0, kf_uv, kf_ur, kf_oct, ca, pa, iters,
        group=group))
    return {"T": mh.fetch_replicated(T), "X": mh.fetch_replicated(X), **stats}
