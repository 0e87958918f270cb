"""Relocalization: recover a lost camera against the whole keyframe pool
(port of sdslam_tpu/pipeline/relocalization.py).

One batched alignment of the current frame against every keyframe slot
(kernel K5's batched level: all slots, one launch per pyramid level),
candidates ranked by photometric error, then the best few verified by
projection matching (K4) and pose GN (K2), with a brute-force descriptor +
EPnP-RANSAC fallback for views the photometric basin cannot reach (strong
in-plane rotation).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from sdslam_tpu_torch._util import scatter_set, take
from sdslam_tpu_torch.features import matching
from sdslam_tpu_torch.geometry import camera as cam_mod
from sdslam_tpu_torch.geometry import lie
from sdslam_tpu_torch.geometry.camera import CameraModel
from sdslam_tpu_torch.mapping import map_state as M
from sdslam_tpu_torch.ops import hamming as ham
from sdslam_tpu_torch.solvers import epnp, image_align, pose_opt

RELOC_ALIGN_MAX_ERROR = 0.01  # fast-mode accept threshold (ImageAlign.cc:36-39)


class RelocResult(NamedTuple):
    success: torch.Tensor  # bool scalar
    Tcw: torch.Tensor  # [4,4]
    assoc: torch.Tensor  # [N] keypoint -> point id
    n_inliers: torch.Tensor
    best_kf: torch.Tensor  # slot of the matched keyframe
    align_errors: torch.Tensor  # [K] per-keyframe photometric errors


def pool_alignment_inputs(cam: CameraModel, ms: M.MapState):
    """Per-slot (uv [K,N,2], X_ref [K,N,3], valid [K,N]) of every keyframe
    as an alignment reference: keypoints with depth and a bound point."""
    valid = ms.kf_kp_valid & (ms.kf_depth > 0) & (ms.kf_mp >= 0)
    X_ref = cam_mod.backproject(cam, ms.kf_uv_und, torch.clamp(ms.kf_depth, min=1e-3))
    return ms.kf_uv, X_ref, valid


def align_pool(cam: CameraModel, ms: M.MapState, cur_pyr, max_level: int, min_level: int,
               scale_factor: float, store_min_level: int, iters: int = 15):
    """Coarse alignment of every keyframe slot against one current pyramid
    (seeded at identity: the keyframe's own pose), `iters` GN iterations
    per level. Returns (T_rel [K,4,4], errors [K]); slots with < 50 valid
    pixels get inf (a vacuous 0/0 error must rank last, not first)."""
    uv, X_ref, valid = pool_alignment_inputs(cam, ms)
    res = image_align.align_batched(
        ms.kf_pyramid, cur_pyr, uv, X_ref, valid, torch.eye(4, device=ms.device),
        cam.fx, cam.fy, cam.cx, cam.cy, scale_factor=scale_factor, max_level=max_level,
        min_level=min_level, iters=iters, start_level=store_min_level,
    )
    err = torch.where(res.n_meas >= 50, res.error, torch.full_like(res.error, float("inf")))
    return res.T_cur_ref, err


def _verify_photometric(cam, ms, slot, T_rel, err, uv_und, desc, octave, kp_valid, uright,
                        inv_sigma2, scale_factor):
    """Projection matching + pose GN from the aligned pose, with the
    ORBdist second chance (wider window, relaxed descriptor gate, new
    matches only) when the first GN keeps < 50 inliers."""
    P, N = ms.P, ms.N
    T_init = T_rel @ take(ms.kf_Tcw, slot)
    q_pt = take(ms.kf_mp, slot)
    q_safe = torch.clamp(q_pt, 0, P - 1).long()
    q_ok = (q_pt >= 0) & ms.pt_valid[q_safe]
    neg = torch.full_like(q_pt, -1)
    res = matching.search_by_projection(
        cam, T_init, ms.pt_pos[q_safe], ms.pt_desc[q_safe], q_ok, torch.zeros_like(q_pt),
        uv_und, desc, kp_valid, octave, radius_px=8.0, th_desc=ham.TH_HIGH,
        scale_factor=scale_factor,
    )
    kq = res.kp_to_query
    assoc = torch.where(kq >= 0, q_pt[torch.clamp(kq, 0, N - 1).long()], neg)
    n_matches = (assoc >= 0).sum()
    opt = pose_opt.optimize_pose(cam, T_init, ms.pt_pos[torch.clamp(assoc, 0, P - 1).long()],
                                 uv_und, inv_sigma2, assoc >= 0, ur_obs=uright, rounds=4)
    assoc1 = torch.where((assoc >= 0) & opt.inliers, assoc, neg)
    used_pt = scatter_set(torch.zeros(P, dtype=torch.bool, device=ms.device),
                          torch.where(assoc1 >= 0, assoc1, P), True)
    q_ok2 = q_ok & ~used_pt[q_safe]
    res2 = matching.search_by_projection(
        cam, opt.Tcw, ms.pt_pos[q_safe], ms.pt_desc[q_safe], q_ok2, take(ms.kf_octave, slot),
        uv_und, desc, kp_valid & (assoc1 < 0), octave, radius_px=10.0,
        th_desc=100,  # ORBdist (ORBmatcher.cc:1310)
        scale_factor=scale_factor,
    )
    kq2 = res2.kp_to_query
    extra = torch.where(kq2 >= 0, q_pt[torch.clamp(kq2, 0, N - 1).long()], neg)
    merged = torch.where(assoc1 >= 0, assoc1, extra)
    opt2 = pose_opt.optimize_pose(cam, opt.Tcw, ms.pt_pos[torch.clamp(merged, 0, P - 1).long()],
                                  uv_und, inv_sigma2, merged >= 0, ur_obs=uright, rounds=2)
    retry = opt.n_inliers < 50
    n_inl = torch.where(retry, opt2.n_inliers, opt.n_inliers)
    Tcw = torch.where(retry, opt2.Tcw, opt.Tcw)
    final = torch.where(retry, torch.where((merged >= 0) & opt2.inliers, merged, neg),
                        torch.where((assoc >= 0) & opt.inliers, assoc, neg))
    ok = (n_matches >= 20) & (n_inl >= 10) & (err < RELOC_ALIGN_MAX_ERROR * 3)
    return ok, Tcw, final, n_inl


def _verify_epnp(cam, ms, slot, uv_und, desc, kp_valid, uright, inv_sigma2, generator):
    """Brute-force descriptor matching against the keyframe's bound points,
    EPnP-RANSAC, then pose GN on its inliers."""
    P, N = ms.P, ms.N
    row = take(ms.kf_mp, slot)
    v_kf = take(ms.kf_kp_valid, slot) & (row >= 0) & ms.pt_valid[torch.clamp(row, 0, P - 1).long()]
    res = matching.search_brute_force(take(ms.kf_desc, slot), v_kf, desc, kp_valid,
                                      th_desc=ham.TH_LOW, ratio=0.75)
    m = res.kp_to_query  # current-frame kp -> keyframe kp
    pt = torch.where(m >= 0, row[torch.clamp(m, 0, N - 1).long()], torch.full_like(m, -1))
    ok = (pt >= 0) & kp_valid
    Xw = ms.pt_pos[torch.clamp(pt, 0, P - 1).long()]
    pr = epnp.ransac_epnp(cam, Xw, uv_und, ok, generator=generator, n_hypotheses=64)
    opt = pose_opt.optimize_pose(cam, lie.se3_from_Rt(pr.R, pr.t), Xw, uv_und, inv_sigma2,
                                 ok & pr.inliers, ur_obs=uright, rounds=4)
    good = pr.success & (opt.n_inliers >= 10)
    final = torch.where(ok & pr.inliers & opt.inliers, pt, torch.full_like(pt, -1))
    return good, opt.Tcw, final, opt.n_inliers


def relocalize(cam: CameraModel, ms: M.MapState, uv_und, desc, octave, kp_valid, uright,
               pyr_cur: Tuple[torch.Tensor, ...], generator: Optional[torch.Generator] = None,
               scale_factor: float = 2.0, n_levels: int = 5, store_min_level: int = 2,
               n_verify: int = 3) -> RelocResult:
    """Batched alignment against every keyframe, then verification of the
    best `n_verify` candidates (photometric first, EPnP fallback; the
    photometric result wins when both succeed). `generator` draws the
    EPnP-RANSAC sets (one draw per candidate, in candidate order)."""
    T_rels, errors = align_pool(cam, ms, tuple(pyr_cur[store_min_level:]),
                                max_level=n_levels - 1, min_level=n_levels - 2,
                                scale_factor=scale_factor, store_min_level=store_min_level)
    errors = torch.where(ms.kf_valid, errors, torch.full_like(errors, float("inf")))
    order = torch.sort(errors, stable=True).indices[:n_verify]
    inv_sigma2 = 1.0 / scale_factor ** (2.0 * octave.to(torch.float32))

    def pick(results):
        oks, Ts, assocs, inls = (torch.stack(x) for x in zip(*results))
        score = torch.where(oks, inls, torch.full_like(inls, -1))
        best = torch.argmax(score)
        return (best, take(score, best) > 0, take(Ts, best), take(assocs, best),
                take(inls, best))

    photo = [_verify_photometric(cam, ms, order[i], take(T_rels, order[i]), take(errors, order[i]),
                                 uv_und, desc, octave, kp_valid, uright, inv_sigma2,
                                 scale_factor) for i in range(order.shape[0])]
    best, align_success, T_a, a_a, n_a = pick(photo)
    geo = [_verify_epnp(cam, ms, order[i], uv_und, desc, kp_valid, uright, inv_sigma2,
                        generator) for i in range(order.shape[0])]
    e_best, epnp_success, T_e, a_e, n_e = pick(geo)
    pick_i = torch.where(align_success, best, e_best)
    return RelocResult(
        success=align_success | epnp_success,
        Tcw=torch.where(align_success, T_a, T_e),
        assoc=torch.where(align_success, a_a, a_e),
        n_inliers=torch.where(align_success, n_a, n_e),
        best_kf=take(order, pick_i),
        align_errors=errors,
    )
