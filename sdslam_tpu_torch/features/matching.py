"""Geometric descriptor-matching routines (port of
sdslam_tpu/features/matching.py: the searches of RGB-D tracking,
relocalization and loop closing).

Each routine is a dense masked computation over fixed-capacity arrays:
project -> geometric gating mask -> per-query best two of the masked
Hamming distances (kernel K4) -> per-target conflict resolution.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from sdslam_tpu_torch.geometry import camera as cam_mod
from sdslam_tpu_torch.geometry import lie
from sdslam_tpu_torch.geometry.camera import CameraModel
from sdslam_tpu_torch.ops import hamming as ham


class MatchResult(NamedTuple):
    """Assignment target-keypoint -> query index (-1 = unmatched)."""

    kp_to_query: torch.Tensor  # [N] int32
    kp_dist: torch.Tensor  # [N] int32 (BIG where unmatched)

    @property
    def matched(self):
        return self.kp_to_query >= 0

    def count(self):
        return torch.sum(self.matched)


def window_match(
    uv_proj, q_desc, q_valid, kp_uv, kp_desc, kp_valid, radius, th_desc: int,
    q_octave=None, kp_octave=None,
    octave_window: Optional[Tuple[int, int]] = None,
    ratio: Optional[float] = None,
    q_angle=None, kp_angle=None, use_rotation: bool = False,
) -> MatchResult:
    """Core windowed projection match."""
    Q = q_desc.shape[0]
    N = kp_desc.shape[0]
    radius = torch.broadcast_to(torch.as_tensor(radius, dtype=torch.float32,
                                                device=uv_proj.device), (Q,))
    du = torch.abs(uv_proj[:, None, 0] - kp_uv[None, :, 0])
    dv = torch.abs(uv_proj[:, None, 1] - kp_uv[None, :, 1])
    mask = (du <= radius[:, None]) & (dv <= radius[:, None])
    mask &= q_valid[:, None] & kp_valid[None, :]
    if octave_window is not None and q_octave is not None and kp_octave is not None:
        lo, hi = octave_window
        mask &= (kp_octave[None, :] >= q_octave[:, None] + lo) & (
            kp_octave[None, :] <= q_octave[:, None] + hi
        )
    d1, j1, d2 = ham.masked_best2(q_desc, kp_desc, mask)
    ok = q_valid & (d1 <= th_desc)
    if ratio is not None:
        ok &= d1.to(torch.float32) < ratio * d2.to(torch.float32)
    kp_to_q, kp_d = ham.resolve_to_targets(j1, d1, ok, N)
    if use_rotation and q_angle is not None and kp_angle is not None:
        matched = kp_to_q >= 0
        dtheta = q_angle[torch.clamp(kp_to_q, 0, Q - 1).long()] - kp_angle
        keep = ham.rotation_consistency(dtheta, matched)
        kp_to_q = torch.where(keep, kp_to_q, torch.full_like(kp_to_q, -1))
        kp_d = torch.where(keep, kp_d, torch.full_like(kp_d, ham.BIG))
    return MatchResult(kp_to_q, kp_d)


def search_by_projection(
    cam: CameraModel, Tcw, q_pos_w, q_desc, q_valid, q_octave,
    kp_uv, kp_desc, kp_valid, kp_octave, radius_px: float,
    th_desc: int = ham.TH_HIGH, scale_factor: float = 2.0,
    octave_window: Tuple[int, int] = (-1, 1),
    q_angle=None, kp_angle=None, use_rotation: bool = False, border: float = 5.0,
) -> MatchResult:
    """Project world points into the frame and window-match (window scaled
    by the query point's octave, octave gate [oct-1, oct+1])."""
    Xc = lie.se3_apply(Tcw, q_pos_w)
    uv, z = cam_mod.project(cam, Xc)
    vis = q_valid & (z > 0.05) & cam_mod.in_image(cam, uv, border)
    radius = radius_px * scale_factor ** q_octave.to(torch.float32)
    return window_match(
        uv, q_desc, vis, kp_uv, kp_desc, kp_valid, radius, th_desc,
        q_octave=q_octave, kp_octave=kp_octave, octave_window=octave_window,
        q_angle=q_angle, kp_angle=kp_angle, use_rotation=use_rotation,
    )


def predict_octave(dist, max_dist, scale_factor: float, n_levels: int):
    """MapPoint::PredictScale: octave from max-distance / distance ratio."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-6), min=1.0)
    lvl = torch.ceil(torch.log(ratio) / torch.log(torch.tensor(scale_factor))).to(torch.int32)
    return torch.clamp(lvl, 0, n_levels - 1)


def search_local_points(
    cam: CameraModel, Tcw, p_pos_w, p_desc, p_valid, p_normal, p_min_dist, p_max_dist,
    kp_uv, kp_desc, kp_valid, kp_octave, th_radius, scale_factor: float, n_levels: int,
    th_desc: int = ham.TH_HIGH, ratio: float = 0.8, view_cos_limit: float = 0.5,
) -> MatchResult:
    """TrackLocalMap search: frustum + view-angle + scale-band gating, then
    windowed match with a ratio test."""
    Xc = lie.se3_apply(Tcw, p_pos_w)
    uv, z = cam_mod.project(cam, Xc)
    PO = p_pos_w - lie.se3_t(lie.se3_inv(Tcw))[None, :]
    dist = torch.linalg.norm(PO, dim=-1)
    view_cos = torch.sum(PO * p_normal, dim=-1) / torch.clamp(dist, min=1e-6)
    vis = (
        p_valid & (z > 0.05) & cam_mod.in_image(cam, uv, 5.0)
        & (dist >= p_min_dist * 0.8) & (dist <= p_max_dist * 1.2)
        & (view_cos > view_cos_limit)
    )
    oct_pred = predict_octave(dist, p_max_dist, scale_factor, n_levels)
    r = torch.where(view_cos > 0.998, torch.full_like(dist, 2.5), torch.full_like(dist, 4.0))
    radius = r * th_radius * scale_factor ** oct_pred.to(torch.float32)
    return window_match(
        uv, p_desc, vis, kp_uv, kp_desc, kp_valid, radius, th_desc,
        q_octave=oct_pred, kp_octave=kp_octave, octave_window=(-1, 1), ratio=ratio,
    )


def search_for_initialization(
    f1_uv, f1_desc, f1_valid, f1_octave, f1_angle,
    f2_uv, f2_desc, f2_valid, f2_octave, f2_angle,
    window: float = 100.0, th_desc: int = ham.TH_LOW, ratio: float = 0.9,
) -> MatchResult:
    """Monocular-initialization window search around identical coordinates,
    level-0 keypoints only, with the rotation-consistency filter. Returns
    the f2-keypoint -> f1-keypoint assignment."""
    return window_match(
        f1_uv, f1_desc, f1_valid & (f1_octave == 0), f2_uv, f2_desc, f2_valid & (f2_octave == 0),
        window, th_desc, ratio=ratio, q_angle=f1_angle, kp_angle=f2_angle, use_rotation=True,
    )


def search_by_sim3(
    cam: CameraModel,
    S12,  # [4,4] Sim3 mapping cam-2 coordinates into cam-1
    uv1, desc1, valid1, oct1, X1c,  # KF1 keypoints and bound points in its frame
    uv2, desc2, valid2, oct2, X2c,  # KF2 likewise
    radius_px: float = 7.5,
    th_desc: int = ham.TH_HIGH,
    scale_factor: float = 2.0,
) -> MatchResult:
    """Mutual Sim3-guided matching between two keyframes' bound points:
    project each side's points into the other image through S12, window
    match in both directions, keep the pairs both directions agree on.
    Returns the KF2-keypoint -> KF1-keypoint assignment."""
    # direction A: KF2 points into image 1 (targets: KF1 keypoints)
    uvA, zA = cam_mod.project(cam, lie.sim3_apply(S12, X2c))
    visA = valid2 & (zA > 0.05) & cam_mod.in_image(cam, uvA, 5.0)
    rA = window_match(uvA, desc2, visA, uv1, desc1, valid1,
                      radius_px * scale_factor ** oct2.to(torch.float32), th_desc,
                      q_octave=oct2, kp_octave=oct1, octave_window=(-1, 1))
    # direction B: KF1 points into image 2 (targets: KF2 keypoints)
    uvB, zB = cam_mod.project(cam, lie.sim3_apply(lie.sim3_inv(S12), X1c))
    visB = valid1 & (zB > 0.05) & cam_mod.in_image(cam, uvB, 5.0)
    rB = window_match(uvB, desc1, visB, uv2, desc2, valid2,
                      radius_px * scale_factor ** oct1.to(torch.float32), th_desc,
                      q_octave=oct1, kp_octave=oct2, octave_window=(-1, 1))
    j = rB.kp_to_query
    N1 = desc1.shape[0]
    back = rA.kp_to_query[torch.clamp(j, 0, N1 - 1).long()]
    agree = (j >= 0) & (back == torch.arange(desc2.shape[0], device=j.device))
    return MatchResult(torch.where(agree, j, torch.full_like(j, -1)),
                       torch.where(agree, rB.kp_dist, torch.full_like(rB.kp_dist, ham.BIG)))


def search_brute_force(q_desc, q_valid, t_desc, t_valid, th_desc: int = ham.TH_LOW,
                       ratio: Optional[float] = 0.75, mutual: bool = True) -> MatchResult:
    """Brute-force descriptor matching (SearchByPoints, the BoW-free loop
    and relocalization matcher): a ratio test unless `ratio` is None, and
    the target's own best query must point back unless `mutual` is False.
    Returns the target -> query assignment."""
    mask = q_valid[:, None] & t_valid[None, :]
    dist = ham.masked_dist(q_desc, t_desc, mask)
    d1, j1, d2 = ham.best2(dist)
    ok = q_valid & (d1 <= th_desc)
    if ratio is not None:
        ok &= d1.to(torch.float32) < ratio * d2.to(torch.float32)
    if mutual:  # first minimum on both sides
        i1 = torch.argmin(dist, dim=0)
        ok &= i1[j1] == torch.arange(q_desc.shape[0], device=dist.device)
    return MatchResult(*ham.resolve_to_targets(j1, d1, ok, t_desc.shape[0]))
