"""Local mapping: observation fusion, point culling, keyframe culling and
epipolar triangulation (port of sdslam_tpu/mapping/local_mapping.py)."""

from __future__ import annotations

import torch

from sdslam_tpu_torch._util import as_device, put, scatter_min, scatter_set, take, topk_stable
from sdslam_tpu_torch.features import matching
from sdslam_tpu_torch.geometry import lie
from sdslam_tpu_torch.geometry.camera import CameraModel
from sdslam_tpu_torch.mapping import map_state as M
from sdslam_tpu_torch.ops import hamming as ham

INT32_MAX = 2**31 - 1


def _fuse_into_kf(cam: CameraModel, ms: M.MapState, kf_slot, q_pt_ids, scale_factor: float,
                  obs_cnt=None, radius: float = 3.0, th_desc: int = ham.TH_LOW,
                  prefer_query: bool = False):
    """Project candidate points into one keyframe and bind matches. Returns
    (new kf_mp row [N], replace_map [P] int32, -1 default): a free matched
    keypoint takes the point; a keypoint holding a different point merges
    the two (the one with fewer observers loses)."""
    P, dev = ms.P, ms.device
    s = M._idx(kf_slot, dev)
    q_safe = torch.clamp(q_pt_ids, 0, P - 1).long()
    q_ok = (q_pt_ids >= 0) & ms.pt_valid[q_safe]
    row = take(ms.kf_mp, s)
    bound = scatter_set(torch.zeros(P, dtype=torch.bool, device=dev),
                        torch.where(row >= 0, row, P), True)
    q_ok = q_ok & ~bound[q_safe]
    Q = q_pt_ids.shape[0]
    ar = torch.arange(Q, dtype=torch.int32, device=dev)
    first = scatter_min(torch.full((P,), Q, dtype=torch.int32, device=dev),
                        torch.where(q_ok, q_safe, P), ar)
    q_ok = q_ok & (first[q_safe] == ar)
    res = matching.search_by_projection(
        cam, take(ms.kf_Tcw, s), ms.pt_pos[q_safe], ms.pt_desc[q_safe], q_ok,
        torch.zeros_like(q_safe), take(ms.kf_uv_und, s), take(ms.kf_desc, s),
        take(ms.kf_kp_valid, s), take(ms.kf_octave, s),
        radius_px=radius, th_desc=th_desc, scale_factor=scale_factor,
    )
    kq = res.kp_to_query
    matched_pt = torch.where(kq >= 0, q_pt_ids[torch.clamp(kq, 0, Q - 1).long()],
                             torch.full_like(kq, -1))
    if obs_cnt is None:
        obs_cnt = M.point_obs_count(ms)
    free = (row < 0) & (matched_pt >= 0)
    new_row = torch.where(free, matched_pt, row)
    dup = (row >= 0) & (matched_pt >= 0) & (row != matched_pt)
    a = torch.clamp(row, 0, P - 1).long()
    b = torch.clamp(matched_pt, 0, P - 1).long()
    if prefer_query:
        keep_row = torch.zeros_like(dup)
    else:
        keep_row = obs_cnt[a] >= obs_cnt[b]
    loser = torch.where(dup, torch.where(keep_row, b, a), P)
    winner = torch.where(dup, torch.where(keep_row, a, b), -1).to(torch.int32)
    replace_map = scatter_set(torch.full((P,), -1, dtype=torch.int32, device=dev), loser, winner)
    new_row = torch.where(dup & ~keep_row, matched_pt, new_row)
    return new_row, replace_map


def fuse_neighbors(cam: CameraModel, ms: M.MapState, kf_slot, scale_factor: float = 2.0,
                   n_neighbors: int = 3, covis=None, obs_cnt=None) -> M.MapState:
    """SearchInNeighbors: two-way observation fusion between a keyframe and
    its top covisible neighbours; direction B's searches all read the same
    post-A map, and every replace map is composed and applied once."""
    dev, P = ms.device, ms.P
    s = M._idx(kf_slot, dev)
    cov = M.covisibility(ms) if covis is None else covis
    w = put(take(cov, s), s, torch.full((), -1, dtype=cov.dtype, device=dev))
    _, neigh = topk_stable(w, n_neighbors)
    neigh_ok = w[neigh] > 0
    neigh_pts = ms.kf_mp[neigh].reshape(-1)
    neigh_pts = torch.where(neigh_ok.repeat_interleave(ms.N), neigh_pts,
                            torch.full_like(neigh_pts, -1))
    if obs_cnt is None:
        obs_cnt = M.point_obs_count(ms)
    new_row, rep_a = _fuse_into_kf(cam, ms, s, neigh_pts, scale_factor, obs_cnt=obs_cnt)
    ms = ms._replace(kf_mp=put(ms.kf_mp, s, new_row))

    own_win = rep_a[torch.clamp(new_row, 0, P - 1).long()]
    own_pts = torch.where((new_row >= 0) & (own_win >= 0), own_win, new_row)
    results = [_fuse_into_kf(cam, ms, neigh[i], own_pts, scale_factor, obs_cnt=obs_cnt)
               for i in range(n_neighbors)]
    for i in range(n_neighbors):
        slot_i = neigh[i]
        row_i = torch.where(neigh_ok[i], results[i][0], take(ms.kf_mp, slot_i))
        ms = ms._replace(kf_mp=put(ms.kf_mp, slot_i, row_i))
    ar = torch.arange(P, dtype=torch.int32, device=dev)
    total = rep_a
    for i in range(n_neighbors):
        rep_i = torch.where(neigh_ok[i], results[i][1], torch.full_like(results[i][1], -1))
        cur = torch.where(total >= 0, total, ar)
        nxt = rep_i[cur.long()]
        total = torch.where(nxt >= 0, nxt, total)
    total = torch.where(total == ar, torch.full_like(total, -1), total)
    return M.replace_points(ms, total)


def cull_points(ms: M.MapState, min_found_ratio: float = 0.25, min_obs_after: int = 2,
                age_window: int = 2, obs_cnt=None) -> M.MapState:
    """MapPointCulling: a recent point dies on a found-ratio < 0.25, or when
    still under-observed `age_window` keyframes after creation."""
    obs = M.point_obs_count(ms) if obs_cnt is None else obs_cnt
    age = ms.next_kf_id - ms.pt_first_kf
    found_ratio = ms.pt_found.to(torch.float32) / torch.clamp(ms.pt_visible.to(torch.float32),
                                                              min=1.0)
    young = age <= age_window + 1
    bad = (found_ratio < min_found_ratio) & (age >= 2)
    bad = bad | ((age >= age_window) & (age <= age_window + 2) & (obs < min_obs_after))
    return M.remove_points(ms, ms.pt_valid & young & bad)


def cull_keyframes(ms: M.MapState, protect_slot, redundancy: float = 0.9, max_obs: int = 16,
                   obs_lists=None, rows_mask=None, max_rows: int = 16,
                   covis=None) -> M.MapState:
    """KeyFrameCulling: cull (at most) the most redundant candidate KF whose
    points are >= 90% observed by >= 3 other KFs at the same or finer scale."""
    K, dev = ms.K, ms.device
    obs_kf, obs_kp = M.build_obs_lists(ms, max_obs) if obs_lists is None else obs_lists
    if rows_mask is None:
        rows_mask = ms.kf_valid
    R = min(max_rows, K)
    row_idx, row_in, _ = M.compact_indices(rows_mask & ms.kf_valid, R)
    row_l = row_idx.long()
    kf_safe = torch.clamp(obs_kf, 0, K - 1).long()
    kp_safe = torch.clamp(obs_kp, 0, ms.N - 1).long()
    oct_obs = ms.kf_octave[kf_safe, kp_safe]
    pack_pm = torch.where(obs_kf >= 0, (obs_kf + 1) * 16 + torch.clamp(oct_obs, 0, 15),
                          torch.zeros_like(obs_kf))
    own_oct = ms.kf_octave[row_l]
    mp_r = ms.kf_mp[row_l]
    pt_has = (mp_r >= 0) & ms.kf_kp_valid[row_l] & row_in[:, None]
    pk = pack_pm[torch.clamp(mp_r, 0, ms.P - 1).long()]  # [R,N,M]
    obs_kf_pn = pk // 16 - 1
    fine = (obs_kf_pn >= 0) & (obs_kf_pn != row_idx[:, None, None]) & (
        pk % 16 <= own_oct[:, :, None] + 1)
    redundant = pt_has & (fine.sum(-1) >= 3)
    n_obs_kf = pt_has.sum(1)
    ratio = redundant.sum(1) / torch.clamp(n_obs_kf, min=1)
    candidate = row_in & (ratio > redundancy) & (n_obs_kf > 0)
    candidate = candidate & (row_idx != as_device(protect_slot, row_idx.dtype, dev))
    le = ms.loop_edges
    is_loop_kf = scatter_set(torch.zeros(K, dtype=torch.bool, device=dev),
                             torch.where(le >= 0, le, K), True)
    candidate = candidate & ~is_loop_kf[row_l]
    oldest = torch.argmin(torch.where(ms.kf_valid, ms.kf_frame_id,
                                      torch.full_like(ms.kf_frame_id, INT32_MAX)))
    candidate = candidate & (row_l != oldest)
    best = torch.argmax(torch.where(candidate, ratio, torch.full_like(ratio, -1.0)))
    kill_slot = torch.where(candidate.any(), row_l[best], K)
    kill = scatter_set(torch.zeros(K, dtype=torch.bool, device=dev), kill_slot.reshape(1), True)
    return M.remove_keyframes(ms, kill, covis=covis)


def _fundamental_from_poses(cam: CameraModel, T1w, T2w):
    """F12 with x2^T F12 x1 = 0."""
    T21 = T2w @ lie.se3_inv(T1w)
    Kinv = torch.linalg.inv_ex(cam.K(T1w.device))[0]  # inv() would sync to check
    E = lie.hat(T21[:3, 3]) @ T21[:3, :3]
    return Kinv.T @ E @ Kinv


def triangulate_new_points(cam: CameraModel, ms: M.MapState, kf_slot, scale_factor: float = 2.0,
                           n_levels: int = 5, n_neighbors: int = 3, th_desc: int = ham.TH_LOW,
                           covis=None, update_stats: bool = True) -> M.MapState:
    """Epipolar-search triangulation against covisible neighbours: unbound
    keypoints matched along epipolar lines, DLT-triangulated and gated by
    cheirality, parallax, reprojection and baseline."""
    from sdslam_tpu_torch.solvers.initializer import triangulate_linear as dlt

    dev, N = ms.device, ms.N
    s = M._idx(kf_slot, dev)
    K_mat = cam.K(dev)
    cov = M.covisibility(ms) if covis is None else covis
    w = put(take(cov, s), s, torch.full((), -1, dtype=cov.dtype, device=dev))
    _, neigh = topk_stable(w, n_neighbors)
    neigh_ok = w[neigh] > 0
    T1 = take(ms.kf_Tcw, s)
    uv1 = take(ms.kf_uv_und, s)
    d1 = take(ms.kf_desc, s)
    oct1 = take(ms.kf_octave, s)
    ones = torch.ones((N, 1), device=dev)
    O1 = lie.se3_t(lie.se3_inv(T1))
    for i in range(n_neighbors):
        nb = neigh[i]
        T2 = take(ms.kf_Tcw, nb)
        O2 = lie.se3_t(lie.se3_inv(T2))
        b = torch.linalg.norm(O1 - O2)
        free1 = take(ms.kf_kp_valid, s) & (take(ms.kf_mp, s) < 0)
        free2 = take(ms.kf_kp_valid, nb) & (take(ms.kf_mp, nb) < 0)
        uv2_all = take(ms.kf_uv_und, nb)
        oct2_all = take(ms.kf_octave, nb)
        F12 = _fundamental_from_poses(cam, T1, T2)
        lines2 = torch.cat([uv1, ones], -1) @ F12.T
        num = torch.abs(lines2 @ torch.cat([uv2_all, ones], -1).T)
        den = torch.sqrt(torch.clamp(lines2[:, 0] ** 2 + lines2[:, 1] ** 2, min=1e-9))[:, None]
        sigma2 = scale_factor ** (2.0 * oct2_all.to(torch.float32))
        mask = free1[:, None] & free2[None, :] & (num / den < 3.84 * torch.sqrt(sigma2)[None, :])
        dbest, jbest, _ = ham.masked_best2(d1, take(ms.kf_desc, nb), mask)
        okm = free1 & (dbest <= th_desc)
        j = torch.clamp(jbest, 0, N - 1)
        uv2 = uv2_all[j]
        Xw = dlt(K_mat @ T1[:3, :4], K_mat @ T2[:3, :4], uv1, uv2)
        Xc1 = lie.se3_apply(T1, Xw)
        Xc2 = lie.se3_apply(T2, Xw)
        z1, z2 = Xc1[:, 2], Xc2[:, 2]
        r1 = Xw - O1
        r2 = Xw - O2
        cosp = torch.sum(r1 * r2, -1) / torch.clamp(
            torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-9)
        zs1 = torch.clamp(z1, min=1e-9)
        zs2 = torch.clamp(z2, min=1e-9)
        u1 = cam.fx * Xc1[:, 0] / zs1 + cam.cx
        v1 = cam.fy * Xc1[:, 1] / zs1 + cam.cy
        u2 = cam.fx * Xc2[:, 0] / zs2 + cam.cx
        v2 = cam.fy * Xc2[:, 1] / zs2 + cam.cy
        e1 = (u1 - uv1[:, 0]) ** 2 + (v1 - uv1[:, 1]) ** 2
        e2 = (u2 - uv2[:, 0]) ** 2 + (v2 - uv2[:, 1]) ** 2
        s1 = scale_factor ** (2.0 * oct1.to(torch.float32))
        s2 = scale_factor ** (2.0 * oct2_all[j].to(torch.float32))
        good = (okm & neigh_ok[i] & (z1 > 0.05) & (z2 > 0.05) & (cosp < 0.9998)
                & (e1 < 5.991 * s1) & (e2 < 5.991 * s2) & (b > 0.01))
        ms, ids = M.create_points(ms, s, good, Xw)
        created = ids >= 0
        row = scatter_set(take(ms.kf_mp, nb), torch.where(created, j, N), ids)
        ms = ms._replace(kf_mp=put(ms.kf_mp, nb, row))
    if update_stats:
        ms = M.finalize_point_statistics(ms, scale_factor, n_levels)
    return ms
