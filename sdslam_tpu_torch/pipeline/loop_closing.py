"""Loop detection, Sim3 verification and loop correction (port of
sdslam_tpu/pipeline/loop_closing.py).

  detect:  photometric alignment of the new keyframe against every
           keyframe slot at the coarsest level (kernel K5's batched level,
           all slots in one launch; no bag of words), candidates below an
           absolute bound, covisibility-group consistency over consecutive
           keyframes (th = 3) before verification;
  verify:  brute-force descriptor matching (K4), Horn Sim3 RANSAC,
           Sim3-guided mutual matching, Sim3 GN, and a final projection of
           the candidate's neighbourhood (>= 40 matches);
  correct: propagate the correction to the current keyframe's group, the
           Sim3 essential graph with the loop edge, seam fusion, and global
           BA (K3).

Detection and verification results reach the host through non-blocking
copies polled with CUDA events (the JAX package's copy_to_host_async and
is_ready): the frame loop reads a result only once its copy has landed.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from sdslam_tpu_torch._util import put, scatter_set, take, topk_stable
from sdslam_tpu_torch.features import matching
from sdslam_tpu_torch.geometry import lie
from sdslam_tpu_torch.geometry.camera import CameraModel
from sdslam_tpu_torch.mapping import local_mapping as LM
from sdslam_tpu_torch.mapping import map_state as M
from sdslam_tpu_torch.ops import hamming as ham
from sdslam_tpu_torch.pipeline.relocalization import align_pool
from sdslam_tpu_torch.solvers import ba, pose_graph, sim3_solver
from sdslam_tpu_torch.utils.profiling import span

LOOP_ALIGN_MAX_ERROR = 0.03  # KF<->KF coarse alignment bound (ImageAlign ctor)
# Candidates exclude only keyframes sharing >= 15 observations with the new
# one (the JAX package's deliberate divergence from the reference's covis > 0:
# organic drift bridges a few points across the seam before a loop closes).
LOOP_CANDIDATE_MIN_COVIS = 15


class LoopCandidate(NamedTuple):
    found: torch.Tensor  # bool
    cand_kf: torch.Tensor  # slot
    errors: torch.Tensor  # [K] all alignment errors


def detect_loop_candidates(cam: CameraModel, ms: M.MapState, kf_slot, covis,
                           scale_factor: float = 2.0, n_levels: int = 5,
                           store_min_level: int = 2, min_frame_gap: int = 30) -> LoopCandidate:
    """Coarsest-level alignment of keyframe kf_slot against every valid,
    non-connected keyframe that is not a temporal neighbour."""
    K, dev = ms.K, ms.device
    s = M._idx(kf_slot, dev)
    cur_pyr = tuple(take(pl, s) for pl in ms.kf_pyramid)
    _, errors = align_pool(cam, ms, cur_pyr, max_level=n_levels - 1, min_level=n_levels - 1,
                           scale_factor=scale_factor, store_min_level=store_min_level)
    ar = torch.arange(K, device=dev)
    connected = (take(covis, s) >= LOOP_CANDIDATE_MIN_COVIS) | (ar == s)
    recent = (ms.kf_frame_id - take(ms.kf_frame_id, s)).abs() < min_frame_gap
    errors = torch.where(ms.kf_valid & ~connected & ~recent, errors,
                         torch.full_like(errors, float("inf")))
    best = torch.argmin(errors)
    return LoopCandidate(take(errors, best) < LOOP_ALIGN_MAX_ERROR, best, errors)


class Sim3Verification(NamedTuple):
    accepted: torch.Tensor  # bool
    S_cur_cand: torch.Tensor  # [4,4] sim3 mapping cand-camera coords -> cur-camera
    n_inliers: torch.Tensor


def _points_seen_by(ms: M.MapState, rows):
    """[P] bool: valid points observed by the keyframes in rows [K]."""
    obs = M.observation_table(ms)
    contrib = torch.where((rows & ms.kf_valid)[:, None], obs, torch.full_like(obs, -1))
    hit = scatter_set(torch.zeros(ms.P, dtype=torch.bool, device=ms.device),
                      torch.where(contrib >= 0, contrib, ms.P), True)
    return hit


def verify_loop_sim3(cam: CameraModel, ms: M.MapState, cur_kf, cand_kf, covis, generator=None,
                     scale_factor: float = 2.0, fix_scale: bool = True,
                     min_inliers: int = 20, min_total: int = 40, sets=None) -> Sim3Verification:
    """ComputeSim3: brute-force matching -> Horn RANSAC (sets drawn from
    `generator`, or given as `sets` [128,3]) -> Sim3-guided mutual matching
    -> Sim3 GN (>= 20 inliers) -> projection of the candidate's covisible
    neighbourhood (covis [K,K]; >= 40 matches)."""
    P, N, dev = ms.P, ms.N, ms.device
    c, q = M._idx(cur_kf, dev), M._idx(cand_kf, dev)
    d1, d2 = take(ms.kf_desc, c), take(ms.kf_desc, q)
    mp1, mp2 = take(ms.kf_mp, c), take(ms.kf_mp, q)
    v1 = take(ms.kf_kp_valid, c) & (mp1 >= 0)
    v2 = take(ms.kf_kp_valid, q) & (mp2 >= 0)
    pair_cur = matching.search_brute_force(d1, v1, d2, v2, th_desc=ham.TH_LOW,
                                           ratio=0.75).kp_to_query  # cand kp -> cur kp
    X_cand_all = lie.se3_apply(take(ms.kf_Tcw, q), ms.pt_pos[torch.clamp(mp2, 0, P - 1).long()])
    X_cur_all = lie.se3_apply(take(ms.kf_Tcw, c), ms.pt_pos[torch.clamp(mp1, 0, P - 1).long()])

    def gather_pairs(pair):
        ps = torch.clamp(pair, 0, N - 1).long()
        ok = (pair >= 0) & (mp2 >= 0) & (mp1[ps] >= 0)
        return X_cand_all, X_cur_all[ps], ok

    X1, X2, ok = gather_pairs(pair_cur)
    oct_cand = take(ms.kf_octave, q).to(torch.float32)
    oct_cur_kp = take(ms.kf_octave, c)
    th2 = 9.21 * scale_factor ** (2.0 * oct_cand)
    r = sim3_solver.ransac_sim3(cam, X1, X2, ok, th2, th2, generator=generator, sets=sets,
                                n_hypotheses=128, fix_scale=fix_scale)
    S_ransac = lie.sim3_from_Rts(r.R, r.t, r.s)
    uv1, uv2 = take(ms.kf_uv_und, c), take(ms.kf_uv_und, q)
    ext = matching.search_by_sim3(cam, S_ransac, uv1, d1, v1, oct_cur_kp, X_cur_all,
                                  uv2, d2, v2, take(ms.kf_octave, q), X_cand_all,
                                  scale_factor=scale_factor)
    pair_all = torch.where(pair_cur >= 0, pair_cur, ext.kp_to_query)
    X1, X2, ok = gather_pairs(pair_all)
    pa = torch.clamp(pair_all, 0, N - 1).long()
    inv_sigma2_cur = 1.0 / scale_factor ** (2.0 * oct_cur_kp.to(torch.float32)[pa])
    opt = sim3_solver.optimize_sim3(cam, S_ransac, X2, X1, uv1[pa], uv2, inv_sigma2_cur,
                                    1.0 / scale_factor ** (2.0 * oct_cand), ok, th2=10.0,
                                    fix_scale=fix_scale)
    S = opt.S
    neigh = (take(covis, q) > 0) | (torch.arange(ms.K, device=dev) == q)
    in_hood = _points_seen_by(ms, neigh)
    T_corr = lie.sim3_to_se3(S @ lie.se3_to_sim3(take(ms.kf_Tcw, q)))
    hood = matching.search_by_projection(
        cam, T_corr, ms.pt_pos, ms.pt_desc, in_hood & ms.pt_valid,
        torch.zeros(P, dtype=torch.int32, device=dev), uv1, d1, take(ms.kf_kp_valid, c),
        oct_cur_kp, radius_px=10.0, th_desc=ham.TH_LOW, scale_factor=scale_factor,
        octave_window=None,
    )
    total = hood.count()
    accepted = (r.n_inliers >= min_inliers) & (opt.n_inliers >= min_inliers) & (total >= min_total)
    return Sim3Verification(accepted, S, opt.n_inliers)


def correct_loop_poses(ms: M.MapState, cur_kf, cand_kf, S_cur_cand, covis,
                       scale_factor: float = 2.0):
    """CorrectLoop: the current keyframe's pose from the loop measurement,
    the world-side correction propagated to its covisible group and their
    points, the essential graph optimized with the loop edge (candidate
    fixed), points re-anchored through their reference keyframes, and the
    loop edge stored. Returns (ms, n_dropped covisibility edges)."""
    K, dev = ms.K, ms.device
    c, q = M._idx(cur_kf, dev), M._idx(cand_kf, dev)
    T_cur_corr = S_cur_cand @ take(ms.kf_Tcw, q)
    S_w = lie.sim3_inv(T_cur_corr) @ take(ms.kf_Tcw, c)  # old world -> new world
    ar = torch.arange(K, device=dev)
    group = ((take(covis, c) >= 15) | (ar == c)) & ms.kf_valid
    kf_Tcw = torch.where(group[:, None, None], ms.kf_Tcw @ lie.sim3_inv(S_w), ms.kf_Tcw)
    pt_in_group = _points_seen_by(ms, group)
    pt_pos = torch.where((pt_in_group & ms.pt_valid)[:, None], lie.sim3_apply(S_w, ms.pt_pos),
                         ms.pt_pos)
    ms = ms._replace(kf_Tcw=kf_Tcw, pt_pos=pt_pos)
    edges, n_dropped = pose_graph.make_edges_from_covisibility(
        ms.kf_Tcw, ms.kf_valid, covis, ms.kf_parent,
        loop_i=c.reshape(1), loop_j=q.reshape(1), loop_S=S_cur_cand[None],
        stored_loops=ms.loop_edges, covis_min=100, max_edges=1024,
    )
    fixed = ar == q
    ref = torch.clamp(ms.pt_ref_kf, 0, K - 1).long()
    T_ref_before = ms.kf_Tcw[ref]
    S_opt = pose_graph.optimize_pose_graph(ms.kf_Tcw, ms.kf_valid, fixed, edges, iters=20,
                                           fix_scale=True)
    kf_Tcw_new = lie.sim3_to_se3(S_opt)
    # re-anchor: X' = T_after^-1 T_before X (point correction via its ref KF)
    Xc = lie.se3_apply(T_ref_before, ms.pt_pos)
    pt_pos2 = lie.se3_apply(lie.se3_inv(kf_Tcw_new[ref]), Xc)
    pt_pos2 = torch.where(ms.pt_valid[:, None], pt_pos2, ms.pt_pos)
    ms = ms._replace(kf_Tcw=kf_Tcw_new, pt_pos=pt_pos2)
    return M.add_loop_edge(ms, c, q), n_dropped


def fuse_loop_points(cam: CameraModel, ms: M.MapState, cur_kf, cand_kf, covis,
                     scale_factor: float = 2.0, n_group: int = 4) -> M.MapState:
    """SearchAndFuse: project the loop-side points (seen by the candidate's
    covisible neighbourhood) into the current keyframe and its top covisible
    keyframes, replacing current-side duplicates unconditionally."""
    K, P, dev = ms.K, ms.P, ms.device
    c, q = M._idx(cur_kf, dev), M._idx(cand_kf, dev)
    ar_p = torch.arange(P, dtype=torch.int32, device=dev)
    neigh = (take(covis, q) > 0) | (torch.arange(K, device=dev) == q)
    in_hood = _points_seen_by(ms, neigh)
    loop_pts = torch.where(in_hood & ms.pt_valid, ar_p, torch.full_like(ar_p, -1))
    w = put(take(covis, c), c, torch.full((), M.INT32_MAX, dtype=covis.dtype, device=dev))
    _, group = topk_stable(w, n_group)
    group_ok = ((take(covis, c)[group] >= 15) | (group == c)) & ms.kf_valid[group]
    obs_cnt = M.point_obs_count(ms)
    results = [LM._fuse_into_kf(cam, ms, group[i], loop_pts, scale_factor, obs_cnt=obs_cnt,
                                radius=4.0, prefer_query=True) for i in range(n_group)]
    for i in range(n_group):
        row_i = torch.where(group_ok[i], results[i][0], take(ms.kf_mp, group[i]))
        ms = ms._replace(kf_mp=put(ms.kf_mp, group[i], row_i))
    total = torch.full((P,), -1, dtype=torch.int32, device=dev)
    for i in range(n_group):
        rep_i = torch.where(group_ok[i], results[i][1], torch.full_like(results[i][1], -1))
        cur = torch.where(total >= 0, total, ar_p)
        nxt = rep_i[cur.long()]
        total = torch.where(nxt >= 0, nxt, total)
    total = torch.where(total == ar_p, torch.full_like(total, -1), total)
    # a loop point is never replaced away by a second group row's merge
    total = torch.where(in_hood & ms.pt_valid, torch.full_like(total, -1), total)
    return M.replace_points(ms, total)


class ConsistencyState(NamedTuple):
    """Covisibility-consistency state carried across keyframe events: row c
    holds the covisible group of candidate slot c from the previous
    detection round and its consistency count (-1: empty row)."""

    mask: torch.Tensor  # [K,K] bool
    count: torch.Tensor  # [K] int32


def init_consistency(K: int, device) -> ConsistencyState:
    return ConsistencyState(torch.zeros((K, K), dtype=torch.bool, device=device),
                            torch.zeros((K,), dtype=torch.int32, device=device))


# layout of the packed detection readback (one small copy per keyframe event)
DET_FOUND = 0  # any candidate below the absolute bound
DET_N_CAND = 1  # candidate count this round
DET_TOP = 2  # 3x (slot, error, enough) for the best candidates
DET_LEN = 2 + 3 * 3


def detect_and_consistency(cam: CameraModel, ms: M.MapState, kf_slot, cons: ConsistencyState,
                           scale_factor: float = 2.0, n_levels: int = 5,
                           store_min_level: int = 2, min_frame_gap: int = 30,
                           consistency_th: int = 3):
    """Loop detection + covisibility-consistency bookkeeping, all on the
    device (DetectLoop). Returns (packed [DET_LEN] f32, new
    ConsistencyState, covis)."""
    K, dev = ms.K, ms.device
    covis = M.covisibility(ms)
    cand = detect_loop_candidates(cam, ms, kf_slot, covis, scale_factor=scale_factor,
                                  n_levels=n_levels, store_min_level=store_min_level,
                                  min_frame_gap=min_frame_gap)
    errors = cand.errors
    best_err = take(errors, cand.cand_kf)
    is_cand = (errors <= 1.5 * best_err) & (errors < LOOP_ALIGN_MAX_ERROR)
    found = is_cand.any()
    groups = ((covis > 0) | torch.eye(K, dtype=torch.bool, device=dev)) & ms.kf_valid[None, :]
    # overlap[c, g]: candidate c's group shares a keyframe with previous group g
    overlap = (groups.to(torch.float32) @ cons.mask.T.to(torch.float32)) > 0
    prev_alive = cons.count >= 0
    inherit = torch.where(overlap & prev_alive[None, :], cons.count[None, :] + 1,
                          torch.zeros_like(overlap, dtype=torch.int32)).amax(1)
    cnt = torch.where(is_cand, inherit, torch.full_like(inherit, -1))
    enough = is_cand & (cnt + 1 >= consistency_th)
    # the candidates' groups replace the previous round's; an empty round
    # clears the history (LoopClosing.cc:216)
    new_mask = found & groups & is_cand[:, None]
    new_count = torch.where(found, cnt, torch.full_like(cnt, -1))
    score = torch.where(is_cand, -errors, torch.full_like(errors, -float("inf")))
    top_vals, top_idx = topk_stable(score, 3)
    top_ok = torch.isfinite(top_vals)
    f32 = torch.float32
    top = torch.stack([
        torch.where(top_ok, top_idx, torch.full_like(top_idx, -1)).to(f32),
        torch.where(top_ok, errors[top_idx], torch.full_like(top_vals, float("inf"))),
        (enough[top_idx] & top_ok).to(f32),
    ], dim=1).reshape(-1)
    packed = torch.cat([torch.stack([found.to(f32), is_cand.sum().to(f32)]), top])
    return packed, ConsistencyState(new_mask, new_count.to(torch.int32)), covis


class _Readback:
    """A small device result copied to the host without blocking the
    stream; `ready()` polls the copy's CUDA event (a CPU result is always
    ready)."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t, None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            with span("sdslam.wait"):
                self.event.synchronize()
        return self.host.numpy()


@dataclasses.dataclass
class LoopCloser:
    """Host-side loop-closing orchestration: consistency across keyframes,
    asynchronous Sim3 verification, correction sequencing, global BA.

    Consistency follows the reference's covisibility-group scheme: a
    candidate must stay consistent for `consistency_th` consecutive
    detections before its Sim3 verification runs. After an accepted
    correction, detection is ignored for LOOP_COOLDOWN_KFS keyframes."""

    cam: CameraModel
    scale_factor: float = 2.0
    n_levels: int = 5
    consistency_th: int = 3  # mnCovisibilityConsistencyTh (LoopClosing.cc:49)
    fix_scale: bool = True
    run_gba: bool = True
    min_frame_gap: int = 30
    # detections in flight before the host inspects them
    DETECT_DEPTH: int = 2
    _cons: Optional[ConsistencyState] = None
    _pending: list = dataclasses.field(default_factory=list)
    # verifications in flight: (kf_slot, cand_slot, remaining candidates, readback)
    _verifying: list = dataclasses.field(default_factory=list)
    _seed: int = 0
    LOOP_COOLDOWN_KFS: int = 10
    _kf_count: int = 0
    _last_loop_kf: int = -(10 ** 9)

    # -- async API (the System frame loop) -----------------------------------

    def dispatch_keyframe(self, ms: M.MapState, kf_slot: int):
        """Enqueue detection + consistency for a new keyframe; no host sync."""
        self._kf_count += 1
        if self._kf_count < self._last_loop_kf + self.LOOP_COOLDOWN_KFS:
            return  # reference cooldown: ignore detection after a closure
        with span("sdslam.loop.dispatch", n=1):
            if self._cons is None or self._cons.mask.shape[0] != ms.K:
                self._cons = init_consistency(ms.K, ms.device)
            packed, self._cons, _ = detect_and_consistency(
                self.cam, ms, kf_slot, self._cons, scale_factor=self.scale_factor,
                n_levels=self.n_levels, min_frame_gap=self.min_frame_gap,
                consistency_th=self.consistency_th,
            )
            self._pending.append((int(kf_slot), _Readback(packed)))

    def poll(self, ms: M.MapState, force: bool = False):
        """Drain landed detection results, dispatch verification for
        consistency hits, apply corrections for drained verifications that
        accepted. Returns (ms, list of info dicts). With force=False a
        result is read only once its copy has landed."""
        with span("sdslam.loop.poll") as sp:
            infos = []
            while self._pending:
                if (not force and len(self._pending) <= self.DETECT_DEPTH
                        and not self._pending[0][1].ready()):
                    break
                kf_slot, rb = self._pending.pop(0)
                p = rb.numpy()
                info = {"kf": kf_slot, "detected": bool(p[DET_FOUND])}
                if p[DET_FOUND]:
                    top = p[DET_TOP:].reshape(3, 3)  # (slot, error, enough)
                    info["n_candidates"] = int(p[DET_N_CAND])
                    info["candidate"] = int(top[0, 0])
                    enough = [int(s) for (s, e, ok) in top if ok > 0 and s >= 0]
                    if enough:
                        self._dispatch_verify(ms, kf_slot, enough)
                        info["verifying"] = True
                    else:
                        info["pending"] = True
                infos.append(info)
            ms, vinfos = self._drain_verifications(ms, force=force)
            infos += vinfos
            sp.n = len(infos)
        return ms, infos

    def _dispatch_verify(self, ms: M.MapState, kf_slot: int, cands: list):
        """Enqueue ComputeSim3 for the best candidate; the rest are retried
        in turn if it rejects."""
        if not cands:
            return
        cand_slot, rest = cands[0], cands[1:]
        self._seed += 1
        gen = torch.Generator(device=ms.device).manual_seed(self._seed)
        ver = verify_loop_sim3(self.cam, ms, kf_slot, cand_slot, M.covisibility(ms),
                               generator=gen, scale_factor=self.scale_factor,
                               fix_scale=self.fix_scale)
        f32 = torch.float32
        packed = torch.cat([torch.stack([ver.accepted.to(f32), ver.n_inliers.to(f32)]),
                            ver.S_cur_cand.reshape(16)])
        self._verifying.append((kf_slot, cand_slot, rest, _Readback(packed)))

    def _drain_verifications(self, ms: M.MapState, force: bool = False):
        """Apply corrections for verifications whose results have landed,
        on the live map state (the verified Sim3 is a relative measurement
        between two keyframes, so later local BA does not invalidate it)."""
        infos = []
        while self._verifying:
            if not force and not self._verifying[0][3].ready():
                break
            kf_slot, cand_slot, rest, rb = self._verifying.pop(0)
            p = rb.numpy()
            info = {"kf": kf_slot, "candidate": cand_slot, "sim3_inliers": int(p[1])}
            with span("sdslam.wait"):
                valid = ms.kf_valid[[kf_slot, cand_slot]].cpu().numpy()
            if not p[0]:  # rejected: try the next candidate
                if rest and valid[0]:
                    self._dispatch_verify(ms, kf_slot, rest)
                    info["verifying"] = True
                infos.append(info)
                continue
            if not valid.all():
                info["stale"] = True  # a keyframe was culled since dispatch
                infos.append(info)
                continue
            S = torch.as_tensor(p[2:18].reshape(4, 4)).to(ms.device)
            ms, info = self._apply_correction(ms, kf_slot, cand_slot, S, info)
            infos.append(info)
        return ms, infos

    def _apply_correction(self, ms: M.MapState, kf_slot: int, cand_slot: int, S, info):
        """CorrectLoop on acceptance: pose correction + essential graph,
        seam fusion, local duplicate fusion, statistics, global BA."""
        ms, n_dropped = correct_loop_poses(ms, kf_slot, cand_slot, S, M.covisibility(ms),
                                           scale_factor=self.scale_factor)
        n_dropped = int(n_dropped)
        if n_dropped > 0:
            # no silent caps: the essential graph lost covisibility edges
            print(f"[loop_closing] WARNING: pose-graph edge cap truncated {n_dropped} "
                  "covisibility edges (tree/loop edges kept)")
            info["edges_dropped"] = n_dropped
        ms = fuse_loop_points(self.cam, ms, kf_slot, cand_slot, M.covisibility(ms),
                              scale_factor=self.scale_factor)
        ms = LM.fuse_neighbors(self.cam, ms, kf_slot, scale_factor=self.scale_factor)
        ms = M.finalize_point_statistics(ms, self.scale_factor, self.n_levels)
        if self.run_gba:
            ms = ba.global_ba(self.cam, ms, scale_factor=self.scale_factor)
            info["global_ba"] = True
        info["corrected"] = True
        self._cons = None  # clear the consistency history after a closure
        self._last_loop_kf = self._kf_count  # arm the detection cooldown
        return ms, info

    # -- synchronous API (tests / offline) ------------------------------------

    def process_keyframe(self, ms: M.MapState, kf_slot: int):
        """Dispatch + immediately drain. Returns (ms, the last info dict)."""
        self.dispatch_keyframe(ms, kf_slot)
        ms, infos = self.poll(ms, force=True)
        return ms, infos[-1] if infos else {}
