"""Tracking front-ends + keyframe mapping pass (port of
sdslam_tpu/pipeline/tracking.py): `RGBDTracker` and the monocular
`MonoTracker`, with the IMU filter of the fusion sensor in the frame step.

Per frame, on the device: ORB extraction, constant-velocity EKF
prediction (and, once IMU samples arrive, the 16-state IMU filter's),
direct image alignment against the reference keyframe (K1), projection
matching and local-map search (K4), two pose GN solves (K2), the keyframe
decision, and on keyframes the whole mapping pass `_kf_core` (insertion,
covisibility, fusion, local BA (K3, K6), point spawning, triangulation,
counters, culling, statistics), then the filter updates. A monocular
tracker first bootstraps its map from two views (solvers/initializer.py)
and a global BA.

The JAX package runs this as one jitted program with lax.cond branches;
PyTorch runs eagerly, so the keyframe decision and the keyframe-culling
gate are Python branches, each one device->host sync. Every other decision
stays on the device (torch.where). The tracker counts its host syncs.
Each stage of a call is a span (utils/profiling.py): `sdslam.frame` at the
root, `sdslam.upload`, `sdslam.orb`, `sdslam.motion`, `sdslam.track_core`,
`sdslam.kf` with one span per mapping stage, `sdslam.drain`, `sdslam.reloc`,
and `sdslam.wait` around each counted device->host read.
A LOST tracker relocalizes against the whole keyframe pool
(pipeline/relocalization.py: kernel K5, then K4 and K2) on its next frame.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sdslam_tpu_torch import _device
from sdslam_tpu_torch._util import put, scatter_set, take, topk_stable
from sdslam_tpu_torch.features import matching
from sdslam_tpu_torch.features.frame import Frame, ORBExtractor, make_frame
from sdslam_tpu_torch.geometry import camera as cam_mod
from sdslam_tpu_torch.geometry import lie
from sdslam_tpu_torch.geometry.camera import CameraModel
from sdslam_tpu_torch.mapping import local_mapping as LM
from sdslam_tpu_torch.mapping import map_state as M
from sdslam_tpu_torch.ops import hamming as ham
from sdslam_tpu_torch.pipeline import sensors
from sdslam_tpu_torch.pipeline.relocalization import relocalize
from sdslam_tpu_torch.solvers import ba, image_align, pose_opt
from sdslam_tpu_torch.solvers import initializer as init_mod
from sdslam_tpu_torch.solvers.sim3_solver import sample_sets
from sdslam_tpu_torch.utils.config import SystemConfig
from sdslam_tpu_torch.utils.profiling import frame_span, span

# pyramid levels stored per keyframe (direct alignment runs on levels >= 2)
KF_STORE_MIN_LEVEL = 2


class TrackOutput(NamedTuple):
    Tcw: torch.Tensor  # [4,4] optimized pose
    assoc: torch.Tensor  # [N] int32 keypoint -> point id (inliers only)
    n_inliers: torch.Tensor  # int32
    n_matches: torch.Tensor  # pre-optimization match count
    align_error: torch.Tensor  # photometric alignment residual


def _track_core(cam: CameraModel, ms: M.MapState, uv_und, desc, octave, kp_valid, uright,
                pyr_cur, ref_slot, T_pred, scale_factor: float = 2.0, n_levels: int = 5,
                align_min_level: int = 2, th_radius=1.0,
                pose_gn_schedule=((2, 4), (2, 5))) -> TrackOutput:
    P, N = ms.P, ms.N
    r = M._idx(ref_slot, ms.device)
    # --- 1. direct sparse alignment against the reference keyframe ---
    T_ref = take(ms.kf_Tcw, r)
    ref_assoc = take(ms.kf_mp, r)
    ref_depth = take(ms.kf_depth, r)
    ref_safe = torch.clamp(ref_assoc, 0, P - 1).long()
    map_z = lie.se3_apply(T_ref, ms.pt_pos[ref_safe])[:, 2]
    has_map = (ref_assoc >= 0) & (map_z > 0.05)
    depth_eff = torch.where(ref_depth > 0, ref_depth,
                            torch.where(has_map, map_z, torch.full_like(map_z, -1.0)))
    align_valid = take(ms.kf_kp_valid, r) & (depth_eff > 0)
    X_ref_cam = cam_mod.backproject(cam, take(ms.kf_uv_und, r), torch.clamp(depth_eff, min=1e-3))
    ares = image_align.align(
        tuple(take(pl, r) for pl in ms.kf_pyramid), tuple(pyr_cur[KF_STORE_MIN_LEVEL:]),
        take(ms.kf_uv, r), X_ref_cam, align_valid, T_pred @ lie.se3_inv(T_ref),
        cam.fx, cam.fy, cam.cx, cam.cy, scale_factor=scale_factor, max_level=n_levels - 1,
        min_level=align_min_level, start_level=KF_STORE_MIN_LEVEL,
    )
    T_init = ares.T_cur_ref @ T_ref

    # --- 2. project the reference KF's map points, window match ---
    q_ok = (ref_assoc >= 0) & ms.pt_valid[ref_safe]
    q_pos = ms.pt_pos[ref_safe]
    q_desc = ms.pt_desc[ref_safe]
    q_oct = take(ms.kf_octave, r)
    args = (q_pos, q_desc, q_ok, q_oct, uv_und, desc, kp_valid, octave)
    res1 = matching.search_by_projection(cam, T_init, *args, radius_px=8.0,
                                         th_desc=ham.TH_HIGH, scale_factor=scale_factor)
    # starvation fallback: < 20 matches -> doubled window from the raw prediction
    res1_wide = matching.search_by_projection(cam, T_pred, *args, radius_px=16.0,
                                              th_desc=ham.TH_HIGH, scale_factor=scale_factor)
    starved = (res1.kp_to_query >= 0).sum() < 20
    kp_to_q = torch.where(starved, res1_wide.kp_to_query, res1.kp_to_query)
    T_init = torch.where(starved, T_pred, T_init)
    assoc1 = torch.where(kp_to_q >= 0, ref_assoc[torch.clamp(kp_to_q, 0, N - 1).long()],
                         torch.full_like(kp_to_q, -1))

    # --- 3. pose GN on matched points with the aligner's pose as a prior ---
    align_ok = (ares.error < 0.01) & (ares.n_meas > 500) & ~starved
    quality = torch.sqrt(torch.clamp(ares.error, min=1e-5) / 2e-4)
    rot_sigma = torch.clamp(0.003 * quality, 0.003, 0.1)
    trans_sigma = torch.clamp(0.02 * quality, 0.02, 0.5)
    zero = torch.zeros_like(rot_sigma)
    rot_info = torch.where(align_ok, 1.0 / rot_sigma**2, zero)
    trans_info = torch.where(align_ok, 1.0 / trans_sigma**2, zero)
    inv_sigma2 = 1.0 / scale_factor ** (2.0 * octave.to(torch.float32))
    v1 = assoc1 >= 0
    X1 = ms.pt_pos[torch.clamp(assoc1, 0, P - 1).long()]
    opt1 = pose_opt.optimize_pose(
        cam, T_init, X1, uv_und, inv_sigma2, v1, ur_obs=uright,
        rounds=pose_gn_schedule[0][0], iters_per_round=pose_gn_schedule[0][1],
        T_prior=T_init, prior_rot_info=rot_info, prior_trans_info=trans_info,
    )

    # --- 4. local-map search over the whole resident point pool ---
    res2 = matching.search_local_points(
        cam, opt1.Tcw, ms.pt_pos, ms.pt_desc, ms.pt_valid, ms.pt_normal, ms.pt_min_dist,
        ms.pt_max_dist, uv_und, desc, kp_valid, octave, th_radius=th_radius,
        scale_factor=scale_factor, n_levels=n_levels,
    )
    neg = torch.full_like(assoc1, -1)
    assoc2 = torch.where(v1 & opt1.inliers, assoc1, neg)
    assoc2 = torch.where((assoc2 < 0) & (res2.kp_to_query >= 0), res2.kp_to_query, assoc2)

    # --- 5. second pose refinement on the richer association set ---
    v2 = assoc2 >= 0
    X2 = ms.pt_pos[torch.clamp(assoc2, 0, P - 1).long()]
    opt2 = pose_opt.optimize_pose(
        cam, opt1.Tcw, X2, uv_und, inv_sigma2, v2, ur_obs=uright,
        rounds=pose_gn_schedule[1][0], iters_per_round=pose_gn_schedule[1][1],
        T_prior=T_init, prior_rot_info=rot_info, prior_trans_info=trans_info,
    )
    return TrackOutput(opt2.Tcw, torch.where(v2 & opt2.inliers, assoc2, neg),
                       opt2.n_inliers, v1.sum(), ares.error)


def track_step(cam: CameraModel, ms: M.MapState, *args, **kwargs):
    """The JAX module's jitted entry point over `_track_core` (no trace to
    cache here): its TrackOutput and the packed [19] readback vector
    (PACK_POSE, PACK_INLIERS, PACK_MATCHES, PACK_ALIGN_ERR)."""
    out = _track_core(cam, ms, *args, **kwargs)
    packed = torch.cat([out.Tcw.reshape(16), torch.stack([
        out.n_inliers.to(torch.float32), out.n_matches.to(torch.float32), out.align_error])])
    return out, packed


def keyframe_step(cam: CameraModel, ms: M.MapState, slot, Tcw, uv, uv_und, octave, angle,
                  desc, kp_valid, depth, uright, assoc, stored_pyr, frame_id, timestamp, parent,
                  scale_factor: float = 2.0, n_levels: int = 5) -> M.MapState:
    """Insert a keyframe with its tracked associations only."""
    ms = M.insert_keyframe(ms, slot, Tcw, uv, uv_und, octave, angle, desc, kp_valid, depth,
                           uright, assoc, stored_pyr, frame_id, timestamp, parent)
    return M.finalize_point_statistics(ms, scale_factor, n_levels)


def spawn_points(cam: CameraModel, ms: M.MapState, slot, close_depth_th,
                 scale_factor: float = 2.0, n_levels: int = 5,
                 update_stats: bool = True) -> M.MapState:
    """Create map points from the keyframe's close depth readings with its
    (BA-refined) pose; below 100 close candidates, the 100 nearest."""
    s = M._idx(slot, ms.device)
    Tcw = take(ms.kf_Tcw, s)
    depth = take(ms.kf_depth, s)
    assoc = take(ms.kf_mp, s)
    candidate = take(ms.kf_kp_valid, s) & (assoc < 0) & (depth > 0)
    want = candidate & (depth < close_depth_th)
    MIN_CLOSE = 100
    need_fallback = want.sum() < MIN_CLOSE
    nearness = torch.where(candidate, -depth, torch.full_like(depth, -float("inf")))
    kth = topk_stable(nearness, min(MIN_CLOSE, nearness.shape[0]))[0][-1]
    want = torch.where(need_fallback, want | (candidate & (-depth >= kth)), want)
    Xc = cam_mod.backproject(cam, take(ms.kf_uv_und, s), torch.clamp(depth, min=1e-3))
    ms, _ = M.create_points(ms, s, want, lie.se3_apply(lie.se3_inv(Tcw), Xc))
    if update_stats:
        ms = M.finalize_point_statistics(ms, scale_factor, n_levels)
    return ms


def _kf_core(cam: CameraModel, ms: M.MapState, Tcw, uv, uv_und, octave, angle, desc,
             kp_valid, depth, uright, assoc, stored_pyr, frame_id, timestamp, parent,
             close_depth_th, scale_factor: float = 2.0, n_levels: int = 5, covis_min: int = 15,
             ba_schedule=(3, 5), sync: Callable[[torch.Tensor], bool] = bool):
    """The whole keyframe-cadence mapping pass, one span per stage (the
    caller opens `sdslam.kf`). `sync` turns the culling gate into a host
    bool (the caller counts it). Returns (ms, slot, new_assoc_row,
    Tcw_refined)."""
    with span("sdslam.kf.insert"):
        slot = torch.argmin(ms.kf_valid.to(torch.int32))  # first free slot
        ms = M.insert_keyframe(ms, slot, Tcw, uv, uv_und, octave, angle, desc, kp_valid, depth,
                               uright, assoc, stored_pyr, frame_id, timestamp, parent)
        new_kf_id = ms.next_kf_id
        inc = M.incidence_matrix(ms)
        covis = M.covisibility(ms, inc=inc)
    with span("sdslam.kf.fuse"):
        ms = LM.fuse_neighbors(cam, ms, slot, scale_factor=scale_factor, covis=covis,
                               obs_cnt=M.point_obs_count_from_inc(ms, inc))
    with span("sdslam.kf.local_ba"):
        ms = ba.local_ba(cam, ms, slot, scale_factor=scale_factor, covis_min=covis_min,
                         covis=covis, inc=inc, iters1=ba_schedule[0], iters2=ba_schedule[1])
    with span("sdslam.kf.spawn"):
        ms = spawn_points(cam, ms, slot, close_depth_th, scale_factor=scale_factor,
                          n_levels=n_levels, update_stats=False)
        ms = LM.triangulate_new_points(cam, ms, slot, scale_factor=scale_factor,
                                       n_levels=n_levels, covis=covis, update_stats=False)
    with span("sdslam.kf.cull"):
        ms = M.update_tracking_counters(ms, cam, take(ms.kf_Tcw, slot), take(ms.kf_mp, slot))
        obs_lists = M.build_obs_lists(ms, 16)
        ms = LM.cull_points(ms, obs_cnt=(obs_lists[0] >= 0).sum(1))
        rows = (take(covis, slot) > 0) | (torch.arange(ms.K, device=ms.device) == slot)
        # redundancy culling only once the pool is half full (the JAX lax.cond)
        if sync(ms.kf_valid.sum() > ms.K // 2):
            ms = LM.cull_keyframes(ms, slot, obs_lists=obs_lists, rows_mask=rows, covis=covis)
    with span("sdslam.kf.stats"):
        touched = (rows.to(inc.dtype) @ inc) > 0
        row_now = take(ms.kf_mp, slot)
        touched = scatter_set(touched, torch.where(row_now >= 0, row_now, ms.P), True)
        touched = touched | (ms.pt_first_kf == new_kf_id)
        ms = M.finalize_point_statistics_local(ms, rows, scale_factor, n_levels,
                                               obs_lists=obs_lists, touched=touched)
        return ms, slot, take(ms.kf_mp, slot), take(ms.kf_Tcw, slot)


kf_pipeline = _kf_core  # the JAX module's jitted entry point, as track_step


def pack_frame(img_u8: np.ndarray, depth_u16: np.ndarray, timestamp: float) -> np.ndarray:
    """Pack (u8 intensity [H,W], u16 depth [H,W], f32 timestamp) into one u8
    buffer [H + H//2 + 1, W] for a single host->device upload: the image,
    the 2x2-decimated depth (per row W//2 low bytes then W//2 high bytes)
    and the timestamp in the first 4 bytes of the last row."""
    H, W = img_u8.shape
    if H % 2 or W % 2:
        raise ValueError("camera dims must be even")
    Hh, Wh = H // 2, W // 2
    buf = np.zeros((H + Hh + 1, W), np.uint8)
    buf[:H, :W] = img_u8
    dh = np.ascontiguousarray(depth_u16[::2, ::2])
    buf[H: H + Hh, :Wh] = (dh & 0xFF).astype(np.uint8)
    buf[H: H + Hh, Wh: 2 * Wh] = (dh >> 8).astype(np.uint8)
    buf[H + Hh, :4] = np.frombuffer(np.float32(timestamp).tobytes(), dtype=np.uint8)
    return buf


class DeviceState(NamedTuple):
    """Per-frame tracker state that lives on the device across frames."""

    ekf: sensors.EKFState
    imu: sensors.IMUState  # 16-state IMU filter (fusion sensor)
    last_kf_slot: torch.Tensor  # int32
    frames_since_kf: torch.Tensor  # int32
    ref_kf_inliers: torch.Tensor  # int32
    frame_id: torch.Tensor  # int32
    last_ts: torch.Tensor  # float32


# layout of the packed per-frame readback vector
PACK_POSE = slice(0, 16)
PACK_INLIERS = 16
PACK_MATCHES = 17
PACK_ALIGN_ERR = 18
PACK_NEED_KF = 19
PACK_KF_SLOT = 20
PACK_N_KFS = 21
PACK_N_PTS = 22
PACK_LEN = 23


class KeyframeOutcome(NamedTuple):
    """What a tracking step's keyframe hook (`RGBDTracker._keyframe`)
    hands back: the map and the pose after it, the decision as the step
    reports it to the caller, the device state's keyframe fields, and the
    two packed values (decision, slot) of the frame's result."""

    ms: M.MapState
    Tcw: torch.Tensor
    need_kf: bool  # a mapping pass ran inline in this step
    last_kf_slot: torch.Tensor
    frames_since_kf: torch.Tensor
    ref_kf_inliers: torch.Tensor
    pack_need_kf: torch.Tensor  # f32 0-d
    pack_slot: torch.Tensor  # f32 0-d


@dataclasses.dataclass
class TrackerState:
    status: str = "NOT_INITIALIZED"
    T_last: Optional[np.ndarray] = None
    last_ts: float = 0.0
    last_frame: Optional[Frame] = None
    last_assoc: Optional[torch.Tensor] = None
    frames_since_kf: int = 0
    frame_id: int = 0
    last_kf_slot: int = -1
    ref_kf_inliers: int = 0


class RGBDTracker:
    """Host-side orchestration of RGB-D SLAM on one device.

    `track(img, depth, ts)` runs one frame; `track_batch(items)` runs a
    list of (img, depth, ts). numpy u8 images with u16 depth travel as one
    packed upload (decimated depth, as the JAX package's packed path);
    anything else (float images, device tensors, frames without depth)
    takes the unpacked path. Results drain from the device a few frames
    behind (`flush()` drains all). `inject_imu` hands the next frame an IMU
    sample (the fusion sensor).
    """

    _HAS_DEPTH = True

    PIPELINE_DEPTH = 4
    LOST_PATIENCE = 1
    # TrackLocalMap search radius: 3 for RGB-D, 5 for the 2 frames after a
    # relocalization (Tracking.cc:926-937)
    TH_RADIUS = 3.0
    TH_RADIUS_RELOC = 5.0

    def __init__(self, cfg: SystemConfig, device="cuda"):
        self.cfg = cfg
        self.cam = cam = cfg.camera
        self.device = _device.resolve(device)
        self.extractor = ORBExtractor(cam, cfg.orb)
        shapes = []
        h, w = cam.height, cam.width
        for lvl in range(cfg.orb.n_levels):
            if lvl >= KF_STORE_MIN_LEVEL:
                shapes.append((h, w))
            h, w = (h + 1) // 2, (w + 1) // 2
        self.ms = M.init_map(cfg.map.max_keyframes, cfg.map.max_points, cfg.orb.max_keypoints,
                             tuple(shapes), device=self.device)
        self.st = TrackerState()
        self.dst: Optional[DeviceState] = None
        self.mapping_enabled = True  # False = localization-only mode
        self._reloc_boost_until = -1  # frame id bound of the TH_RADIUS_RELOC window
        self._reloc_seed = 0
        self.trajectory: List = []
        self.timestamps: List[float] = []
        self.close_depth = cam.bf * cfg.tracking.th_depth / cam.fx if cam.bf > 0 else float("inf")
        self._pending: List[Tuple[int, torch.Tensor]] = []
        self._lost_streak = 0
        self.kf_events: List[int] = []
        self._t0: Optional[float] = None
        self.host_syncs = 0
        self._frame_marks: List[Tuple[bool, object, object]] = []
        self._imu_meas = np.zeros(6, np.float32)  # [gyro(3), accel(3)] for the next frame
        self._use_imu = False
        # the IMU filter runs from the first injected sample on; before it
        # the JAX package's always-on filter is an exact no-op (dt = 0)
        self._imu_active = False

    # -- host syncs and per-frame timing ---------------------------------

    def _sync(self, flag: torch.Tensor) -> bool:
        """Read a device bool on the host (one counted device->host sync)."""
        self.host_syncs += 1
        with span("sdslam.wait"):
            return bool(flag)

    def _mark(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @property
    def frame_ms(self):
        """Per-frame step times (ms) of the tracked frames, split into
        keyframe and non-keyframe steps (device events on CUDA)."""
        out = {"track": [], "kf": []}
        for is_kf, a, b in self._frame_marks:
            if isinstance(a, float):
                ms = (b - a) * 1e3
            else:
                b.synchronize()
                ms = a.elapsed_time(b)
            out["kf" if is_kf else "track"].append(ms)
        return out

    def _rel_ts(self, timestamp: float) -> float:
        """Timestamp relative to the first frame (float32-safe)."""
        if self._t0 is None:
            self._t0 = float(timestamp)
        return float(timestamp) - self._t0

    # -- the per-frame device step ----------------------------------------

    def _step(self, img, depth_img, ts, th_radius: float):
        cfg, cam = self.cfg, self.cam
        sf, nl = cfg.orb.scale_factor, cfg.orb.n_levels
        kf_interval = max(3, cfg.tracking.max_frames // 10)
        ms, dst = self.ms, self.dst
        with span("sdslam.orb"):
            feats, pyramid, d, uright = self.extractor.core(img, depth_img,
                                                            float(cfg.tracking.depth_map_factor))
        with span("sdslam.motion"):
            dt = torch.clamp(ts - dst.last_ts, min=1e-4)
            ekf, imu_s, use_imu = dst.ekf, dst.imu, self._use_imu
            if use_imu:
                # fills, not a host->device copy
                meas = torch.stack([torch.full((), float(v), device=self.device)
                                    for v in self._imu_meas])
                gyro, accel = meas[:3], meas[3:]
                # the gyro rate overrides the filter's angular twist
                ekf = ekf._replace(x=torch.cat([ekf.x[:3], gyro]))
            ekf, T_pred = sensors.ekf_predict(ekf, dt)
            if self._imu_active:
                imu_s, T_pred_imu = sensors.imu_predict(imu_s, dt)
                if use_imu:
                    T_pred = torch.where(dst.imu.updated, T_pred_imu, T_pred)
        with span("sdslam.track_core"):
            out = _track_core(
                cam, ms, feats.uv_und, feats.desc, feats.octave, feats.valid, uright, pyramid,
                dst.last_kf_slot, T_pred, scale_factor=sf, n_levels=nl,
                align_min_level=cfg.tracking.align_min_level, th_radius=th_radius,
                pose_gn_schedule=tuple(tuple(x) for x in cfg.tracking.pose_gn_schedule),
            )
        n_inl = out.n_inliers
        track_ok = n_inl >= 10
        fskf = dst.frames_since_kf
        decayed = n_inl.to(torch.float32) < 0.9 * dst.ref_kf_inliers.to(torch.float32)
        need_kf_d = (track_ok & (n_inl >= 20) & (~ms.kf_valid).any() & (fskf >= 2)
                     & (decayed | (fskf >= kf_interval)))
        kf = self._keyframe(ms, need_kf_d, n_inl, out, feats, pyramid, d, uright, ts)
        ms, Tcw_fin = kf.ms, kf.Tcw
        T_report = torch.where(track_ok, Tcw_fin, ekf.last_pose)
        with span("sdslam.motion"):
            ekf = sensors.ekf_update(ekf, Tcw_fin, dt, track_ok)
            if self._imu_active and use_imu:
                imu_s = sensors.imu_update(imu_s, Tcw_fin, gyro, accel, dt, track_ok)
        self.dst = DeviceState(
            ekf=ekf,
            imu=imu_s,
            last_kf_slot=kf.last_kf_slot,
            frames_since_kf=kf.frames_since_kf,
            ref_kf_inliers=kf.ref_kf_inliers,
            frame_id=dst.frame_id + 1,
            last_ts=ts,
        )
        self.ms = ms
        f32 = torch.float32
        packed = torch.cat([T_report.reshape(16), torch.stack([
            n_inl.to(f32), out.n_matches.to(f32), out.align_error.to(f32),
            kf.pack_need_kf, kf.pack_slot,
            ms.kf_valid.sum().to(f32), ms.pt_valid.sum().to(f32),
        ])])
        return packed, T_report, kf.need_kf, Frame(feats, tuple(pyramid), d, uright, T_report)

    def _keyframe(self, ms, need_kf_d, n_inl, out, feats, pyramid, d, uright,
                  ts) -> KeyframeOutcome:
        """The keyframe decision (one counted sync) and, on a keyframe, the
        whole mapping pass inline."""
        dst, f32 = self.dst, torch.float32
        if not (self.mapping_enabled and self._sync(need_kf_d)):
            return KeyframeOutcome(ms, out.Tcw, False, dst.last_kf_slot, dst.frames_since_kf + 1,
                                   dst.ref_kf_inliers, torch.zeros((), device=self.device),
                                   dst.last_kf_slot.to(f32))
        cfg = self.cfg
        close = self.close_depth if np.isfinite(self.close_depth) else 1e9
        with span("sdslam.kf", n=1):
            ms, slot, _, Tcw_fin = _kf_core(
                self.cam, ms, out.Tcw, feats.uv, feats.uv_und, feats.octave, feats.angle,
                feats.desc, feats.valid, d, uright, out.assoc, tuple(pyramid[KF_STORE_MIN_LEVEL:]),
                dst.frame_id, ts, dst.last_kf_slot, torch.full((), close, device=self.device),
                scale_factor=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels,
                covis_min=cfg.map.covis_min_weight, ba_schedule=tuple(cfg.tracking.ba_schedule),
                sync=self._sync,
            )
        slot = slot.to(torch.int32)
        return KeyframeOutcome(ms, Tcw_fin, True, slot, torch.zeros_like(dst.frames_since_kf),
                               n_inl.to(torch.int32), torch.ones((), device=self.device),
                               slot.to(f32))

    def _step_packed(self, buf, th_radius: float):
        """Unpack one u8 upload [H + H//2 + 1, W] (image, decimated u16
        depth as lo|hi half-rows, f32 timestamp) and run the step."""
        H, W = self.cam.height, self.cam.width
        Hh, Wh = H // 2, W // 2
        img = buf[:H, :W]
        dep = buf[H: H + Hh, :Wh].to(torch.int32) | (buf[H: H + Hh, Wh: 2 * Wh].to(torch.int32) << 8)
        ts = buf[H + Hh, :4].contiguous().view(torch.float32)[0]
        return self._step(img, dep, ts, th_radius)

    def _run_frame(self, fn, *args):
        a = self._mark()
        packed, T_report, need_kf, frame = fn(*args)
        self._frame_marks.append((need_kf, a, self._mark()))
        return packed, T_report, frame

    # -- readback ------------------------------------------------------------

    def _drain_one(self):
        idx, packed = self._pending.pop(0)
        rows = 1 if packed.ndim == 1 else packed.shape[0]
        with span("sdslam.drain", n=rows, frame=idx):
            self.host_syncs += 1
            with span("sdslam.wait"):
                p = packed.cpu().numpy()
            for b, row in enumerate(p[None] if p.ndim == 1 else p):
                self._apply_packed_row(idx + b, row)

    def _apply_packed_row(self, idx, p):
        n_inl = int(p[PACK_INLIERS])
        pose = p[PACK_POSE].reshape(4, 4)
        self.trajectory[idx] = pose
        self.st.T_last = pose
        if bool(p[PACK_NEED_KF]):
            slot = int(p[PACK_KF_SLOT])
            self.st.last_kf_slot = slot
            self.st.ref_kf_inliers = n_inl
            self.kf_events.append(slot)
        if n_inl < 10:
            self._lost_streak += 1
            # localization mode relocalizes at once (no map to damage)
            if self._lost_streak >= self.LOST_PATIENCE or not self.mapping_enabled:
                self.st.status = "LOST"
        else:
            self._lost_streak = 0
            if self.st.status != "NOT_INITIALIZED":
                self.st.status = "OK"

    def flush(self):
        """Drain every in-flight frame (call before reading host state)."""
        while self._pending:
            self._drain_one()

    # -- host API ------------------------------------------------------------

    def inject_imu(self, gyro, accel=None):
        """Hand the next tracked frame a raw IMU sample (fusion sensor): its
        gyro rate seeds the motion model and the 16-state filter fuses it
        with that frame's tracked pose."""
        m = np.zeros(6, np.float32)
        m[:3] = np.asarray(gyro, np.float32).reshape(3)
        if accel is not None:
            m[3:6] = np.asarray(accel, np.float32).reshape(3)
        self._imu_meas = m
        self._use_imu = True
        self._imu_active = True

    def inject_angular_rate(self, w):
        """Gyro-only variant of inject_imu."""
        self.inject_imu(w)

    def reset_reference(self, slot: int, Tcw=None):
        """Re-anchor tracking after an external map update (loop closure):
        new reference keyframe, motion filter restarted from `Tcw` (a 4x4
        array or tensor), or from the keyframe's pose when none is given."""
        self.flush()
        T = (self.ms.kf_Tcw[int(slot)] if Tcw is None
             else torch.as_tensor(Tcw, dtype=torch.float32, device=self.device))
        self.st.last_kf_slot = int(slot)
        self.st.T_last = T.cpu().numpy()
        if self.dst is not None:
            self.dst = self.dst._replace(
                ekf=sensors.ekf_init(T),
                imu=sensors.imu_init(self.device),
                last_kf_slot=torch.full((), int(slot), dtype=torch.int32, device=self.device),
            )

    def _free_kf_slot(self) -> int:
        free = np.flatnonzero(~self.ms.kf_valid.cpu().numpy())
        if len(free) == 0:
            raise RuntimeError("keyframe pool exhausted")
        return int(free[0])

    def _initialize(self, frame: Frame, timestamp: float):
        f = frame.features
        dev = self.device
        slot = self._free_kf_slot()
        sf, nl = self.cfg.orb.scale_factor, self.cfg.orb.n_levels
        self.ms = keyframe_step(
            self.cam, self.ms, slot, frame.Tcw, f.uv, f.uv_und, f.octave, f.angle, f.desc,
            f.valid, frame.depth, frame.uright,
            torch.full((f.capacity,), -1, dtype=torch.int32, device=dev), self._stored_pyr(frame),
            torch.tensor(self.st.frame_id, dtype=torch.int32, device=dev),
            torch.tensor(self._rel_ts(timestamp), dtype=torch.float32, device=dev),
            torch.tensor(-1, dtype=torch.int32, device=dev), scale_factor=sf, n_levels=nl,
        )
        self.ms = spawn_points(self.cam, self.ms, slot,
                               torch.tensor(self.close_depth, dtype=torch.float32, device=dev),
                               scale_factor=sf, n_levels=nl)
        st = self.st
        st.last_assoc = self.ms.kf_mp[slot]
        st.last_kf_slot = slot
        st.T_last = frame.Tcw.cpu().numpy()
        st.last_ts = timestamp
        st.last_frame = frame
        st.status = "OK"
        st.frames_since_kf = 0
        st.ref_kf_inliers = int((st.last_assoc >= 0).sum())
        self._start_device_state(slot, frame.Tcw, timestamp)

    def _start_device_state(self, slot: int, Tcw, timestamp: float):
        dev = self.device
        i32 = torch.int32
        self.dst = DeviceState(
            ekf=sensors.ekf_init(Tcw.to(dev)),
            imu=sensors.imu_init(dev),  # restarts on relocalization
            last_kf_slot=torch.tensor(slot, dtype=i32, device=dev),
            frames_since_kf=torch.tensor(0, dtype=i32, device=dev),
            ref_kf_inliers=torch.tensor(self.st.ref_kf_inliers, dtype=i32, device=dev),
            frame_id=torch.tensor(self.st.frame_id, dtype=i32, device=dev),
            last_ts=torch.tensor(self._rel_ts(timestamp), dtype=torch.float32, device=dev),
        )

    def _as_device(self, x):
        return None if x is None else torch.as_tensor(x).to(self.device)

    def _stored_pyr(self, frame: Frame):
        return tuple(frame.pyramid[KF_STORE_MIN_LEVEL:])

    def track(self, img, depth_img, timestamp: float):
        """Track one frame; returns its pose (a device tensor until drained)."""
        with frame_span(len(self.trajectory)):
            if self.st.status == "NOT_INITIALIZED":
                with span("sdslam.upload"):
                    img_d, depth_d = self._as_device(img), self._as_device(depth_img)
                with span("sdslam.orb"):
                    frame = make_frame(self.extractor, img_d, depth_img=depth_d,
                                       depth_factor=self.cfg.tracking.depth_map_factor)
                self._initialize(frame, timestamp)
                pose = self.st.T_last if self.st.status == "OK" else frame.Tcw.cpu().numpy()
                self.trajectory.append(np.asarray(pose))
                self.timestamps.append(timestamp)
                self.st.frame_id += 1
                return self.trajectory[-1]
            if self.st.status == "LOST":
                return self._relocalize_step(img, depth_img, timestamp)
            th_radius = (self.TH_RADIUS_RELOC if self.st.frame_id < self._reloc_boost_until
                         else self.TH_RADIUS)
            if (self._HAS_DEPTH and isinstance(img, np.ndarray)
                    and isinstance(depth_img, np.ndarray)
                    and img.dtype == np.uint8 and depth_img.dtype == np.uint16):
                with span("sdslam.upload"):
                    buf = self._as_device(pack_frame(img, depth_img, self._rel_ts(timestamp)))
                packed, T_report, frame = self._run_frame(self._step_packed, buf, th_radius)
            else:
                with span("sdslam.upload"):
                    img_d, depth_d = self._as_device(img), self._as_device(depth_img)
                    ts = torch.full((), self._rel_ts(timestamp), device=self.device)
                packed, T_report, frame = self._run_frame(self._step, img_d, depth_d, ts, th_radius)
            self._use_imu = False
            self.trajectory.append(T_report)
            self.timestamps.append(timestamp)
            self._pending.append((len(self.trajectory) - 1, packed))
            self.st.last_frame = frame
            self.st.last_ts = timestamp
            self.st.frame_id += 1
            while len(self._pending) > self.PIPELINE_DEPTH:
                self._drain_one()
            return self.trajectory[-1]

    # -- batched (offline/dataset) ingestion ---------------------------------

    def upload_batch(self, items):
        """Pack a chunk's frames and stage them on the device. Returns a
        handle for track_batch(..., uploaded=handle)."""
        items = list(items)
        with span("sdslam.upload", n=len(items)):
            bufs = np.stack([pack_frame(img, dep, self._rel_ts(ts)) for (img, dep, ts) in items])
            return (self._as_device(bufs), items)

    def track_batch(self, items, uploaded=None):
        """Track a list of (img_u8, depth_u16, timestamp) frames with one
        readback for the whole batch. Frames before initialization run
        through track(). Returns the trajectory indices of the frames."""
        items = list(items)
        with frame_span(len(self.trajectory), n=len(items)):
            if uploaded is not None:
                bufs, up_items = uploaded
                if len(up_items) != len(items) or any(u is not i for u, i in zip(up_items, items)):
                    raise ValueError("uploaded handle does not match items (count or identity "
                                     "differ): pass the handle upload_batch returned for them")
                if self.st.status == "OK":
                    return self._track_batch_bufs(items, bufs)
            out_idx = []
            i = 0
            while i < len(items) and self.st.status != "OK":
                img, dep, ts = items[i]
                self.track(img, dep, ts)
                out_idx.append(len(self.trajectory) - 1)
                i += 1
            rest = items[i:]
            if not rest:
                return out_idx
            return out_idx + self._track_batch_bufs(rest, self.upload_batch(rest)[0])

    def _track_batch_bufs(self, rest, bufs):
        idx0 = len(self.trajectory)
        packs = []
        for b in range(len(rest)):
            packed, _, frame = self._run_frame(self._step_packed, bufs[b], self.TH_RADIUS)
            packs.append(packed)
            self.trajectory.append(None)  # filled on drain
            self.timestamps.append(rest[b][2])
        self._pending.append((idx0, torch.stack(packs)))
        self.st.last_frame = frame
        self.st.frame_id += len(rest)
        self.st.last_ts = rest[-1][2]
        while len(self._pending) > self.PIPELINE_DEPTH:
            self._drain_one()
        return list(range(idx0, idx0 + len(rest)))

    def _relocalize_step(self, img, depth_img, timestamp: float):
        """Recovery against every keyframe (Tracking.cc:1064-1097): one
        batched alignment, then verification; one packed host read of the
        outcome per lost frame."""
        with span("sdslam.reloc"):
            self.flush()
            st = self.st
            with span("sdslam.upload"):
                img_d, depth_d = self._as_device(img), self._as_device(depth_img)
            with span("sdslam.orb"):
                frame = make_frame(self.extractor, img_d, depth_img=depth_d,
                                   depth_factor=self.cfg.tracking.depth_map_factor)
            f = frame.features
            self._reloc_seed += 1
            gen = torch.Generator(device=self.device).manual_seed(self._reloc_seed)
            rr = relocalize(self.cam, self.ms, f.uv_und, f.desc, f.octave, f.valid, frame.uright,
                            frame.pyramid, generator=gen, scale_factor=self.cfg.orb.scale_factor,
                            n_levels=self.cfg.orb.n_levels, store_min_level=KF_STORE_MIN_LEVEL)
            f32 = torch.float32
            self.host_syncs += 1
            p = torch.cat([torch.stack([rr.success.to(f32), rr.best_kf.to(f32),
                                        (rr.assoc >= 0).sum().to(f32)]), rr.Tcw.reshape(16)])
            with span("sdslam.wait"):
                p = p.cpu().numpy()
            if p[0] > 0:
                st.status = "OK"
                st.last_kf_slot = int(p[1])
                st.last_assoc = rr.assoc
                st.T_last = p[3:].reshape(4, 4)
                st.last_frame = frame._replace(Tcw=rr.Tcw)
                st.frames_since_kf = 0
                st.ref_kf_inliers = max(int(p[2]), 1)
                self._lost_streak = 0
                # wider local-map search for the next 2 frames
                # (mnLastRelocFrameId window, Tracking.cc:934-936)
                self._reloc_boost_until = st.frame_id + 1 + 2
                self._start_device_state(st.last_kf_slot, rr.Tcw, timestamp)
            # while lost, report the last known pose
            st.frame_id += 1
            st.last_ts = timestamp
            self.trajectory.append(np.array(st.T_last))
            self.timestamps.append(timestamp)
            return self.trajectory[-1]


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """numpy's nanmedian of a 1-d tensor (the mean of the two middle values
    for an even count, where torch.nanmedian returns the lower one), with
    the linear interpolation jnp.nanmedian uses; no host sync."""
    n = (~torch.isnan(x)).sum()
    srt = torch.sort(x).values  # NaN last
    pos = 0.5 * (n - 1).to(torch.float32)
    lo = torch.floor(pos)
    w = pos - lo
    lo = lo.to(torch.int64).clamp(min=0)
    hi = torch.ceil(pos).to(torch.int64).clamp(min=0)
    return take(srt, lo) * (1.0 - w) + take(srt, hi) * w


class MonoTracker(RGBDTracker):
    """Monocular front-end: two-view bootstrap (H/F RANSAC), whose map's
    median depth is normalized to 1, or with `use_pattern` a metric map from
    the first frame that sees the chessboard; then map growth by
    triangulation.
    `track(img, ts)` takes no depth; frames go through the unpacked step."""

    _HAS_DEPTH = False
    TH_RADIUS = 1.0  # monocular local-map search window
    INIT_SAMPLES = 200  # RANSAC hypotheses of the two-view bootstrap

    def __init__(self, cfg: SystemConfig, device="cuda"):
        super().__init__(cfg, device=device)
        self._init_frame: Optional[Frame] = None
        self._init_ts = 0.0
        self._init_seed = 0  # counts the bootstrap attempts (the JAX tracker's _seed)

    def track(self, img, timestamp: float):  # type: ignore[override]
        return super().track(img, None, timestamp)

    def _init_samples(self, valid):
        """[INIT_SAMPLES, 8] keypoint indices drawn with replacement in
        proportion to `valid`, from a device generator seeded by the attempt
        count (the JAX tracker draws with jax.random.key(attempt))."""
        gen = torch.Generator(device=self.device).manual_seed(self._init_seed)
        return sample_sets(valid, self.INIT_SAMPLES, 8, generator=gen)

    def _read(self, t: torch.Tensor) -> np.ndarray:
        """Copy a device tensor to the host (one counted device->host sync)."""
        self.host_syncs += 1
        with span("sdslam.wait"):
            return t.cpu().numpy()

    def _insert_keyframe(self, slot: int, fr: Frame, T, frame_id: int, ts: float, parent: int):
        """Insert frame `fr` at pose T as keyframe `slot`, no observations bound."""
        g = fr.features
        dev, i32 = self.device, torch.int32
        self.ms = keyframe_step(
            self.cam, self.ms, slot, T, g.uv, g.uv_und, g.octave, g.angle, g.desc, g.valid,
            fr.depth, fr.uright, torch.full((g.capacity,), -1, dtype=i32, device=dev),
            self._stored_pyr(fr), torch.tensor(frame_id, dtype=i32, device=dev),
            torch.tensor(self._rel_ts(ts), dtype=torch.float32, device=dev),
            torch.tensor(parent, dtype=i32, device=dev), scale_factor=self.cfg.orb.scale_factor,
            n_levels=self.cfg.orb.n_levels)

    def _pattern_initialize(self, frame: Frame, timestamp: float) -> bool:
        """Metric-scale bootstrap from a chessboard
        (Tracking::PatternInitialization): the first frame that sees the
        pattern becomes the identity-pose keyframe, and every keypoint whose
        ray hits the board rectangle spawns a metric map point. Each attempt
        reads the level-0 image, the keypoints and, on success, the inlier
        count on the host (counted in host_syncs)."""
        from sdslam_tpu_torch.features import pattern as pat

        f = frame.features
        img = self._read(frame.pyramid[0])
        res = pat.detect_pattern(np.clip(img, 0, 255).astype(np.uint8), self.cam)
        if not res.found:
            return False
        uv_valid = self._read(torch.cat([f.uv_und, f.valid[:, None].to(f.uv_und.dtype)], 1))
        inside, X_cam = pat.metric_points_on_board(res, self.cam, uv_valid[:, :2])
        inside &= uv_valid[:, 2] > 0
        if inside.sum() < 20:
            return False
        dev = self.device
        eye = torch.eye(4, device=dev)
        slot = self._free_kf_slot()
        self._insert_keyframe(slot, frame, eye, self.st.frame_id, timestamp, -1)
        # the frame's pose is the identity: camera-frame points are world points
        self.ms, _ = M.create_points(self.ms, slot, torch.as_tensor(inside, device=dev),
                                     torch.as_tensor(X_cam, device=dev))
        self.ms = M.finalize_point_statistics(self.ms, self.cfg.orb.scale_factor,
                                              self.cfg.orb.n_levels)
        st = self.st
        st.last_assoc = self.ms.kf_mp[slot]
        st.last_kf_slot = slot
        st.T_last = np.eye(4, dtype=np.float32)
        st.last_ts = timestamp
        st.last_frame = frame
        st.status = "OK"
        st.frames_since_kf = 0
        st.ref_kf_inliers = int(self._read((st.last_assoc >= 0).sum()))
        self._start_device_state(slot, eye, timestamp)
        return True

    def _initialize(self, frame: Frame, timestamp: float):
        f = frame.features
        if self.cfg.tracking.use_pattern:
            # UsePattern: the chessboard's metric init replaces the two-view
            # bootstrap entirely
            self._pattern_initialize(frame, timestamp)
            return
        if self._init_frame is None:
            self._init_frame, self._init_ts = frame, timestamp
            return
        f0 = self._init_frame.features
        res = matching.search_for_initialization(
            f0.uv_und, f0.desc, f0.valid, f0.octave, f0.angle,
            f.uv_und, f.desc, f.valid, f.octave, f.angle)
        kp_to_q = res.kp_to_query  # frame keypoint -> init-frame keypoint
        if not self._sync(res.count() >= 100):
            # too little overlap: restart from this frame
            self._init_frame, self._init_ts = frame, timestamp
            return
        q = torch.clamp(kp_to_q, 0, f0.capacity - 1).long()
        valid = kp_to_q >= 0
        self._init_seed += 1
        ires = init_mod.initialize_two_view(self.cam, f0.uv_und[q], f.uv_und, valid,
                                            self._init_samples(valid))
        if not self._sync(ires.success):
            return
        # scale: median triangulated depth -> 1
        inl = ires.inliers
        med = _nanmedian(torch.where(inl, ires.X1[:, 2], torch.full_like(ires.X1[:, 2], np.nan)))
        X1 = ires.X1 / med
        T2 = lie.se3_from_Rt(ires.R21, ires.t21 / med)
        dev = self.device
        sf, nl = self.cfg.orb.scale_factor, self.cfg.orb.n_levels
        # keyframe 1: the stored init frame at the identity
        slot1 = self._free_kf_slot()
        self._insert_keyframe(slot1, self._init_frame, torch.eye(4, device=dev),
                              self.st.frame_id - 1, self._init_ts, -1)
        # keyframe 2: this frame, with the triangulated points bound to it
        slot2 = self._free_kf_slot()
        self._insert_keyframe(slot2, frame, T2, self.st.frame_id, timestamp, slot1)
        # X1 is in KF1's camera frame, which is the world frame
        self.ms, ids = M.create_points(self.ms, slot2, inl & valid, X1)
        # bind KF1's observations through the match mapping
        created = ids >= 0
        s1 = torch.tensor(slot1, device=dev)
        row1 = scatter_set(take(self.ms.kf_mp, s1), torch.where(created, q, self.ms.N),
                           torch.where(created, ids, torch.full_like(ids, -1)))
        self.ms = M.finalize_point_statistics(self.ms._replace(kf_mp=put(self.ms.kf_mp, s1, row1)),
                                              sf, nl)
        # full BA on the two-view map
        self.ms = ba.global_ba(self.cam, self.ms, fixed_kf=slot1, scale_factor=sf, iters=20)

        st = self.st
        T_kf2 = self.ms.kf_Tcw[slot2]
        st.last_assoc = self.ms.kf_mp[slot2]
        st.last_kf_slot = slot2
        st.T_last = T_kf2.cpu().numpy()
        st.last_ts = timestamp
        st.last_frame = frame
        st.status = "OK"
        st.frames_since_kf = 0
        st.ref_kf_inliers = int((st.last_assoc >= 0).sum())
        self._start_device_state(slot2, T_kf2, timestamp)
        self._init_frame = None
