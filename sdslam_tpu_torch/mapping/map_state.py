"""Array-resident SLAM map: fixed-capacity pools + derived structures
(port of sdslam_tpu/mapping/map_state.py).

`kf_mp[K, N]` (keypoint -> point id, -1 none) is the single source of truth
for the observation graph; observation lists, counts, covisibility and
point statistics are derived from it. Functions are MapState -> MapState
and never modify their input: every update builds new tensors, so a caller
holding an older state keeps it intact (the JAX package's value semantics).

Incidence is float32 here (0/1 values, exact), where the JAX package uses
bf16 for the TPU's MXU. Scatters whose indices can collide resolve
deterministically (last update wins, as XLA:CPU does; see _util).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from sdslam_tpu_torch import _device
from sdslam_tpu_torch._util import as_device, put, scatter_min, scatter_set, scatter_set2, take
from sdslam_tpu_torch.geometry import lie
from sdslam_tpu_torch.kernels.hamming_kernel import _popcount32
from sdslam_tpu_torch.ops import hamming as ham

INT32_MAX = 2**31 - 1


class MapState(NamedTuple):
    # --- keyframe pool [K, ...] ---
    kf_valid: torch.Tensor  # [K] bool
    kf_Tcw: torch.Tensor  # [K,4,4]
    kf_uv: torch.Tensor  # [K,N,2]
    kf_uv_und: torch.Tensor  # [K,N,2]
    kf_octave: torch.Tensor  # [K,N] int32
    kf_angle: torch.Tensor  # [K,N]
    kf_desc: torch.Tensor  # [K,N,8] int32 descriptor words
    kf_kp_valid: torch.Tensor  # [K,N] bool
    kf_depth: torch.Tensor  # [K,N] (-1 none)
    kf_uright: torch.Tensor  # [K,N] (-1 none)
    kf_mp: torch.Tensor  # [K,N] int32 keypoint -> point id (-1)
    kf_frame_id: torch.Tensor  # [K] int32
    kf_timestamp: torch.Tensor  # [K]
    kf_parent: torch.Tensor  # [K] int32 spanning-tree parent (-1 root)
    kf_pyramid: Tuple[torch.Tensor, ...]  # per stored level: [K, H_l, W_l]
    loop_edges: torch.Tensor  # [L,2] int32, -1 padded
    # --- point pool [P, ...] ---
    pt_valid: torch.Tensor  # [P] bool
    pt_pos: torch.Tensor  # [P,3]
    pt_desc: torch.Tensor  # [P,8] int32
    pt_normal: torch.Tensor  # [P,3]
    pt_min_dist: torch.Tensor  # [P]
    pt_max_dist: torch.Tensor  # [P]
    pt_ref_kf: torch.Tensor  # [P] int32
    pt_first_kf: torch.Tensor  # [P] int32
    pt_visible: torch.Tensor  # [P] int32
    pt_found: torch.Tensor  # [P] int32
    # --- counters (0-d int32) ---
    next_kf_id: torch.Tensor
    next_pt_id: torch.Tensor

    @property
    def K(self) -> int:
        return self.kf_valid.shape[0]

    @property
    def P(self) -> int:
        return self.pt_valid.shape[0]

    @property
    def N(self) -> int:
        return self.kf_mp.shape[1]

    @property
    def device(self) -> torch.device:
        return self.kf_valid.device

    def n_keyframes(self):
        return torch.sum(self.kf_valid)

    def n_points(self):
        return torch.sum(self.pt_valid)


def init_map(max_keyframes: int, max_points: int, max_kps: int,
             pyramid_shapes: Tuple[Tuple[int, int], ...], max_loop_edges: int = 32,
             device="cuda") -> MapState:
    K, P, N = max_keyframes, max_points, max_kps
    d = _device.resolve(device)
    f32, i32 = torch.float32, torch.int32

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=d)

    return MapState(
        kf_valid=full((K,), False, torch.bool),
        kf_Tcw=torch.eye(4, device=d).repeat(K, 1, 1),
        kf_uv=full((K, N, 2), 0.0, f32),
        kf_uv_und=full((K, N, 2), 0.0, f32),
        kf_octave=full((K, N), 0, i32),
        kf_angle=full((K, N), 0.0, f32),
        kf_desc=full((K, N, 8), 0, i32),
        kf_kp_valid=full((K, N), False, torch.bool),
        kf_depth=full((K, N), -1.0, f32),
        kf_uright=full((K, N), -1.0, f32),
        kf_mp=full((K, N), -1, i32),
        kf_frame_id=full((K,), 0, i32),
        kf_timestamp=full((K,), 0.0, f32),
        kf_parent=full((K,), -1, i32),
        kf_pyramid=tuple(full((K, h, w), 0.0, f32) for (h, w) in pyramid_shapes),
        loop_edges=full((max_loop_edges, 2), -1, i32),
        pt_valid=full((P,), False, torch.bool),
        pt_pos=full((P, 3), 0.0, f32),
        pt_desc=full((P, 8), 0, i32),
        pt_normal=full((P, 3), 0.0, f32),
        pt_min_dist=full((P,), 0.0, f32),
        pt_max_dist=full((P,), 1e9, f32),
        pt_ref_kf=full((P,), -1, i32),
        pt_first_kf=full((P,), -1, i32),
        pt_visible=full((P,), 1, i32),
        pt_found=full((P,), 1, i32),
        next_kf_id=full((), 0, i32),
        next_pt_id=full((), 0, i32),
    )


def _idx(x, device) -> torch.Tensor:
    """Slot index as a 0-d int64 tensor on device (python int or tensor)."""
    return as_device(x, torch.int64, device).reshape(())


# ---------------------------------------------------------------------------
# slot allocation
# ---------------------------------------------------------------------------

def allocate_slots(valid, want):
    """Assign the i-th wanted item to the i-th free slot; -1 if the pool is
    exhausted or not wanted. valid: [S]; want: [M] bool."""
    S = valid.shape[0]
    free = ~valid
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    n_free = free.sum()
    slot_of_rank = scatter_set(
        torch.full((S,), -1, dtype=torch.int32, device=valid.device),
        torch.where(free, free_rank, S),
        torch.arange(S, dtype=torch.int32, device=valid.device),
    )
    want_rank = torch.cumsum(want.to(torch.int64), 0) - 1
    ok = want & (want_rank < n_free)
    slots = torch.where(ok, slot_of_rank[torch.clamp(want_rank, 0, S - 1)],
                        torch.full_like(slot_of_rank[:1], -1).expand(want.shape))
    return slots.to(torch.int32)


# ---------------------------------------------------------------------------
# derived structures
# ---------------------------------------------------------------------------

def observation_table(ms: MapState):
    """[K,N] observed point id per (kf, kp) slot; -1 where none or the KF
    is invalid."""
    ok = ms.kf_valid[:, None] & ms.kf_kp_valid & (ms.kf_mp >= 0)
    return torch.where(ok, ms.kf_mp, torch.full_like(ms.kf_mp, -1))


def incidence_matrix(ms: MapState, dtype=torch.bfloat16):
    """[K,P] 0/1 incidence: KF k observes point p."""
    obs = observation_table(ms)
    K, N = obs.shape
    P = ms.P
    rows = torch.arange(K, device=obs.device)[:, None].expand(K, N)
    cols = torch.where(obs >= 0, obs, P).long()
    inc = torch.zeros((K, P + 1), dtype=dtype, device=obs.device)
    inc = inc.index_put((rows.reshape(-1), cols.reshape(-1)),
                        torch.ones(K * N, dtype=dtype, device=obs.device))
    return inc[:, :P].contiguous()


def covisibility(ms: MapState, inc=None):
    """[K,K] int32 shared-observation counts (diagonal zeroed); counted in
    float32 whatever the incidence's dtype."""
    inc = (incidence_matrix(ms) if inc is None else inc).float()
    counts = (inc @ inc.T).to(torch.int32)
    counts = counts * (1 - torch.eye(ms.K, dtype=torch.int32, device=inc.device))
    mask = ms.kf_valid
    return counts * (mask[:, None] & mask[None, :])


def point_obs_count_from_inc(ms: MapState, inc):
    """[P] observing-keyframe counts from a precomputed incidence."""
    return inc.sum(0, dtype=torch.float32).to(torch.int32) * ms.pt_valid


def point_obs_count(ms: MapState):
    return point_obs_count_from_inc(ms, incidence_matrix(ms))


def obs_lists_from_table(obs, P: int, max_obs: int = 16):
    """Per-point observation lists (obs_row [P,M], obs_kp [P,M]) int32,
    -1 padded, from an observation table obs [R,N]; within-row duplicate
    bindings keep the first keypoint; rows fill in row order."""
    R, N = obs.shape
    M = max_obs
    dev = obs.device
    ok = obs >= 0
    ps = torch.clamp(obs, 0, P - 1).long()
    rows = torch.arange(R, device=dev)[:, None].expand(R, N)
    kps = torch.arange(N, device=dev)[None, :].expand(R, N)
    lin = rows * P + torch.where(ok, ps, 0)
    first_kp = torch.full((R * P,), N, dtype=torch.int64, device=dev).scatter_reduce(
        0, lin.reshape(-1), torch.where(ok, kps, N).reshape(-1), reduce="amin",
        include_self=True,
    ).reshape(R, P)
    inc = (first_kp < N).to(torch.int64)
    rank_rp = torch.cumsum(inc, 0) - inc
    packed_tab = rank_rp * (N + 1) + first_kp
    packed = packed_tab[rows, ps]
    rank = packed // (N + 1)
    keep = ok & (packed % (N + 1) == kps)
    fits = keep & (rank < M)
    tgt_p = torch.where(fits, ps, P)
    rk = torch.clamp(rank, 0, M - 1)
    val = (rows * N + kps).to(torch.int32)
    packed_out = scatter_set2(torch.full((P, M), -1, dtype=torch.int32, device=dev),
                              tgt_p, rk, val)
    has = packed_out >= 0
    neg = torch.full_like(packed_out, -1)
    return torch.where(has, packed_out // N, neg), torch.where(has, packed_out % N, neg)


def build_obs_lists(ms: MapState, max_obs: int = 16):
    return obs_lists_from_table(observation_table(ms), ms.P, max_obs)


def compact_indices(mask, L: int):
    """Cumsum compaction of a [P] mask into L slots. Returns (idx [L]
    original ids (P-1 padded), in_mask [L], remap [P] -> compact or -1);
    entries beyond L are dropped."""
    P = mask.shape[0]
    dev = mask.device
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    fits = mask & (pos < L)
    idx = scatter_set(torch.full((L,), P - 1, dtype=torch.int32, device=dev),
                      torch.where(fits, pos, L), torch.arange(P, dtype=torch.int32, device=dev))
    n = torch.clamp(mask.sum(), max=L)
    in_mask = torch.arange(L, device=dev) < n
    remap = torch.where(fits, pos, -1).to(torch.int32)
    return idx, in_mask, remap


def _point_stats_core(ms: MapState, obs_kf, obs_kp, pt_pos, max_obs: int = 16):
    """Representative descriptor (min median Hamming), mean viewing normal
    and reference distance/octave for a point subset with lists [Q,M].
    Returns (rep_desc, normal, ref_dist, ref_oct, cnt)."""
    M = max_obs
    kf_safe = torch.clamp(obs_kf, 0, ms.K - 1).long()
    kp_safe = torch.clamp(obs_kp, 0, ms.N - 1).long()
    has = (obs_kf >= 0) & ms.kf_valid[kf_safe]
    descs = ms.kf_desc[kf_safe, kp_safe]  # [Q,M,8]
    d = torch.zeros(descs.shape[:2] + (M,), dtype=torch.int32, device=descs.device)
    for w in range(8):
        d += _popcount32(descs[:, :, None, w] ^ descs[:, None, :, w])
    pair_ok = has[:, :, None] & has[:, None, :]
    d = torch.where(pair_ok, d, torch.full_like(d, ham.BIG))
    cnt = has.sum(1)
    d_sorted = torch.sort(d, dim=-1).values
    med_idx = torch.clamp(cnt // 2, 0, M - 1)
    med = torch.gather(d_sorted, 2, med_idx[:, None, None].expand(-1, M, 1))[..., 0]
    med = torch.where(has, med, torch.full_like(med, ham.BIG))
    best = torch.argmin(med, dim=1)
    q = torch.arange(descs.shape[0], device=descs.device)
    rep_desc = descs[q, best]
    centers = lie.se3_t(lie.se3_inv(ms.kf_Tcw))
    vec = pt_pos[:, None, :] - centers[kf_safe]
    dist = torch.linalg.norm(vec, dim=-1)
    dirn = vec / torch.clamp(dist[..., None], min=1e-9)
    nsum = torch.sum(torch.where(has[..., None], dirn, torch.zeros_like(dirn)), 1)
    normal = nsum / torch.clamp(torch.linalg.norm(nsum, dim=-1, keepdim=True), min=1e-9)
    ref_kf = kf_safe[q, best]
    ref_kp = kp_safe[q, best]
    ref_dist = torch.linalg.norm(pt_pos - centers[ref_kf], dim=-1)
    ref_oct = ms.kf_octave[ref_kf, ref_kp].to(torch.float32)
    return rep_desc, normal, ref_dist, ref_oct, cnt


def update_point_statistics(ms: MapState, max_obs: int = 16):
    obs_kf, obs_kp = build_obs_lists(ms, max_obs)
    return _point_stats_core(ms, obs_kf, obs_kp, ms.pt_pos, max_obs)


def finalize_point_statistics(ms: MapState, scale_factor: float, n_levels: int,
                              max_obs: int = 16) -> MapState:
    """Recompute descriptors / normals / scale bands over the whole pool."""
    rep_desc, normal, ref_dist, ref_oct, cnt = update_point_statistics(ms, max_obs)
    has = (cnt > 0) & ms.pt_valid
    max_dist = ref_dist * scale_factor**ref_oct
    min_dist = max_dist / (scale_factor ** (n_levels - 1))
    return ms._replace(
        pt_desc=torch.where(has[:, None], rep_desc, ms.pt_desc),
        pt_normal=torch.where(has[:, None], normal, ms.pt_normal),
        pt_min_dist=torch.where(has, min_dist, ms.pt_min_dist),
        pt_max_dist=torch.where(has, max_dist, ms.pt_max_dist),
    )


def finalize_point_statistics_local(ms: MapState, rows_mask, scale_factor: float,
                                    n_levels: int, max_pts: int = 2048, max_obs: int = 16,
                                    obs_lists=None, touched=None) -> MapState:
    """finalize_point_statistics restricted to the points observed by the
    keyframe rows in rows_mask [K] (or an explicit touched [P] mask),
    compacted to max_pts; overflowing points keep their statistics."""
    P = ms.P
    obs = observation_table(ms)
    if touched is None:
        sel = rows_mask[:, None] & (obs >= 0)
        touched = scatter_set(torch.zeros(P, dtype=torch.bool, device=obs.device),
                              torch.where(sel, obs, P), True)
    touched = touched & ms.pt_valid
    PL = min(max_pts, P)
    pt_idx, pt_in, pt_remap = compact_indices(touched, PL)
    pt_idx_l = pt_idx.long()
    if obs_lists is None:
        obs_c = torch.where(obs >= 0, pt_remap[torch.clamp(obs, 0, P - 1).long()],
                            torch.full_like(obs, -1))
        obs_row, obs_kp = obs_lists_from_table(obs_c, PL, max_obs)
    else:
        obs_row, obs_kp = (a[pt_idx_l] for a in obs_lists)
    rep_desc, normal, ref_dist, ref_oct, cnt = _point_stats_core(
        ms, obs_row, obs_kp, ms.pt_pos[pt_idx_l], max_obs
    )
    has = (cnt > 0) & pt_in
    max_dist = ref_dist * scale_factor**ref_oct
    min_dist = max_dist / (scale_factor ** (n_levels - 1))
    tgt = torch.where(has, pt_idx, P)
    return ms._replace(
        pt_desc=scatter_set(ms.pt_desc, tgt, rep_desc),
        pt_normal=scatter_set(ms.pt_normal, tgt, normal),
        pt_min_dist=scatter_set(ms.pt_min_dist, tgt, min_dist),
        pt_max_dist=scatter_set(ms.pt_max_dist, tgt, max_dist),
    )


# ---------------------------------------------------------------------------
# mutation ops
# ---------------------------------------------------------------------------

def insert_keyframe(ms: MapState, slot, Tcw, uv, uv_und, octave, angle, desc, kp_valid,
                    depth, uright, mp_assoc, pyramid, frame_id, timestamp, parent) -> MapState:
    s = _idx(slot, ms.device)

    def row(x, v):
        return put(x, s, as_device(v, x.dtype, ms.device))

    return ms._replace(
        kf_valid=row(ms.kf_valid, True),
        kf_Tcw=row(ms.kf_Tcw, Tcw),
        kf_uv=row(ms.kf_uv, uv),
        kf_uv_und=row(ms.kf_uv_und, uv_und),
        kf_octave=row(ms.kf_octave, octave),
        kf_angle=row(ms.kf_angle, angle),
        kf_desc=row(ms.kf_desc, desc),
        kf_kp_valid=row(ms.kf_kp_valid, kp_valid),
        kf_depth=row(ms.kf_depth, depth),
        kf_uright=row(ms.kf_uright, uright),
        kf_mp=row(ms.kf_mp, mp_assoc),
        kf_frame_id=row(ms.kf_frame_id, frame_id),
        kf_timestamp=row(ms.kf_timestamp, timestamp),
        kf_parent=row(ms.kf_parent, parent),
        kf_pyramid=tuple(row(pool, img) for pool, img in zip(ms.kf_pyramid, pyramid)),
        next_kf_id=ms.next_kf_id + 1,
    )


def create_points(ms: MapState, kf_slot, want, pos_w):
    """Create points bound to keypoints of kf_slot. Returns (new_ms,
    point_ids [N] int32, -1 where not created)."""
    s = _idx(kf_slot, ms.device)
    slots = allocate_slots(ms.pt_valid, want)
    ok = slots >= 0
    sl = torch.where(ok, slots, ms.P)
    ms = ms._replace(
        pt_valid=scatter_set(ms.pt_valid, sl, True),
        pt_pos=scatter_set(ms.pt_pos, sl, pos_w),
        pt_desc=scatter_set(ms.pt_desc, sl, take(ms.kf_desc, s)),
        pt_ref_kf=scatter_set(ms.pt_ref_kf, sl, s.to(torch.int32)),
        pt_first_kf=scatter_set(ms.pt_first_kf, sl, ms.next_kf_id),
        pt_visible=scatter_set(ms.pt_visible, sl, 1),
        pt_found=scatter_set(ms.pt_found, sl, 1),
        next_pt_id=ms.next_pt_id + ok.sum().to(torch.int32),
    )
    row = torch.where(ok, slots, take(ms.kf_mp, s))
    ms = ms._replace(kf_mp=put(ms.kf_mp, s, row))
    return ms, torch.where(ok, slots, torch.full_like(slots, -1))


def remove_points(ms: MapState, kill_mask) -> MapState:
    """Invalidate points and scrub them from every keyframe row."""
    pt_valid = ms.pt_valid & ~kill_mask
    alive = pt_valid[torch.clamp(ms.kf_mp, 0, ms.P - 1).long()] & (ms.kf_mp >= 0)
    return ms._replace(pt_valid=pt_valid,
                       kf_mp=torch.where(alive, ms.kf_mp, torch.full_like(ms.kf_mp, -1)))


def remove_keyframes(ms: MapState, kill_mask, covis=None) -> MapState:
    """Invalidate keyframes: re-parent orphans to their most covisible
    earlier survivor (else the culled KF's parent), re-anchor points whose
    reference KF dies to their earliest surviving observer, drop loop
    edges touching a culled KF."""
    K, dev = ms.K, ms.device
    valid_new = ms.kf_valid & ~kill_mask
    if covis is None:
        covis = covisibility(ms)
    par = ms.kf_parent
    par_safe = torch.clamp(par, 0, K - 1).long()
    orphan = valid_new & (par >= 0) & kill_mask[par_safe]
    fid = ms.kf_frame_id
    earlier = fid[None, :] < fid[:, None]
    w = torch.where(valid_new[None, :] & earlier, covis, torch.full_like(covis, -1))
    best = torch.argmax(w, dim=1)
    has_best = torch.gather(w, 1, best[:, None])[:, 0] > 0
    grandpa = par[par_safe]
    gp_ok = (grandpa >= 0) & valid_new[torch.clamp(grandpa, 0, K - 1).long()]
    new_par = torch.where(has_best, best.to(torch.int32),
                          torch.where(gp_ok, grandpa, torch.full_like(grandpa, -1)))
    kf_parent = torch.where(orphan, new_par, par)

    obs = torch.where(valid_new[:, None] & ms.kf_kp_valid & (ms.kf_mp >= 0), ms.kf_mp,
                      torch.full_like(ms.kf_mp, -1))
    rows = torch.arange(K, dtype=torch.int32, device=dev)[:, None].expand(obs.shape)
    first_kf = scatter_min(torch.full((ms.P,), K, dtype=torch.int32, device=dev),
                           torch.where(obs >= 0, obs, ms.P), rows)
    ref_dead = ms.pt_valid & kill_mask[torch.clamp(ms.pt_ref_kf, 0, K - 1).long()] & (
        ms.pt_ref_kf >= 0)
    pt_ref_kf = torch.where(ref_dead, torch.where(first_kf < K, first_kf,
                                                  torch.full_like(first_kf, -1)), ms.pt_ref_kf)
    le = ms.loop_edges
    le_dead = (le < 0) | kill_mask[torch.clamp(le, 0, K - 1).long()]
    loop_edges = torch.where(le_dead.any(1)[:, None], torch.full_like(le, -1), le)
    return ms._replace(
        kf_valid=valid_new,
        kf_mp=torch.where(kill_mask[:, None], torch.full_like(ms.kf_mp, -1), ms.kf_mp),
        kf_parent=kf_parent, pt_ref_kf=pt_ref_kf, loop_edges=loop_edges,
    )


def add_loop_edge(ms: MapState, i, j) -> MapState:
    """Record a persistent loop edge (KeyFrame::AddLoopEdge) in the first
    free row; dropped when the fixed-capacity store is full."""
    free = ms.loop_edges[:, 0] < 0
    L = ms.loop_edges.shape[0]
    slot = torch.where(free.any(), torch.argmax(free.to(torch.int32)), L)
    pair = torch.stack([as_device(i, torch.int32, ms.device).reshape(()),
                        as_device(j, torch.int32, ms.device).reshape(())])
    return ms._replace(loop_edges=scatter_set(ms.loop_edges, slot.reshape(1), pair[None]))


def replace_points(ms: MapState, replace_map) -> MapState:
    """Redirect every observation of point a to replace_map[a] (>= 0), then
    invalidate the replaced points (MapPoint::Replace semantics)."""
    P = ms.P
    idx = torch.arange(P, dtype=torch.int32, device=ms.device)
    killed = replace_map >= 0
    pt_valid = ms.pt_valid & ~killed
    final = torch.where(killed, replace_map, idx)
    code = torch.where(pt_valid[torch.clamp(final, 0, P - 1).long()], final,
                       torch.full_like(final, -1))
    new_mp = torch.where(ms.kf_mp >= 0, code[torch.clamp(ms.kf_mp, 0, P - 1).long()], ms.kf_mp)
    return ms._replace(pt_valid=pt_valid, kf_mp=new_mp)


def update_tracking_counters(ms: MapState, cam, Tcw, assoc) -> MapState:
    """Bump per-point visible (in the frustum of Tcw) / found (associated)
    counters at keyframe cadence."""
    from sdslam_tpu_torch.geometry import camera as cam_mod

    uv, z = cam_mod.project(cam, lie.se3_apply(Tcw, ms.pt_pos))
    visible = ms.pt_valid & (z > 0.05) & cam_mod.in_image(cam, uv, 5.0)
    found = scatter_set(torch.zeros(ms.P, dtype=torch.bool, device=ms.device),
                        torch.where(assoc >= 0, assoc, ms.P), True)
    return ms._replace(
        pt_visible=ms.pt_visible + visible.to(torch.int32),
        pt_found=ms.pt_found + (found & ms.pt_valid).to(torch.int32),
    )
