"""On-card smoke test of the PyTorch/CUDA port (sdslam_tpu_torch).

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits nonzero):
  1. device   card name / power limit (nvidia-smi), torch name, capability
  2. build    nvcc for every kernel source, all in parallel; then each
              compiled function's registers, shared memory and spills
  3. kernels  each CUDA kernel (K4 in both its forms) against its plain
              PyTorch version on the card at main-path shapes, with
              median times (CUDA events around one wrapper call), device
              times (torch.profiler, the kernel's own events), the least
              time the card could take (bound) and, where one PyTorch call
              computes the same function, that call's time
  4. main     the RGB-D tracking + keyframe-mapping path at full size
              (640x480, 1024 keypoints, 256 KF slots, 16384 points) on a
              60-frame synthetic orbit rendered on the card; checks ATE,
              keyframes and that every kernel of the path was launched
  5. reloc    the same configuration: kidnap (blank frame) and recovery
              photometrically, a 35 deg rolled revisit recovered by EPnP,
              and an unrelated scene that must stay LOST
  6. loop     SDSlamSystem with loop closing on the organic circuit (a
              closed 3.5 m room, 240 + 40 frames, depth-scale drift): a
              correction with global BA must fire and lower the keyframe ATE
  7. mono     the monocular SDSlamSystem (loop closing on) at the default
              configuration on a 32-frame orbit: two-view bootstrap within
              the first frames, then tracking and mapping; Sim3-aligned ATE
  8. fusion   the monocular + IMU SDSlamSystem on a jerky direction-
              reversing sequence with gyro and accelerometer synthesized
              from the ground truth; the device IMU filter must follow
  9. io       the recorded-data paths at the main configuration: a 40-frame
              orbit written as a TUM sequence and tracked by the CLI's
              `rgbd` subcommand (TUM trajectory, npz and YAML maps); both
              maps loaded into fresh systems that relocalize against them;
              phase 8's sequence written as EuRoC and tracked by `fusion`;
              the StreamRunner over 10 frames with late depth messages
 10. dist     the distributed solvers (sdslam_tpu_torch/parallel) at the
              multi-chip dry run's production shapes, in ranks spawned on
              the card: a world of one over NCCL and a world of four over
              gloo (NCCL refuses two ranks on one card). Dist-BA at K = 64,
              P = 16384, 8 observations per point, 2 GN iterations, and at
              the small K = 8 map (K6); dist-PGO on a 96-keyframe ring with
              a loop edge, 8 iterations; dist-align of slot 37's pyramid
              against a 64-slot pool, 8 iterations. The two worlds must
              agree (dT < 5e-4, dX < 5e-3, dS < 5e-4, dA < 1e-5), the loop
              must close and slot 37 must win
 11. pipelined  phase 4's orbit through PipelinedRGBDTracker: tracking on
              the current stream, each keyframe's mapping pass on a second
              stream from a worker thread; ATE, keyframes, and the
              tracking snapshot on the tracking device
 12. pattern  the monocular SDSlamSystem with chessboard initialization
              (UsePattern) and loop closing on the poster scene (the room
              texture on a poster at 0.5 m with a 6x4, 28.3 mm board): a
              metric map at frame 0 (median depth within 0.15 m of 0.5 m),
              SE(3)-aligned ATE over 30 frames, the path length against the
              truth (reported); an attempt on a frame without a board; then
              the CLI's `calibration` on six rendered board views
 13. viewer   the RGB-D SDSlamSystem on a 40-frame orbit with a LiveViewer
              that a client thread drives over HTTP (renders, an AR plane,
              localization on and off, stop and save) while another polls
              it; apply_pending must make no blocking call; then an RGBDNode
              over the same facade, the CLI with --viewer-port, and one
              V4L2 frame where /dev/video0 exists
 14. large    the large-map regime of tests/test_large_map.py at full
              width: 256 keyframe slots filled from a 256-frame orbit
              (radius 0.25, yaw 0.2), 65536 points, points with several
              observers; incidence and covisibility over the pool,
              relocalization of frame 77 against every slot, the world-1
              alignment scan, local BA at slot 77
Then the kernel table as one JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Launch counters are set to 0 before each of
phases 4-14 and read after it (phase 10's ranks count their own measured
calls and return the counts). Phases 12 and 13 must take 60 s or less.

It imports nothing from JAX or the JAX package and never runs on the CPU.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import time
import warnings

import numpy as np
import torch

SEED = 0
REPS = 25


EMITTED = {}  # phase -> the last line it printed (later phases compare with it)


def emit(phase: str, **kw):
    EMITTED[phase] = kw
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median per-call device time of fn() over `reps` calls (CUDA events
    around each call, after `warmup` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_profile(fn, names, n: int = 10):
    """Device time of fn() per call from torch.profiler over `n` calls:
    `device_ms` sums the kernels whose name contains one of `names` (the
    kernel's own events) and `kernels_per_call` counts them;
    `device_all_ms` and `device_ops_per_call` cover every device event of
    the calls (kernels, copies, fills). The tracer misses launches right
    after it starts, so each trace runs `n` warm-up calls, idles the card
    for 20 ms and runs the `n` measured calls; only the device events after
    that gap count. A trace whose counts are not whole multiples of `n` is
    taken again; the function raises if 5 traces in a row are incomplete."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        time.sleep(0.1 * attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if e.device_type != DeviceType.CPU),
                     key=lambda e: e.time_range.start)
        # the measured calls: the events after the widest gap, when it is the idle one
        gap, cut = max(((b.time_range.start - a.time_range.end, k + 1)
                        for k, (a, b) in enumerate(zip(evs, evs[1:]))), default=(0, 0))
        evs = evs[cut:] if gap > 10e3 else evs
        own = [e for e in evs if any(s in e.name for s in names)]
        if own and len(own) % n == 0 and len(evs) % n == 0:
            break
    else:
        raise AssertionError(f"5 incomplete traces of {names}: {len(own)} own events, "
                             f"{len(evs)} in all, for {n} calls")
    return {"device_ms": sum(e.time_range.elapsed_us() for e in own) / n / 1e3,
            "kernels_per_call": len(own) / n,
            "device_all_ms": sum(e.time_range.elapsed_us() for e in evs) / n / 1e3,
            "device_ops_per_call": len(evs) / n}


# --------------------------------------------------------------------------
# bounds: the least time the card could take for a kernel's work, the larger
# of its bytes (each input read once, each output written once) over the
# memory rate and its operations over the scalar float32 rate (NVIDIA H100
# SXM data sheet; integer and float operations alike, so the bound stays a
# lower bound). Operation counts per unit of work, counted from the sources:
# --------------------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
PROJ_FLOP = 25  # transform (18) + perspective division and intrinsics (7)
TAP_FLOP = 26  # bilinear blend (9), residual (2), J^T r (12), r^2 (2), count (1)
TAP_BYTES = 28  # a valid tap's Jacobian row (6 floats) and reference intensity
POSE_EDGE_FLOP = 230  # residual + 3x6 Jacobian + robust weight + H (126) + b (36)
POSE_RESID_FLOP = 40  # the residual-only pass closing each round
BA_EDGE_FLOP = 450  # Jc/Jp, W, Hcc, bc, Hpp, bp and the V.ybp terms of one edge
BA_POINT_FLOP = 150  # 3x3 damped Cholesky inverse, ybp and Ze per point
HAMMING_OPS_PER_WORD = 3  # xor, popcount, add
BA_EDGE_TERMS_FLOP = 460  # projection, residual, Huber, Jc/Jp and the 55 outputs of one edge


def chol_flop(N: int) -> float:
    """Factor (N^3 / 3) and the two triangular solves (2 N^2 each)."""
    return N**3 / 3.0 + 4.0 * N**2


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by) for the given bytes and operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# --------------------------------------------------------------------------
# phase 3 inputs: main-path shapes, made on the card from SEED
# --------------------------------------------------------------------------

def _align_inputs(dev, level: int, n_pts: int = 1024):
    from sdslam_tpu_torch.geometry import camera as cam_mod, lie
    from sdslam_tpu_torch.io import synthetic
    from sdslam_tpu_torch.ops import pyramid
    from sdslam_tpu_torch.solvers import image_align as ia

    cam = main_camera()
    seq = synthetic.SyntheticSequence(cam, n_frames=60, trajectory="orbit", radius=0.06,
                                      yaw_amp=0.04, device=dev)
    _, img0, dep0 = seq.frame(0)
    _, img1, _ = seq.frame(2)
    pyr0 = pyramid.build_pyramid(img0, 5)
    pyr1 = pyramid.build_pyramid(img1, 5)
    g = torch.Generator(device="cpu").manual_seed(SEED)
    uv = torch.stack([torch.rand(n_pts, generator=g) * (cam.width - 60) + 30,
                      torch.rand(n_pts, generator=g) * (cam.height - 60) + 30], -1).to(dev)
    from sdslam_tpu_torch.ops import sample
    d = sample.sample_nearest(dep0, uv)
    X = cam_mod.backproject(cam, uv, torch.clamp(d, min=1e-3))
    s = 0.5**level
    patch, J, ok = ia._precompute_level(pyr0[level], uv * s, X, d > 0, cam.fx * s, cam.fy * s)
    Hinv = ia.damped_hessian_inverse(J, ok)
    T0 = (seq.poses[2] @ lie.se3_inv(seq.poses[0])).to(dev)
    T_init = lie.se3_exp(torch.tensor([0.004, -0.003, 0.002, 0.002, -0.003, 0.001],
                                      device=dev)) @ T0
    args = (pyr1[level].contiguous(), X.contiguous(), patch.contiguous(), J.contiguous(),
            ok.contiguous(), Hinv.contiguous(), T_init.contiguous(),
            cam.fx * s, cam.fy * s, cam.cx * s, cam.cy * s, 30)
    return args


# unit axis of the prior's rotation offset from the true pose
PRIOR_AXIS = (0.6, -0.48, 0.64)


def _pose_inputs(dev, prior_rot: float, n: int = 1024):
    from sdslam_tpu_torch.geometry import camera as cam_mod, lie
    from sdslam_tpu_torch.kernels import pose_kernel as pk

    cam = main_camera()
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    X = torch.stack([torch.rand(n, generator=g) * 3 - 1.5, torch.rand(n, generator=g) * 2 - 1,
                     torch.rand(n, generator=g) * 2.5 + 1.0], -1)
    T_gt = lie.se3_exp(torch.tensor([0.05, -0.02, 0.03, 0.02, -0.04, 0.01]))
    uv, z = cam_mod.project(cam, lie.se3_apply(T_gt, X))
    uv = uv + torch.randn(n, 2, generator=g) * 0.5
    out = torch.rand(n, generator=g) < 0.1
    uv = torch.where(out[:, None], uv + 25.0, uv)
    stereo = torch.rand(n, generator=g) < 0.7
    ur = torch.where(stereo, uv[:, 0] - cam.bf / z, torch.full_like(z, -1.0))
    octave = torch.randint(0, 4, (n,), generator=g)
    isig = 1.0 / 2.0 ** (2.0 * octave.float())
    valid = torch.rand(n, generator=g) < 0.8
    edata = pk.pack_edges(X, uv, ur, isig, valid, ur >= 0).to(dev).contiguous()
    T_init = (lie.se3_exp(torch.tensor([0.03, 0.02, -0.02, 0.01, 0.01, -0.02])) @ T_gt).to(dev)
    rot = [prior_rot * a for a in PRIOR_AXIS]
    T_prior = (lie.se3_exp(torch.tensor([0.01, 0.0, 0.01, *rot])) @ T_gt).to(dev)
    info = torch.tensor([1.0 / 0.01**2, 1.0 / 0.05**2], device=dev)
    return (edata, T_init.contiguous(), lie.se3_inv(T_prior).contiguous(), info,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, 2, 5, True)


def _ba_inputs(dev, K: int, Mo: int = 10, P: int = 2048):
    from sdslam_tpu_torch.geometry import camera as cam_mod, lie

    cam = main_camera()
    g = torch.Generator(device="cpu").manual_seed(SEED + 2 + K)
    xi = torch.cat([torch.randn(K, 3, generator=g) * 0.2, torch.randn(K, 3, generator=g) * 0.05], 1)
    T = lie.se3_exp(xi)  # [K,4,4]
    X = torch.stack([torch.rand(P, generator=g) * 3 - 1.5, torch.rand(P, generator=g) * 2 - 1,
                     torch.rand(P, generator=g) * 2.5 + 1.5], -1)
    cam_idx = torch.randint(0, K, (Mo, P), generator=g)
    Tc = T[cam_idx]  # [Mo,P,4,4]
    Xc = lie.se3_apply(Tc, X[None].expand(Mo, P, 3))
    uv, z = cam_mod.project(cam, Xc)
    uv = uv + torch.randn(Mo, P, 2, generator=g) * 0.5
    stereo = torch.rand(Mo, P, generator=g) < 0.7
    ur = torch.where(stereo, uv[..., 0] - cam.bf / z, torch.full_like(z, -1.0))
    octave = torch.randint(0, 4, (Mo, P), generator=g).float()
    ok = (torch.rand(Mo, P, generator=g) < 0.9).float()
    cam_act = (cam_idx > 0).float()
    pt_act = (torch.rand(P, generator=g) < 0.95).float()[None].expand(Mo, P)
    Tn = (T + torch.randn(K, 4, 4, generator=g) * 1e-3 * (torch.arange(4) < 3)[:, None]).reshape(K, 16)
    Xn = X + torch.randn(P, 3, generator=g) * 0.01
    planes = [Tn[cam_idx][..., c] for c in range(16)]
    planes += [Xn[:, c][None].expand(Mo, P) for c in range(3)]
    planes += [uv[..., 0], uv[..., 1], ur, 1.0 / 2.0 ** (2.0 * octave), stereo.float(), ok,
               cam_act, pt_act, cam_idx.float()]
    packed = torch.stack(planes).to(dev).contiguous()
    lam = torch.tensor(1e-4, device=dev)
    return (packed, lam, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, True, K)


WINDOW_PX = 8.0  # half width of the search window around a projection


def _window_mask(uv_proj, q_valid, q_oct, kp_uv, kp_valid, kp_oct, radius: float = WINDOW_PX):
    """The gating mask of features/matching.py:window_match, written out
    here so that both trees of scripts/profile_torch_kernels.py can make it:
    the window around each projection, both sides valid, the octave gate
    [octave - 1, octave + 1]."""
    du = torch.abs(uv_proj[:, None, 0] - kp_uv[None, :, 0])
    dv = torch.abs(uv_proj[:, None, 1] - kp_uv[None, :, 1])
    mask = (du <= radius) & (dv <= radius)
    mask &= q_valid[:, None] & kp_valid[None, :]
    mask &= (kp_oct[None, :] >= q_oct[:, None] - 1) & (kp_oct[None, :] <= q_oct[:, None] + 1)
    return mask


def _best2_inputs(dev, na: int, nb: int):
    """A windowed search at the main path's shapes: nb keypoints in the
    640x480 image, a quarter of them near-copies of another (1 px away, the
    same descriptor and octave: ties for the first minimum), and na
    projections, each within ~3 px of a keypoint with ~13 of its 256 bits
    flipped; 5% of the queries invalid and some projections off the image
    (rows with every pair masked). Returns (da, db, window-mask args)."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 6)
    cam = main_camera()

    def bits(n, p):
        b = (torch.rand(n, 8, 32, generator=g) < p).to(torch.int64) << torch.arange(32)
        return b.sum(-1).to(torch.int32)  # wraps to int32 bit patterns

    db = bits(nb, 0.5)
    kp_uv = torch.rand(nb, 2, generator=g) * torch.tensor([cam.width, cam.height])
    kp_oct = torch.randint(0, 5, (nb,), generator=g)
    dup = torch.arange(nb // 4, nb // 2)
    src = torch.randint(0, nb // 4, (dup.numel(),), generator=g)
    db[dup], kp_oct[dup] = db[src], kp_oct[src]
    kp_uv[dup] = kp_uv[src] + torch.rand(dup.numel(), 2, generator=g) * 2 - 1
    kp_valid = torch.rand(nb, generator=g) < 0.97
    t = torch.randint(0, nb, (na,), generator=g)
    da = db[t] ^ bits(na, 0.05)
    uv = kp_uv[t] + torch.randn(na, 2, generator=g) * 3.0
    uv[torch.rand(na, generator=g) < 0.03] += 1000.0
    q_valid = torch.rand(na, generator=g) < 0.95
    args = (uv, q_valid, kp_oct[t], kp_uv, kp_valid, kp_oct)
    return da.to(dev), db.to(dev), tuple(a.to(dev) for a in args)


def _batched_inputs(dev, level: int, B: int = 256, n_pts: int = 1024, n_refs: int = 8,
                    invalid_lanes=()):
    """One batched alignment level at the relocalization shapes: B lanes
    (keyframe slots), each with its own reference frame of the orbit and
    its own keypoints, against one current image, at an iterate perturbed
    from the true relative pose. The lanes in `invalid_lanes` have no valid
    tap (empty keyframe slots). Returns (img, X_ref, patch, J, ok, T [B,4,4],
    (fx, fy, cx, cy))."""
    from sdslam_tpu_torch.geometry import camera as cam_mod, lie
    from sdslam_tpu_torch.io import synthetic
    from sdslam_tpu_torch.ops import pyramid, sample
    from sdslam_tpu_torch.solvers import image_align as ia

    cam = main_camera()
    seq = synthetic.SyntheticSequence(cam, n_frames=60, trajectory="orbit", radius=0.06,
                                      yaw_amp=0.04, device=dev)
    refs = [seq.frame(2 * k) for k in range(n_refs)]
    _, cur, _ = seq.frame(7)
    g = torch.Generator(device="cpu").manual_seed(SEED + 4)
    lane_ref = torch.arange(B) % n_refs
    ref_lvl = torch.stack([pyramid.build_pyramid(refs[r][1], 5)[level] for r in range(n_refs)])
    uv = torch.stack([torch.rand(B, n_pts, generator=g) * (cam.width - 60) + 30,
                      torch.rand(B, n_pts, generator=g) * (cam.height - 60) + 30], -1).to(dev)
    d = torch.stack([sample.sample_nearest(refs[int(r)][2], uv[b]) for b, r in enumerate(lane_ref)])
    X = cam_mod.backproject(cam, uv, torch.clamp(d, min=1e-3))
    s = 0.5**level
    patch, J, ok = ia._precompute_level(ref_lvl[lane_ref.to(dev)], uv * s, X, d > 0,
                                        cam.fx * s, cam.fy * s)
    T_true = seq.poses[7][None] @ lie.se3_inv(seq.poses[2 * lane_ref])
    xi = torch.randn(B, 6, generator=g) * torch.tensor([0.004, 0.004, 0.004, 0.003, 0.003, 0.003])
    T = (lie.se3_exp(xi) @ T_true).to(dev)
    if len(invalid_lanes):
        ok = ok.clone()
        ok[torch.as_tensor(list(invalid_lanes), device=dev)] = False
    img = pyramid.build_pyramid(cur, 5)[level]
    return (img.contiguous(), X.contiguous(), patch.contiguous(), J.contiguous(),
            ok.contiguous(), T.contiguous(), (cam.fx * s, cam.fy * s, cam.cx * s, cam.cy * s))


def _gn_inputs(dev, level: int):
    """K5's one-evaluation form at the relocalization shapes: the points of
    _batched_inputs already moved into the current camera by each lane's
    iterate."""
    from sdslam_tpu_torch.geometry import lie

    img, X, patch, J, ok, T, intr = _batched_inputs(dev, level)
    return (img, lie.se3_apply(T[:, None], X).contiguous(), patch, J, ok, *intr)


# A batched lane's stop test is a float tie when the plain loop's own values
# stand within the rounding of the kernel's and the plain einsum's sums of
# each other: chi2 within TIE_CHI2_REL of the best before it (a few times the
# largest kernel-vs-plain chi2 difference seen at a parting, 7.1e-7), or
# |delta|_inf within TIE_DELTA of the 1e-7 convergence threshold. At most
# TIE_LANES_MAX of a case's lanes may part at a tie.
TIE_CHI2_REL = 2e-6
TIE_DELTA = 1e-9
TIE_LANES_MAX = 0.02


def _lane_decision(args, b: int, k_iter: int, p_iter: int):
    """Where the kernel's and the plain loop's GN iterations part on lane b:
    the stop test of iteration min(k_iter, p_iter) - 1, recomputed by the
    plain loop's arithmetic on that lane alone, and whether it is a float
    tie (TIE_CHI2_REL, TIE_DELTA)."""
    from sdslam_tpu_torch.geometry import lie
    from sdslam_tpu_torch.kernels import accumulate_gn_kernel as gk

    img, X, patch, J, okpx, L, T0, fx, fy, cx, cy, _ = args
    sl = slice(b, b + 1)
    T, best = T0[sl], math.inf
    j = min(k_iter, p_iter) - 1
    for it in range(j + 1):
        bb, chi_sum, n = gk.accumulate_gn_plain(img, lie.se3_apply(T[:, None], X[sl]), patch[sl],
                                                J[sl], okpx[sl], fx, fy, cx, cy)
        chi2 = float(chi_sum[0] / torch.clamp(n[0], min=1))
        delta = torch.cholesky_solve(bb[..., None], L[sl])[..., 0]
        if it < j:
            best = min(best, chi2)
            T = T @ lie.se3_exp(-delta)
    margin = chi2 / best - 1.0 if 0.0 < best < math.inf else math.inf
    dmax = float(delta.abs().max())
    tie = (j > 0 and abs(margin) <= TIE_CHI2_REL) or abs(dmax - 1e-7) <= TIE_DELTA
    return {"lane": b, "gn_iterations": k_iter, "gn_iterations_plain": p_iter,
            "chi2_over_best_minus_1": margin, "delta_max": dmax, "tie": tie}


PTXAS_FN = re.compile(r"(?:Compiling entry function|Function properties for) '?(\w+)'?")
PTXAS_NUM = re.compile(r"(\d+) (registers|bytes smem|bytes stack frame|bytes spill stores|"
                       r"bytes spill loads)")


def ptxas_summary(log: str):
    """Per compiled function of one nvcc -Xptxas -v log: registers, static
    shared memory, stack frame and spill bytes."""
    keys = {"registers": "registers", "bytes smem": "smem_bytes",
            "bytes stack frame": "stack_bytes", "bytes spill stores": "spill_store_bytes",
            "bytes spill loads": "spill_load_bytes"}
    out, cur = {}, None
    for ln in log.splitlines():
        m = PTXAS_FN.search(ln)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is not None:
            for num, what in PTXAS_NUM.findall(ln):
                cur[keys[what]] = int(num)
    return out


def _spd_system(dev, N: int):
    """A random SPD [N, N] system from SEED (A A^T + N I)."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 5 + N)
    A = torch.randn(N, N, generator=g)
    S = (A @ A.T + N * torch.eye(N)).to(dev).contiguous()
    return S, torch.randn(N, generator=g).to(dev)


def _ba_system(dev, K: int, n_fixed: int = 2, lm_lambda: float = 1e-4):
    """Local BA's reduced camera system [6K, 6K], made on the card from
    SEED as tests/test_torch_chol.py makes it: a Schur-like SPD S0, then
    solvers/ba.py's diagonal: FIXED_PRIOR on the first n_fixed cameras,
    lm_lambda x (the camera block's trace / 6) on the others."""
    from sdslam_tpu_torch.solvers.ba_const import FIXED_PRIOR

    n = 6 * K
    g = torch.Generator(device=dev).manual_seed(SEED)
    A = torch.randn(n, n, generator=g, device=dev)
    S0 = A @ A.T + n * torch.eye(n, device=dev)
    tr = torch.diagonal(S0).reshape(K, 6).sum(1)
    active = torch.arange(K, device=dev) >= n_fixed
    prior = torch.where(active, lm_lambda * torch.clamp(tr / 6.0, min=1e-6),
                        torch.full_like(tr, FIXED_PRIOR))
    S = (S0 + torch.diag(prior.repeat_interleave(6))).contiguous()
    return S, torch.randn(n, generator=g, device=dev)


def main_camera():
    from sdslam_tpu_torch.geometry.camera import CameraModel

    return CameraModel(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480, bf=40.0)


def _max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _channel_rel(a, ref):
    """Per-channel worst error of a against ref (channels on the first axis).

    The channels of one output differ in size by orders of magnitude
    (Hcc ~1e6 beside -Jc^T w r ~1e2; Hpp^-1 ~1e-6 beside rho ~1e2; an
    inactive point's Hpp^-1 ~1e9 beside an active one's), so no one scale
    serves a whole tensor. Each entry is held relative to |ref| plus its
    channel's median nonzero |ref|: the channel scale bounds entries that
    cancel to about zero, and a few huge entries cannot inflate it."""
    a = a.double().reshape(a.shape[0], -1)
    ref = ref.double().reshape(ref.shape[0], -1)
    mag = ref.abs()
    scale = torch.stack([m[m > 0].median() if bool((m > 0).any()) else m.new_zeros(())
                         for m in mag])
    d = (a - ref).abs()
    rel = torch.where(d == 0, torch.zeros_like(d), d / (mag + scale[:, None]).clamp(min=1e-30))
    return rel.amax(1)


def _ba_compare(K, out, ref, ref64):
    """Hold K3's outputs to the plain version in float64, channel by
    channel: within max(1e-4, 8x the float32 plain version's own error).
    Returns (worst error / tolerance, max |kernel - plain f32|, where)."""
    worst, abs_err, where = 0.0, 0.0, None
    for name, a, b, r in zip(("edge", "rows", "zt"), out, ref, ref64):
        if a is None and b is None:
            continue
        k_rel = _channel_rel(a, r)
        tol = torch.clamp(8.0 * _channel_rel(b, r), min=1e-4)
        ratio = k_rel / tol
        ch = int(ratio.argmax())
        abs_err = max(abs_err, _max_abs(a, b))
        if float(ratio[ch]) >= worst:
            worst, where = float(ratio[ch]), {"output": name, "channel": ch,
                                              "rel_err": float(k_rel[ch]), "tol": float(tol[ch])}
        if not float(ratio[ch]) <= 1.0:
            raise AssertionError(f"ba_schur K={K} {name} channel {ch}: rel err "
                                 f"{float(k_rel[ch])} > tol {float(tol[ch])}")
    return worst, abs_err, where


def phase_kernels(dev):
    """Each kernel against its plain version at main-path shapes."""
    from sdslam_tpu_torch.kernels import (
        align_kernel as ak, ba_schur_kernel as bk, hamming_kernel as hk, pose_kernel as pk,
    )

    rows = {}
    g = torch.Generator(device="cpu").manual_seed(SEED + 3)

    def rand_desc(n):
        return torch.randint(-2**31, 2**31 - 1, (n, 8), generator=g, dtype=torch.int64).to(
            torch.int32).to(dev)

    # K4: exact
    cases = []
    for na, nb in ((1024, 1024), (16384, 1024)):
        da, db = rand_desc(na), rand_desc(nb)
        out = hk.hamming_matrix(da, db)
        ref = hk.hamming_matrix_plain(da, db)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"hamming {na}x{nb}: kernel != plain")
        bms, by = bound(nbytes(da, db, out), na * nb * 8 * HAMMING_OPS_PER_WORD)
        # the library yardstick: torch.cdist with p=0 counts differing
        # elements of the descriptors unpacked to {0,1} floats (the unpack
        # is not timed)
        shifts = torch.arange(32, device=dev, dtype=torch.int32)
        ba_ = ((da[:, :, None] >> shifts) & 1).reshape(na, 256).float()
        bb_ = ((db[:, :, None] >> shifts) & 1).reshape(nb, 256).float()
        if not torch.equal(torch.cdist(ba_, bb_, p=0).round().to(torch.int32), ref):
            raise AssertionError(f"hamming {na}x{nb}: cdist yardstick != plain")
        cases.append({"shape": [na, nb], "max_abs_err": 0.0,
                      "ms": median_ms(lambda: hk.hamming_matrix(da, db)),
                      **device_profile(lambda: hk.hamming_matrix(da, db), ("hamming_kernel",)),
                      "plain_ms": median_ms(lambda: hk.hamming_matrix_plain(da, db)),
                      "bound_ms": bms, "bound_by": by,
                      "library_ms": median_ms(lambda: torch.cdist(ba_, bb_, p=0))})
    emit("kernel", name="hamming", tol="exact", cases=cases)
    rows["hamming"] = cases

    # K4's fused form (mask, best and second best): exact, ties (d1 == d2)
    # and rows with every pair masked present in each case. The whole
    # call's device time beside that of the matrix form + torch sequence it
    # replaces on the windowed searches (the parent's masked_dist + best2)
    # and of the torch ops that build the window mask before it
    from sdslam_tpu_torch.ops import hamming as ham

    cases = []
    for na, nb in ((1024, 1024), (16384, 1024)):
        da, db, margs = _best2_inputs(dev, na, nb)
        mask = _window_mask(*margs)
        out = hk.hamming_masked_best2(da, db, mask)
        ref = hk.hamming_masked_best2_plain(da, db, mask)
        torch.cuda.synchronize()
        for what, a, b in zip(("d1", "j1", "d2"), out, ref):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"hamming_best2 {na}x{nb}: {what} kernel != plain")
        d1, _, d2 = ref
        ties = int(((d1 == d2) & (d1 < ham.BIG)).sum())
        masked_rows = int((d1 == ham.BIG).sum())
        if not (ties and masked_rows):
            raise AssertionError(f"hamming_best2 {na}x{nb}: {ties} ties, {masked_rows} masked rows")
        pairs = int(mask.sum())
        bms, by = bound(nbytes(da, db, mask, *out), pairs * 8 * HAMMING_OPS_PER_WORD)
        cases.append({"shape": [na, nb], "max_abs_err": 0.0, "unmasked_pairs": pairs,
                      "tie_rows": ties, "masked_rows": masked_rows,
                      "ms": median_ms(lambda: hk.hamming_masked_best2(da, db, mask)),
                      **device_profile(lambda: hk.hamming_masked_best2(da, db, mask),
                                       ("hamming_best2_kernel",)),
                      "seq_device_all_ms": device_profile(
                          lambda: ham.best2(ham.masked_dist(da, db, mask)),
                          ("hamming_kernel",))["device_all_ms"],
                      "mask_device_all_ms": device_profile(lambda: _window_mask(*margs),
                                                           ("",))["device_all_ms"],
                      "plain_ms": median_ms(lambda: hk.hamming_masked_best2_plain(da, db, mask)),
                      "bound_ms": bms, "bound_by": by, "library_ms": None})
    emit("kernel", name="hamming_best2", tol="exact", cases=cases)
    rows["hamming_best2"] = cases

    # K1: T within 1e-4 (its bottom row exactly [0, 0, 0, 1]), chi2 within
    # 1e-4 relative, n_px equal (the tracker gates alignment on both) and
    # the kernel's own GN iteration count equal to the plain loop's. Levels
    # 4, 3, 2 of the main path at N = 1024; level 2 at a ragged N = 1000
    # (the cluster's last CTA masked); level 1 (320x240), larger than the
    # shared-memory staging budget (the image read through the read-only
    # cache); level 2 at N = 4096 and 8192, past the points whose
    # invariants fit shared memory (the rest read from global memory);
    # level 2 at N = 1024, the main path's finest call, last
    cases = []
    for level, n_pts in ((4, 1024), (3, 1024), (1, 1024), (2, 1000), (2, 4096), (2, 8192),
                         (2, 1024)):
        args = _align_inputs(dev, level, n_pts)
        out = ak._launch(*args)
        T, chi2, n = ak._views(out)
        # the plain loop runs the kernel's GN iterations; with the final
        # chi2 evaluation the kernel evaluates the terms n_iter + 1 times.
        # Bytes: the image, X, the masks, Hinv, T_init and J and the patch
        # of the taps valid at the final iterate (a lower bound on the taps
        # any iterate reads), and the 20-word output
        Tp, chi2p, np_, n_iter = ak.align_level_steps(*args)
        img, X, _, _, okpx, Hinv, T_init = args[:7]
        N = X.shape[0]
        H, W = img.shape
        bms, by = bound(nbytes(img, X, okpx, Hinv, T_init, out) + int(np_) * TAP_BYTES,
                        (n_iter + 1) * (N * PROJ_FLOP + int(np_) * TAP_FLOP))
        torch.cuda.synchronize()
        err, chi2_rel = _max_abs(T, Tp), _rel(chi2, chi2p)
        k_iter = int(ak._iterations(out))
        row3 = T[3].tolist() == [0.0, 0.0, 0.0, 1.0]
        if not (err <= 1e-4 and chi2_rel <= 1e-4 and int(n) == int(np_) and k_iter == n_iter
                and row3):
            raise AssertionError(f"align level {level} N={N}: |T - T_plain| = {err}, chi2 rel "
                                 f"{chi2_rel}, n_px {int(n)} vs {int(np_)}, GN iterations "
                                 f"{k_iter} vs {n_iter}, bottom row {T[3].tolist()}")
        cases.append({"level": level, "N": N, "hw": [H, W], "max_abs_err": err,
                      "chi2": float(chi2), "chi2_plain": float(chi2p), "chi2_rel_err": chi2_rel,
                      "n_px": int(n), "n_px_plain": int(np_), "gn_iterations": k_iter,
                      "gn_iterations_plain": n_iter,
                      "image_staged": ak._image_staged(N, H, W),
                      "staged_points_per_cta": ak.staged_points(N),
                      "ms": median_ms(lambda: ak.align_level(*args)),
                      **device_profile(lambda: ak.align_level(*args), ("align_level_kernel",)),
                      "plain_ms": median_ms(lambda: ak.align_level_plain(*args), reps=20),
                      "bound_ms": bms, "bound_by": by, "library_ms": None})
    if {c["image_staged"] for c in cases} != {True, False}:
        raise AssertionError("align_level cases miss one of the two image paths")
    if not any(c["N"] > ak.CLUSTER * c["staged_points_per_cta"] for c in cases):
        raise AssertionError("align_level cases never read invariants from global memory")
    emit("kernel", name="align_level",
         tol="T 1e-4 abs (bottom row exact), chi2 1e-4 rel, n_px and GN iterations equal",
         cases=cases)
    rows["align_level"] = cases

    # K2: T within 1e-4, inlier masks equal, the kernel's own inlier count
    # equal to the plain count and to its mask, chi2 within 1e-4 relative.
    # Priors 1.2 rad and pi - 0.1 rad from the truth run the full-range
    # SE(3) log of csrc/sd_common.cuh past the TPU series' 0.5 rad; N = 4096
    # runs the edges past the ones each thread holds in registers; the main
    # path's case (N = 1024, a prior close to the truth) comes last. One
    # launch per call and no other device op (the profiler's count)
    cases = []
    for prior_rot, n_edges in ((1.2, 1024), (math.pi - 0.1, 1024), (0.005, 4096),
                               (0.005, 1024)):
        args = _pose_inputs(dev, prior_rot, n_edges)
        T, m, n, c = pk.pose_optimize(*args)
        Tp, mp, n_p, cp = pk.pose_optimize_plain(*args)
        torch.cuda.synchronize()
        err, chi2_rel = _max_abs(T, Tp), _rel(c, cp)
        counts = (int(n), int(n_p), int(m.sum()))
        N, rounds, iters = args[0].shape[0], args[9], args[10]
        bms, by = bound(nbytes(*args[:4], T, m, n, c),
                        N * (rounds * iters * POSE_EDGE_FLOP + (rounds + 1) * POSE_RESID_FLOP))
        types = [(t.dtype, tuple(t.shape)) for t in (T, m, n, c)]
        if not (err <= 1e-4 and torch.equal(m, mp) and len(set(counts)) == 1
                and chi2_rel <= 1e-4 and T[3].tolist() == [0.0, 0.0, 0.0, 1.0]
                and types == [(t.dtype, tuple(t.shape)) for t in (Tp, mp, n_p, cp)]):
            raise AssertionError(
                f"pose_gn prior {prior_rot} rad N={N}: |T - T_plain| = {err}, masks equal "
                f"{torch.equal(m, mp)}, n / n_plain / mask sum {counts}, chi2 rel {chi2_rel}, "
                f"bottom row {T[3].tolist()}, outputs {types}")
        dp = device_profile(lambda: pk.pose_optimize(*args), ("pose_gn_kernel",))
        if dp["kernels_per_call"] != 1.0 or dp["device_ops_per_call"] != 1.0:
            raise AssertionError(f"pose_gn N={N}: {dp} (one launch per call, nothing else)")
        cases.append({"n": N, "schedule": [rounds, iters], "prior_rad": prior_rot,
                      "max_abs_err": err, "chi2_rel_err": chi2_rel,
                      "n_inliers": int(n), "n_inliers_plain": int(n_p),
                      "ms": median_ms(lambda: pk.pose_optimize(*args)), **dp,
                      "plain_ms": median_ms(lambda: pk.pose_optimize_plain(*args)),
                      "bound_ms": bms, "bound_by": by, "library_ms": None})
    emit("kernel", name="pose_gn",
         tol="T 1e-4 abs, masks and counts equal, chi2 1e-4 rel", cases=cases)
    rows["pose_gn"] = cases

    # K3, both modes, channel by channel against the plain version
    # evaluated in float64: every entry within 1e-4 (see _channel_rel), or,
    # in a channel whose float32 conditioning is worse (the residual-derived
    # ones, u - u_obs cancels ~300 px to ~0.5 px), within 8x the float32
    # plain version's own error there
    # the third to sixth cases are phase 10's dist-BA (Zt emitted, 8
    # observations per point): the 64-camera map of 16384 points at world
    # 1 and one world-4 rank's 4096 of them, then the dry run's 8-slot map
    # of 256 points at world 1 and one world-4 rank's 64; the last case is
    # the global-BA shape phase 6 packs: 256 KF slots, max_obs 16
    # observation planes over the 16384-point pool
    cases = []
    for K, emit_zt, Mo, P in ((24, True, 10, 2048), (80, False, 10, 2048),
                              (64, True, 8, 16384), (64, True, 8, 4096), (8, True, 8, 256),
                              (8, True, 8, 64), (256, False, 16, 16384)):
        args = _ba_inputs(dev, K, Mo=Mo, P=P)
        out = bk.ba_edge_schur(*args, emit_zt=emit_zt)
        ref = bk.ba_edge_schur_plain(*args, emit_zt=emit_zt)
        ref64 = bk.ba_edge_schur_plain(args[0].double(), *args[1:], emit_zt=emit_zt)
        torch.cuda.synchronize()
        worst, abs_err, where = _ba_compare(K, out, ref, ref64)
        del ref64
        bms, by = bound(nbytes(args[0], *out), Mo * P * BA_EDGE_FLOP + P * BA_POINT_FLOP)
        cases.append({"K": K, "emit_zt": emit_zt, "shape": list(args[0].shape),
                      "max_abs_err": abs_err, "worst_err_over_tol": worst, "worst": where,
                      "ms": median_ms(lambda: bk.ba_edge_schur(*args, emit_zt=emit_zt)),
                      **device_profile(lambda: bk.ba_edge_schur(*args, emit_zt=emit_zt),
                                       ("ba_schur_kernel",)),
                      "plain_ms": median_ms(lambda: bk.ba_edge_schur_plain(*args, emit_zt=emit_zt)),
                      "bound_ms": bms, "bound_by": by, "library_ms": None})
    emit("kernel", name="ba_schur", tol="per channel vs float64: max(1e-4, 8x plain f32 err)",
         cases=cases)
    rows["ba_schur"] = cases

    # K5, its one-evaluation form (the level kernel at zero iterations, T =
    # I): n_px equal; chi2_sum within 1e-4 relative; b channel by channel
    # (the 6 components over the 256 lanes) within 1e-4 of |ref| plus the
    # channel's median |ref| (see _channel_rel): the kernel and the plain
    # einsum sum ~16k taps per lane in another order
    from sdslam_tpu_torch.kernels import accumulate_gn_kernel as gk

    cases = []
    for level in (4, 3):
        args = _gn_inputs(dev, level)
        b, chi2, n = gk.accumulate_gn(*args)
        bp, chi2p, n_p = gk.accumulate_gn_plain(*args)
        torch.cuda.synchronize()
        b_rel = float(_channel_rel(b.T, bp.T).max())
        chi2_rel = float(((chi2 - chi2p).abs() / chi2p.abs().clamp(min=1e-30)).max())
        if not (torch.equal(n, n_p) and chi2_rel <= 1e-4 and b_rel <= 1e-4):
            raise AssertionError(f"accumulate_gn level {level}: n equal {torch.equal(n, n_p)}, "
                                 f"chi2 rel {chi2_rel}, b rel {b_rel}")
        # bytes: the image, Xc and the masks of every point, J and the patch
        # of the valid taps only (the kernel skips the others' reads), the
        # outputs
        img, Xc, _, _, okpx = args[:5]
        B, N = Xc.shape[:2]
        bms, by = bound(nbytes(img, Xc, okpx, b, chi2, n) + int(n_p.sum()) * TAP_BYTES,
                        B * N * PROJ_FLOP + int(n_p.sum()) * TAP_FLOP)
        cases.append({"level": level, "hw": list(args[0].shape), "B": B, "N": N,
                      "max_abs_err": max(_max_abs(b, bp), _max_abs(chi2, chi2p)),
                      "b_rel_err": b_rel, "chi2_rel_err": chi2_rel,
                      "n_px_total": int(n.sum()),
                      "ms": median_ms(lambda: gk.accumulate_gn(*args)),
                      **device_profile(lambda: gk.accumulate_gn(*args), ("align_level_kernel",)),
                      "plain_ms": median_ms(lambda: gk.accumulate_gn_plain(*args)),
                      "bound_ms": bms, "bound_by": by, "library_ms": None})
    emit("kernel", name="accumulate_gn",
         tol="n_px equal, chi2_sum 1e-4 rel, b per channel 1e-4", cases=cases)
    rows["accumulate_gn"] = cases

    # K5's batched level (what relocalization and loop detection run): every
    # lane held to the plain loop: T within 1e-4, chi2 within 1e-4
    # relative, n_px and GN iterations equal. 256 lanes of 1024 points with
    # some all-invalid lanes (empty keyframe slots), 15 iterations, at
    # levels 3 and 4, one ragged case (N = 1000); then phase 10's
    # dist-align, 8 iterations at levels 4 and 3 over 256 points per slot,
    # every slot valid: 64 slots at world 1, one world-4 rank's 16; level 4
    # at N = 1024, the loop detector's call, last. One launch per level and
    # no other device op (the profiler's count); the lanes the card runs at
    # once (cudaOccupancyMaxActiveClusters)
    from sdslam_tpu_torch.solvers import image_align as ia

    cases = []
    reloc_invalid = (5, 77, 128, 255)
    for level, n_pts, B, iters, invalid in (
            (3, 1024, 256, 15, reloc_invalid), (3, 1000, 256, 15, reloc_invalid),
            (4, 256, 64, 8, ()), (3, 256, 64, 8, ()), (4, 256, 16, 8, ()), (3, 256, 16, 8, ()),
            (4, 1024, 256, 15, reloc_invalid)):
        img, X, patch, J, okpx, T0, intr = _batched_inputs(dev, level, B=B, n_pts=n_pts,
                                                           invalid_lanes=invalid)
        L = ia._damped_cholesky(J, okpx).contiguous()
        args = (img, X, patch, J, okpx, L, T0, *intr, iters)
        out = gk._launch_level(*args)
        T, chi2, n, k_iter = gk._level_views(out, T0.shape[0])
        Tp, chi2p, np_, p_iter = gk.align_level_batched_steps(*args)
        torch.cuda.synchronize()
        B, N = X.shape[:2]
        t_err = (T.double() - Tp.double()).abs().amax((1, 2))
        c_rel = (chi2.double() - chi2p.double()).abs() / chi2p.double().abs().clamp(min=1e-30)
        bad = ((t_err > 1e-4) | (c_rel > 1e-4) | (n != np_)
               | (T[:, 3] != torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)).any(1))
        # a lane's GN iterations must equal the plain loop's unless the
        # stop test where the two part is a float tie (the kernel's sums
        # and the plain einsum's round differently; see _lane_decision),
        # and no more than TIE_LANES_MAX of the lanes may part
        ties = [_lane_decision(args, b, int(k_iter[b]), int(p_iter[b]))
                for b in (k_iter != p_iter).nonzero()[:, 0].tolist()]
        bad[[t["lane"] for t in ties if not t["tie"]]] = True
        if len(ties) > TIE_LANES_MAX * B:
            raise AssertionError(f"align_batched level {level} N={N}: {len(ties)} of {B} lanes "
                                 f"part from the plain loop's GN iterations: {ties}")
        if bool(bad.any()) or not bool((np_[list(invalid)] == 1).all()):
            b0 = int(bad.nonzero()[0]) if bool(bad.any()) else int(invalid[0])
            raise AssertionError(
                f"align_batched level {level} N={N} lane {b0} ({int(bad.sum())} lanes off): "
                f"|T - T_plain| {float(t_err[b0])}, chi2 rel {float(c_rel[b0])}, n_px "
                f"{int(n[b0])} vs {int(np_[b0])}, GN iterations {int(k_iter[b0])} vs "
                f"{int(p_iter[b0])}; {ties}")
        # bytes: the image, X, the masks, L, T and J and the patch of the
        # taps valid at the final iterate, the outputs; operations: each
        # lane's evaluations (its GN iterations + the final one)
        bms, by = bound(nbytes(img, X, okpx, L, T0, out) + int(np_.sum()) * TAP_BYTES,
                        float(((p_iter + 1).double() * (N * PROJ_FLOP + np_.double() * TAP_FLOP))
                              .sum()))
        dp = device_profile(lambda: gk.align_level_batched(*args), ("align_level_kernel",))
        if dp["kernels_per_call"] != 1.0 or dp["device_ops_per_call"] != 1.0:
            raise AssertionError(f"align_batched level {level}: {dp} (one launch per level)")
        H, W = img.shape
        cases.append({"level": level, "hw": [H, W], "B": B, "N": N, "iters": iters,
                      "invalid_lanes": list(invalid),
                      "max_abs_err": float(t_err.max()), "chi2_rel_err": float(c_rel.max()),
                      "gn_iterations_min_mean_max": [int(p_iter.min()), float(p_iter.float().mean()),
                                                     int(p_iter.max())],
                      "lanes_gn_iterations_equal": B - len(ties), "iteration_ties": ties,
                      "image_staged": ak._image_staged(N, H, W),
                      "max_active_clusters": gk.max_active_clusters(N, H, W),
                      "ms": median_ms(lambda: gk.align_level_batched(*args)), **dp,
                      "plain_ms": median_ms(lambda: gk.align_level_batched_plain(*args), reps=5),
                      "bound_ms": bms, "bound_by": by, "library_ms": None})
    emit("kernel", name="align_batched",
         tol="per lane: T 1e-4 abs (bottom row exact), chi2 1e-4 rel, n_px and GN iterations equal",
         cases=cases)
    rows["align_batched"] = cases

    # K6: x within rtol 2e-4 / atol 2e-5 of the plain version (the library
    # factor and solve, which is also the library yardstick) and a relative
    # residual |Sx - b| / |b| <= 1e-4: random SPD systems at N = 30 and 228
    # (ragged last panels), the kernel's largest N, local BA's reduced
    # camera system at K = 24 (two fixed cameras under the 1e12 prior, the
    # others under the trace-scaled LM damping), the same at K = 8 (phase
    # 10's dist-BA on the dry run's 8-slot map), and a random [144, 144]
    # last (the kernel table's row)
    from sdslam_tpu_torch.kernels import chol_kernel as ck

    cases = []
    for N, system in ((30, "spd"), (228, "spd"), (ck.N_MAX, "spd"), (144, "ba"), (48, "ba"),
                      (144, "spd")):
        S, b = _ba_system(dev, N // 6) if system == "ba" else _spd_system(dev, N)
        x = ck.chol_solve_dense(S, b)
        xp = ck.chol_solve_dense_plain(S, b)
        torch.cuda.synchronize()
        err = _max_abs(x, xp)
        excess = float(((x - xp).abs() - (2e-5 + 2e-4 * xp.abs())).max())
        resid = float((S.double() @ x.double() - b.double()).norm() / b.double().norm())
        if not (excess <= 0.0 and resid <= 1e-4):
            raise AssertionError(f"chol_solve N={N} {system}: |x - x_plain| = {err} (over tol "
                                 f"by {excess}), residual {resid}")
        bms, by = bound(nbytes(S, b, x), chol_flop(N))
        plain_ms = median_ms(lambda: ck.chol_solve_dense_plain(S, b))
        cases.append({"N": N, "system": system, "max_abs_err": err, "residual": resid,
                      "ms": median_ms(lambda: ck.chol_solve_dense(S, b)),
                      **device_profile(lambda: ck.chol_solve_dense(S, b), ("chol_solve_kernel",)),
                      "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                      "library_ms": plain_ms})
    emit("kernel", name="chol_solve", tol="x rtol 2e-4 atol 2e-5, |Sx-b|/|b| <= 1e-4",
         plain="torch.linalg.cholesky_ex + torch.cholesky_solve (the library call)",
         cases=cases)
    rows["chol_solve"] = cases

    # K7 at the edge counts of scripts/diag_ba_launch.py, on edges of K3's
    # inputs (the 28th channel, the camera index, dropped), channel by
    # channel against the plain version evaluated in float64, relative to
    # the channel's largest entry: within max(1e-5, 4x the float32 plain
    # version's own error there). The residual channels cancel ~300 px to
    # ~1 px, so a float32 evaluation errs by a few 1e-5 of their largest
    # entry whichever way it rounds (ROADMAP.md section 3)
    from sdslam_tpu_torch.kernels import ba_edge_kernel as ek

    cases = []
    for K, Mo, P in ((256, 16, 8192), (24, 10, 2048)):
        args = _ba_inputs(dev, K, Mo=Mo, P=P)
        E = Mo * P
        packed = args[0][:27].reshape(27, E).contiguous()
        cam_args = args[2:8]
        out = ek.ba_edge_terms(packed, *cam_args)
        ref = ek.ba_edge_terms_plain(packed, *cam_args)
        ref64 = ek.ba_edge_terms_plain(packed.double(), *cam_args)
        torch.cuda.synchronize()
        scale = ref64.abs().amax(1).clamp(min=1e-30)
        k_err = (out.double() - ref64).abs().amax(1) / scale
        p_err = (ref.double() - ref64).abs().amax(1) / scale
        ratio = k_err / torch.clamp(4.0 * p_err, min=1e-5)
        ch = int(ratio.argmax())
        del ref64
        if not float(ratio[ch]) <= 1.0:
            raise AssertionError(f"ba_edge E={E} channel {ch}: error {float(k_err[ch])} of the "
                                 f"largest entry, plain float32 {float(p_err[ch])}")
        bms, by = bound(nbytes(packed, out), E * BA_EDGE_TERMS_FLOP)
        cases.append({"E": E, "max_abs_err": _max_abs(out, ref),
                      "worst_err_over_tol": float(ratio[ch]), "worst_channel": ch,
                      "rel_err": float(k_err[ch]), "plain_rel_err": float(p_err[ch]),
                      "max_rel_err": float(k_err.max()), "max_plain_rel_err": float(p_err.max()),
                      "ms": median_ms(lambda: ek.ba_edge_terms(packed, *cam_args)),
                      **device_profile(lambda: ek.ba_edge_terms(packed, *cam_args),
                                       ("ba_edge_kernel",)),
                      "plain_ms": median_ms(lambda: ek.ba_edge_terms_plain(packed, *cam_args)),
                      "bound_ms": bms, "bound_by": by, "library_ms": None})
    emit("kernel", name="ba_edge",
         tol="per channel vs float64, of its largest entry: max(1e-5, 4x plain f32 err)",
         cases=cases)
    rows["ba_edge"] = cases
    return rows


KERNEL_META = {
    "align_level": ("sdslam_tpu_torch/csrc/align_level.cu",
                    "sdslam_tpu/ops/pallas/align_kernel.py:340"),
    "pose_gn": ("sdslam_tpu_torch/csrc/pose_gn.cu",
                "sdslam_tpu/ops/pallas/pose_kernel.py:300"),
    "ba_schur": ("sdslam_tpu_torch/csrc/ba_schur.cu",
                 "sdslam_tpu/ops/pallas/ba_schur_kernel.py:258"),
    "hamming": ("sdslam_tpu_torch/csrc/hamming.cu",
                "sdslam_tpu/ops/pallas/hamming_kernel.py:56"),
    # K4's fused form: the same TPU kernel's distances with the masking and
    # best-two reduction its callers ran around it
    "hamming_best2": ("sdslam_tpu_torch/csrc/hamming.cu",
                      "sdslam_tpu/ops/pallas/hamming_kernel.py:56"),
    "accumulate_gn": ("sdslam_tpu_torch/csrc/accumulate_gn.cu",
                      "sdslam_tpu/ops/pallas/align_kernel.py:405"),
    # K5's batched level: the same TPU kernel's work on the path, the
    # loop around it included
    "align_batched": ("sdslam_tpu_torch/csrc/accumulate_gn.cu",
                      "sdslam_tpu/ops/pallas/align_kernel.py:405"),
    "chol_solve": ("sdslam_tpu_torch/csrc/chol_solve.cu",
                   "sdslam_tpu/ops/pallas/chol_kernel.py:105"),
    "ba_edge": ("sdslam_tpu_torch/csrc/ba_edge.cu",
                "sdslam_tpu/ops/pallas/ba_edge_kernel.py:162"),
}

# the kernels each path must launch (K5's one-evaluation form and ba_edge
# are on no path: relocalization and loop detection run K5's batched level,
# and neither package calls ba_edge while tracking; phase 3 is their entry
# point). The windowed searches of every path run K4's fused form; the
# mutual brute-force search of relocalization and loop closing its matrix
# form.
PATH_KERNELS = {
    "main": ("align_level", "pose_gn", "ba_schur", "hamming_best2", "chol_solve"),
    "reloc": ("align_batched", "pose_gn", "hamming", "hamming_best2"),
    "loop": ("align_batched", "hamming", "hamming_best2", "ba_schur", "chol_solve"),
    "mono": ("align_level", "pose_gn", "ba_schur", "hamming_best2", "align_batched",
             "chol_solve"),
    "fusion": ("align_level", "pose_gn", "ba_schur", "hamming_best2", "chol_solve"),
    "io": ("align_level", "pose_gn", "ba_schur", "hamming_best2", "hamming", "align_batched",
           "chol_solve"),
    # dist-BA runs K3 (and K6 at the small K = 8 pool), dist-align K5's
    # batched level; dist-PGO runs no kernel (the JAX package's neither)
    "dist": ("ba_schur", "align_batched", "chol_solve"),
    "pipelined": ("align_level", "pose_gn", "ba_schur", "hamming_best2", "chol_solve"),
    # the monocular path after a chessboard initialization, loop closing on
    "pattern": ("align_level", "pose_gn", "ba_schur", "hamming_best2", "align_batched",
                "chol_solve"),
    # the RGB-D facade closes loops: loop detection runs K5's batched level
    "viewer": ("align_level", "pose_gn", "ba_schur", "hamming_best2", "align_batched",
               "chol_solve"),
    # relocalization and the scan over the full pool (the batched level),
    # the brute-force verify (the matrix), local BA (K3, K6)
    "large": ("align_batched", "hamming", "pose_gn", "ba_schur", "chol_solve"),
}


def reset_launches():
    from sdslam_tpu_torch import kernels

    kernels.reset_counters()


def read_launches(path: str, launches=None):
    """Launch counts since reset_launches() (or `launches`, counted
    elsewhere); fails if a kernel of `path` never launched."""
    from sdslam_tpu_torch import kernels

    launches = kernels.read_counters() if launches is None else launches
    missing = [k for k in PATH_KERNELS[path] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{path} path never launched: {missing}")
    return launches


def main_config():
    from sdslam_tpu_torch.utils.config import MapConfig, ORBConfig, SystemConfig, TrackingConfig

    return SystemConfig(
        camera=main_camera(),
        orb=ORBConfig(max_keypoints=1024, n_levels=5),
        map=MapConfig(max_keyframes=256, max_points=16384, max_kps_per_frame=1024),
        tracking=TrackingConfig(depth_map_factor=1000.0),
    )


def sensor_frames(seq, idx):
    """Camera payloads as a sensor delivers them: u8 intensity and u16
    millimetre depth on the host."""
    out = []
    for k in idx:
        ts, img, dep = seq.frame(k)
        out.append((img.cpu().numpy().astype(np.uint8),
                    (dep.cpu().numpy() * 1000).astype(np.uint16), ts))
    return out


class SyncCounter:
    """Counts the calls that make the host wait for the card (CUDA sync
    debug mode warns once per call), including hidden host<->device copies."""

    def __enter__(self):
        self._cm = warnings.catch_warnings(record=True)
        self.caught = self._cm.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self._cm.__exit__(*exc)

    @property
    def n(self) -> int:
        return sum("synchroniz" in str(w.message).lower() for w in self.caught)


def phase_main(dev, n_frames: int = 60, n_single: int = 6):
    """Drive the port's RGB-D path at full size; returns {kernel: launches}."""
    from sdslam_tpu_torch.io import synthetic
    from sdslam_tpu_torch.pipeline.tracking import RGBDTracker
    from sdslam_tpu_torch.utils import metrics

    cfg = main_config()
    seq = synthetic.SyntheticSequence(cfg.camera, n_frames=n_frames, trajectory="orbit",
                                      radius=0.06, yaw_amp=0.04, device=dev)
    frames = sensor_frames(seq, range(n_frames))
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    tracker = RGBDTracker(cfg, device=dev)
    with SyncCounter() as syncs:
        t0 = time.perf_counter()
        for img, dep, ts in frames[:n_single]:
            tracker.track(img, dep, ts)
        tracker.track_batch(frames[n_single:])
        tracker.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches("main")
    est = np.stack([np.asarray(p) for p in tracker.trajectory])
    gt = seq.poses.numpy()
    ate = metrics.ate_rmse(est, gt, align=False)
    n_kf = int(tracker.ms.kf_valid.sum())
    n_pts = int(tracker.ms.pt_valid.sum())
    ft = tracker.frame_ms
    emit("main", frames=n_frames, status=tracker.st.status, ate_cm=ate * 100.0,
         keyframes=n_kf, points=n_pts, wall_fps=n_frames / wall,
         median_track_ms=statistics.median(ft["track"]) if ft["track"] else None,
         median_kf_ms=statistics.median(ft["kf"]) if ft["kf"] else None,
         host_syncs_per_frame=syncs.n / n_frames,
         tracker_reads_per_frame=tracker.host_syncs / n_frames,
         max_memory_allocated_mb=torch.cuda.max_memory_allocated() / 2**20,
         launches=launches)
    if tracker.st.status != "OK":
        raise AssertionError(f"tracker status {tracker.st.status}")
    if not np.all(np.isfinite(est)) or est.shape != gt.shape:
        raise AssertionError("trajectory not finite or of the wrong shape")
    if not ate < 0.02:
        raise AssertionError(f"ATE {ate * 100:.3f} cm >= 2 cm")
    if n_kf < 3:
        raise AssertionError(f"only {n_kf} keyframes")
    return launches


class SectionTimer:
    """Times module functions on the card while active: each listed
    (module, name) is wrapped so that every call records CUDA events around
    itself (no host sync); `ms()` reads them after the caller synchronized.
    The originals are restored on exit."""

    def __init__(self, *targets):
        self.targets = targets
        self.events = {name: [] for _, name in targets}

    def _wrap(self, fn, name):
        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            self.events[name].append((start, end))
            return out
        return timed

    def __enter__(self):
        self.orig = [(m, n, getattr(m, n)) for m, n in self.targets]
        for m, n, fn in self.orig:
            setattr(m, n, self._wrap(fn, n))
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.orig:
            setattr(m, n, fn)

    def ms(self):
        return {n: [a.elapsed_time(b) for a, b in ev] for n, ev in self.events.items()}


def _pose_err(T, T_gt):
    """(max |translation|, max |rotation|) of log(T T_gt^-1)."""
    from sdslam_tpu_torch.geometry import lie

    e = lie.se3_log(torch.as_tensor(np.asarray(T, np.float32)) @
                    lie.se3_inv(torch.as_tensor(np.asarray(T_gt, np.float32)).cpu()))
    return float(e[:3].abs().max()), float(e[3:].abs().max())


def phase_reloc(dev, n_track: int = 30, revisit: int = 10):
    """Kidnap and recovery at the main path's configuration (the cases of
    tests/test_relocalization.py at full width). Returns {kernel: launches}."""
    from sdslam_tpu_torch.io import synthetic
    from sdslam_tpu_torch.pipeline import relocalization as RL
    from sdslam_tpu_torch.pipeline.tracking import RGBDTracker

    cfg = main_config()
    cam = cfg.camera
    seq = synthetic.SyntheticSequence(cam, n_frames=60, trajectory="orbit", radius=0.06,
                                      yaw_amp=0.04, device=dev)
    frames = sensor_frames(seq, range(n_track))
    blank = (np.zeros((cam.height, cam.width), np.uint8),
             np.zeros((cam.height, cam.width), np.uint16))
    (img_r, dep_r, _), = sensor_frames(seq, [revisit])
    roll = np.deg2rad(35.0)
    Rz = np.eye(4, dtype=np.float32)
    Rz[:2, :2] = [[np.cos(roll), -np.sin(roll)], [np.sin(roll), np.cos(roll)]]
    T_roll = torch.as_tensor(Rz) @ seq.poses[revisit]
    img, dep = synthetic.render(seq.scene, cam, T_roll.to(dev))
    rolled = (img.cpu().numpy().astype(np.uint8), (dep.cpu().numpy() * 1000).astype(np.uint16))
    other = synthetic.SyntheticSequence(cam, n_frames=2, seed=9, device=dev)
    (img_o, dep_o, _), = sensor_frames(other, [0])

    tracker = RGBDTracker(cfg, device=dev)
    for im, d, ts in frames:
        tracker.track(im, d, ts)
    tracker.flush()
    if tracker.st.status != "OK":
        raise AssertionError(f"reloc: tracking status {tracker.st.status} before the kidnap")
    reset_launches()
    reloc_ms, checks = [], {}
    t = 100.0

    def feed(im, d, expect, what):
        nonlocal t
        t += 1.0
        lost_before = tracker.st.status == "LOST"
        a = time.perf_counter()
        T = tracker.track(im, d, t)
        tracker.flush()
        torch.cuda.synchronize()
        if lost_before:
            reloc_ms.append((time.perf_counter() - a) * 1e3)
        if tracker.st.status != expect:
            raise AssertionError(f"reloc, {what}: status {tracker.st.status}, expected {expect}")
        return T

    with SyncCounter() as syncs, SectionTimer((RL, "align_pool"), (RL, "_verify_photometric"),
                                              (RL, "_verify_epnp")) as sections:
        syncs0 = tracker.host_syncs
        feed(*blank, "LOST", "blank frame")
        T = feed(img_r, dep_r, "OK", f"frame {revisit}'s viewpoint")
        checks["photometric"] = _pose_err(T, seq.poses[revisit])
        feed(*blank, "LOST", "second blank frame")
        T = feed(*rolled, "OK", "35 deg roll")
        checks["epnp_roll35"] = _pose_err(T, T_roll)
        feed(*blank, "LOST", "third blank frame")
        feed(img_o, dep_o, "LOST", "unrelated scene (seed 9)")
        tracker_reads = tracker.host_syncs - syncs0
    launches = read_launches("reloc")
    emit("reloc", relocalizations=len(reloc_ms), ms_per_relocalization=reloc_ms,
         section_ms=sections.ms(),
         pose_err={k: {"trans_m": v[0], "rot_rad": v[1]} for k, v in checks.items()},
         host_syncs=syncs.n, tracker_reads=tracker_reads, launches=launches)
    for name, (lim_t, lim_r) in (("photometric", (0.01, 0.01)), ("epnp_roll35", (0.02, 0.02))):
        et, er = checks[name]
        if not (et < lim_t and er < lim_r):
            raise AssertionError(f"reloc {name}: pose error {et} m / {er} rad")
    return launches


def phase_loop(dev, n_lap: int = 240, n_revisit: int = 40, bias_amp: float = 0.08):
    """SDSlamSystem with loop closing on the organic circuit of
    tests/test_loop_organic.py at the main path's configuration. Returns
    {kernel: launches}."""
    from sdslam_tpu_torch.io import synthetic
    from sdslam_tpu_torch.pipeline import loop_closing as LC
    from sdslam_tpu_torch.solvers import ba as ba_mod
    from sdslam_tpu_torch.system import RGBD, SDSlamSystem
    from sdslam_tpu_torch.utils import metrics

    cfg = main_config()
    cam = cfg.camera
    lap = synthetic.circuit_trajectory(n_lap, radius=0.6)
    poses = torch.cat([lap, lap[:n_revisit]])
    seq = synthetic.SyntheticSequence(cam, trajectory="custom", poses=poses,
                                      scene_kwargs={"closed": True, "size": 3.5}, device=dev)
    n = len(seq)
    noise = np.random.default_rng(11)
    frames = []
    for i in range(n):
        _, img, depth = seq.frame(i)
        img8 = np.clip(img.cpu().numpy() + noise.normal(0, 2.0, (cam.height, cam.width)),
                       0, 255).astype(np.uint8)
        bias = 1.0 + bias_amp * np.sin(2 * np.pi * i / n_lap)
        dep = depth.cpu().numpy()
        dep16 = np.clip((dep * bias + noise.normal(0, 0.01, dep.shape)) * 1000.0,
                        0, 65535).astype(np.uint16)
        frames.append((img8, dep16, float(i) / 30.0))

    sysm = SDSlamSystem(cfg, sensor=RGBD, loop_closing=True, device=dev)
    # the map before the first call whose loop closer applied a correction
    # (the map state is never written in place, so holding it costs nothing)
    pre = None

    def step(call, *a):
        nonlocal pre
        ms0, k = sysm.tracker.ms, len(sysm.loop_infos)
        call(*a)
        if pre is None and any(i.get("corrected") for i in sysm.loop_infos[k:]):
            pre = ms0

    reset_launches()
    # sections are timed only: nothing below asserts on them
    with SectionTimer((LC, "detect_and_consistency"), (LC, "verify_loop_sim3"),
                      (LC.LoopCloser, "_apply_correction"), (LC, "correct_loop_poses"),
                      (LC, "fuse_loop_points"), (ba_mod, "global_ba")) as sections:
        t0 = time.perf_counter()
        for img8, dep16, ts in frames:
            step(sysm.track_rgbd, img8, dep16, ts)
        step(sysm.finish)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sec = sections.ms()
    launches = read_launches("loop")
    corrections = [i for i in sysm.loop_infos if i.get("corrected")]
    gt = seq.poses.numpy()

    def kf_ate(ms):
        kf_valid, kf_fid = ms.kf_valid.cpu().numpy(), ms.kf_frame_id.cpu().numpy()
        sel = np.flatnonzero(kf_valid & (kf_fid >= 0) & (kf_fid < n))
        return metrics.ate_rmse(ms.kf_Tcw.cpu().numpy()[sel], gt[kf_fid[sel]], align=True)

    ms = sysm.tracker.ms
    le = ms.loop_edges.cpu().numpy()
    status = sysm.get_tracking_state()
    ate_pre = kf_ate(pre) if pre is not None else None
    ate_post = kf_ate(ms)
    est = np.stack([np.asarray(p) for p in sysm.tracker.trajectory])
    det = sec.pop("detect_and_consistency")
    emit("loop", frames=n, status=status, corrections=len(corrections),
         gba_runs=sum(bool(i.get("global_ba")) for i in corrections),
         detections=sum("detected" in i for i in sysm.loop_infos),
         kf_ate_before_cm=None if ate_pre is None else ate_pre * 100,
         kf_ate_after_cm=ate_post * 100, keyframes=int(ms.kf_valid.sum()),
         loop_edges=le[(le >= 0).all(1)].tolist(),
         frame_ate_cm=metrics.ate_rmse(est, gt, align=True) * 100,
         ms_per_detection=statistics.median(det) if det else None,
         ms_per_correction=sec.pop("_apply_correction"),
         section_ms=sec, wall_fps=n / wall, launches=launches)
    if not corrections:
        raise AssertionError("loop: no correction fired")
    if not all(i.get("global_ba") for i in corrections):
        raise AssertionError("loop: correction applied but global BA did not run")
    if not ate_post < ate_pre:
        raise AssertionError(f"loop: keyframe ATE {ate_pre} -> {ate_post} did not drop")
    if not (le >= 0).any():
        raise AssertionError("loop: no loop edge recorded")
    if status != "OK":
        raise AssertionError(f"loop: final status {status}")
    if not np.all(np.isfinite(est)) or est.shape != gt.shape:
        raise AssertionError("loop: trajectory not finite or of the wrong shape")
    return launches


def mono_frames(seq, n):
    """A monocular camera's payloads: u8 intensity on the host."""
    return [(img.cpu().numpy().astype(np.uint8), ts)
            for ts, img, _ in (seq.frame(k) for k in range(n))]


def phase_mono(dev, n_frames: int = 32):
    """The monocular SDSlamSystem with loop closing at the default
    configuration on tests/test_mono.py's orbit motion (radius 0.12,
    yaw_amp 0.03). Returns {kernel: launches}."""
    from sdslam_tpu_torch.io import synthetic
    from sdslam_tpu_torch.system import MONOCULAR, SDSlamSystem
    from sdslam_tpu_torch.utils import metrics
    from sdslam_tpu_torch.utils.config import SystemConfig

    cfg = SystemConfig()
    seq = synthetic.SyntheticSequence(cfg.camera, n_frames=n_frames, trajectory="orbit",
                                      radius=0.12, yaw_amp=0.03, device=dev)
    frames = mono_frames(seq, n_frames)
    reset_launches()
    sysm = SDSlamSystem(cfg, sensor=MONOCULAR, loop_closing=True, device=dev)
    init_frame, init_ms = None, 0.0
    with SyncCounter() as syncs:
        t0 = time.perf_counter()
        for k, (img, ts) in enumerate(frames):
            a = time.perf_counter()
            sysm.track_monocular(img, ts)
            if init_frame is None:
                torch.cuda.synchronize()
                init_ms += (time.perf_counter() - a) * 1e3
                if sysm.tracker.st.status == "OK":
                    init_frame = k
        sysm.finish()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches("mono")
    tr = sysm.tracker
    est = np.stack([np.asarray(p) for p in tr.trajectory])
    gt = seq.poses.numpy()
    ate = metrics.ate_rmse(est, gt, align=True, with_scale=True)
    n_kf, n_pts = int(tr.ms.kf_valid.sum()), int(tr.ms.pt_valid.sum())
    ft = tr.frame_ms
    status = sysm.get_tracking_state()
    emit("mono", frames=n_frames, status=status, init_frame=init_frame,
         init_ms=init_ms, sim3_ate_cm=ate * 100.0, keyframes=n_kf, points=n_pts,
         wall_fps=n_frames / wall,
         median_track_ms=statistics.median(ft["track"]) if ft["track"] else None,
         median_kf_ms=statistics.median(ft["kf"]) if ft["kf"] else None,
         host_syncs_per_frame=syncs.n / n_frames,
         detections=sum("detected" in i for i in sysm.loop_infos), launches=launches)
    if init_frame is None or init_frame > 3:
        raise AssertionError(f"mono: initialized at frame {init_frame}, expected by frame 3")
    if status != "OK":
        raise AssertionError(f"mono: final status {status}")
    if not np.all(np.isfinite(est)) or est.shape != gt.shape:
        raise AssertionError("mono: trajectory not finite or of the wrong shape")
    if not (n_kf >= 3 and n_pts > 100):
        raise AssertionError(f"mono: {n_kf} keyframes, {n_pts} points")
    if not ate < 0.05:
        raise AssertionError(f"mono: Sim3-aligned ATE {ate * 100:.3f} cm >= 5 cm")
    return launches


def jerky_poses(n: int, amp: float = 0.05):
    """tests/test_fusion.py's direction-reversing motion: a smooth lead-in,
    then the velocity flips sign every 2 frames."""
    poses, x = [], 0.0
    for i in range(n):
        x += amp * 0.6 if i < 4 else (amp if (i // 2) % 2 == 0 else -amp)
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = -np.array([x, 0.002 * i, 0.015 * i], np.float32)
        poses.append(T)
    return np.stack(poses)


def synth_imu(poses, fps: float = 30.0):
    """Per-frame [gyro(3), accel(3)] from ground-truth poses: body rates from
    consecutive poses, accelerometer = gravity in the body frame."""
    from sdslam_tpu_torch.geometry import lie

    g_world = np.array([0.0, -9.81, 0.0])
    out = []
    for i in range(len(poses)):
        rel = poses[i] @ np.linalg.inv(poses[max(i - 1, 0)])
        w = lie.so3_log(torch.as_tensor(rel[:3, :3].astype(np.float32))).numpy() * fps
        out.append(np.concatenate([w, poses[i][:3, :3] @ -g_world]))
    return out


def phase_fusion(dev, n_frames: int = 16):
    """The monocular + IMU SDSlamSystem (loop closing off) on the jerky
    sequence of tests/test_fusion.py at the default configuration. Returns
    {kernel: launches}."""
    from sdslam_tpu_torch.io import synthetic
    from sdslam_tpu_torch.pipeline import sensors
    from sdslam_tpu_torch.system import MONOCULAR_IMU, SDSlamSystem
    from sdslam_tpu_torch.utils import metrics
    from sdslam_tpu_torch.utils.config import SystemConfig

    cfg = SystemConfig()
    poses = jerky_poses(n_frames)
    seq = synthetic.SyntheticSequence(cfg.camera, trajectory="custom", poses=poses, device=dev)
    frames = mono_frames(seq, n_frames)
    imu = synth_imu(poses)
    reset_launches()
    sysm = SDSlamSystem(cfg, sensor=MONOCULAR_IMU, loop_closing=False, device=dev)
    t0 = time.perf_counter()
    for (img, ts), m in zip(frames, imu):
        sysm.track_fusion(img, m, ts)
    sysm.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("fusion")
    tr = sysm.tracker
    est = np.stack([np.asarray(p) for p in tr.trajectory])
    ate = metrics.ate_rmse(est, poses, align=True, with_scale=True)
    filt = sensors._jvec7_to_pose(tr.dst.imu.X[:7]).cpu().numpy()
    dpos = float(np.linalg.norm(filt[:3, 3] - est[-1][:3, 3]))
    updated = bool(tr.dst.imu.updated)
    status = sysm.get_tracking_state()
    emit("fusion", frames=n_frames, status=status, sim3_ate_cm=ate * 100.0,
         filter_updated=updated, filter_to_last_pose_m=dpos,
         keyframes=int(tr.ms.kf_valid.sum()), wall_fps=n_frames / wall, launches=launches)
    if status != "OK":
        raise AssertionError(f"fusion: final status {status}")
    if not (updated and dpos < 0.02):
        raise AssertionError(f"fusion: filter updated {updated}, {dpos} m from the last pose")
    if not np.all(np.isfinite(est)) or est.shape != poses.shape:
        raise AssertionError("fusion: trajectory not finite or of the wrong shape")
    if not ate < 0.08:
        raise AssertionError(f"fusion: Sim3-aligned ATE {ate * 100:.3f} cm >= 8 cm")
    return launches


def config_yaml(cfg, path: str) -> str:
    """Write `cfg` as a reference-keys config file (the keys load_config
    reads) and check that it loads back to `cfg`."""
    from sdslam_tpu_torch.utils.config import load_config

    c, o, t, m = cfg.camera, cfg.orb, cfg.tracking, cfg.map
    keys = {"Camera.fx": c.fx, "Camera.fy": c.fy, "Camera.cx": c.cx, "Camera.cy": c.cy,
            "Camera.Width": c.width, "Camera.Height": c.height, "Camera.k1": c.k1,
            "Camera.k2": c.k2, "Camera.p1": c.p1, "Camera.p2": c.p2, "Camera.k3": c.k3,
            "Camera.bf": c.bf, "Camera.fps": c.fps, "ORBextractor.nFeatures": o.n_features,
            "ORBextractor.scaleFactor": o.scale_factor, "ORBextractor.nLevels": o.n_levels,
            "ORBextractor.thresholdFAST": o.fast_threshold, "ThDepth": t.th_depth,
            "DepthMapFactor": t.depth_map_factor, "Map.MaxKeyframes": m.max_keyframes,
            "Map.MaxPoints": m.max_points}
    with open(path, "w") as f:
        f.write("%YAML:1.0\n" + "".join(f"{k}: {v}\n" for k, v in keys.items()))
    if load_config(path) != cfg:
        raise AssertionError(f"io: {path} does not load back to the configuration")
    return path


def read_tum_poses(path: str) -> np.ndarray:
    """A TUM trajectory file (ts tx ty tz qx qy qz qw, camera-to-world) as
    world-to-camera [N,4,4]."""
    from sdslam_tpu_torch.geometry import lie

    rows = np.loadtxt(path, comments="#", ndmin=2)
    q = torch.as_tensor(rows[:, [7, 4, 5, 6]], dtype=torch.float64)  # [w,x,y,z]
    Twc = np.tile(np.eye(4), (len(rows), 1, 1))
    Twc[:, :3, :3] = lie.quat_to_mat(q / q.norm(dim=1, keepdim=True)).numpy()
    Twc[:, :3, 3] = rows[:, 1:4]
    return np.linalg.inv(Twc)


def phase_io(dev, n_frames: int = 40, n_stream: int = 10):
    """The recorded-data paths at the main configuration, through the
    entry points a user calls: the CLI on written TUM and EuRoC sequences,
    the npz and YAML maps loaded into fresh systems, the StreamRunner.
    Returns {kernel: launches}."""
    import contextlib
    import io
    import os
    import tempfile

    from sdslam_tpu_torch import cli
    from sdslam_tpu_torch.io import datasets, stream, synthetic
    from sdslam_tpu_torch.system import RGBD, SDSlamSystem
    from sdslam_tpu_torch.utils import metrics
    from sdslam_tpu_torch.utils.config import SystemConfig

    cfg = main_config()
    df = cfg.tracking.depth_map_factor
    seq = synthetic.SyntheticSequence(cfg.camera, n_frames=n_frames, trajectory="orbit",
                                      radius=0.06, yaw_amp=0.04, device=dev)
    gt = seq.poses.numpy()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # 1. a recording, written as a user's camera would leave it
        t0 = time.perf_counter()
        root = os.path.join(tmp, "tum")
        datasets.write_tum_sequence(root, (seq.frame(i) for i in range(n_frames)), gt,
                                    depth_factor=df)
        cfg_path = config_yaml(cfg, os.path.join(tmp, "camera.yaml"))
        ds = datasets.TUMRGBDDataset(root, depth_factor=df)
        out["write_s"] = time.perf_counter() - t0

        reset_launches()
        # 2. the CLI on it, in this process so the launch counters see it
        traj, npz = os.path.join(tmp, "trajectory.txt"), os.path.join(tmp, "map.npz")
        ymap = os.path.join(tmp, "map.yaml")
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            cli.main(["rgbd", cfg_path, root, "--traj-out", traj, "--save-map", npz,
                      "--save-trajectory-yaml", ymap])
        torch.cuda.synchronize()
        out["cli_s"] = time.perf_counter() - t0
        progress = [line for line in log.getvalue().splitlines() if line.startswith("frame ")]
        out["cli_progress"] = progress
        out["cli_wall_fps"] = float(progress[-1].split()[-2])
        est = read_tum_poses(traj)
        gt_file = read_tum_poses(os.path.join(root, "groundtruth.txt"))
        out["tum_lines"] = len(est)
        out["ate_cm"] = metrics.ate_rmse(est, gt_file, align=False) * 100.0
        out["gt_file_vs_render_m"] = float(np.abs(gt_file - gt).max())
        if len(est) != n_frames or not np.all(np.isfinite(est)):
            raise AssertionError(f"io: {len(est)} TUM lines, expected {n_frames} finite")
        if not out["ate_cm"] < 2.0:
            raise AssertionError(f"io: CLI rgbd ATE {out['ate_cm']:.3f} cm >= 2 cm")
        with np.load(npz) as saved:
            n_pts, n_kf = int(saved["pt_valid"].sum()), int(saved["kf_valid"].sum())
            kf_pose = {int(f): T for f, T, v in zip(saved["kf_frame_id"], saved["kf_Tcw"],
                                                    saved["kf_valid"]) if v}
        out["map"] = {"keyframes": n_kf, "points": n_pts}

        # 3. the npz map in a fresh system, relocalized against
        sysm = SDSlamSystem(cfg, sensor=RGBD, device=dev)
        t0 = time.perf_counter()
        sysm.load_map(npz)
        torch.cuda.synchronize()
        out["npz_load_ms"] = (time.perf_counter() - t0) * 1e3
        if int(sysm.tracker.ms.n_points()) != n_pts or sysm.get_tracking_state() != "LOST":
            raise AssertionError("io: the loaded npz map differs or the tracker is not LOST")
        sysm.activate_localization_mode()
        errs, reloc_ms = {}, None
        for i in (4, 5, 6):
            ts, img, dep = ds.raw_frame(i)
            t0 = time.perf_counter()
            sysm.track_rgbd(img, dep, 100.0 + i * 0.03)
            sysm.tracker.flush()
            torch.cuda.synchronize()
            if reloc_ms is None:
                reloc_ms = (time.perf_counter() - t0) * 1e3
            errs[i] = _pose_err(sysm.tracker.trajectory[-1], gt[i])
            if sysm.tracker.st.status != "OK":
                raise AssertionError(f"io: frame {i} on the npz map: {sysm.tracker.st.status}")
        out["npz_reloc_ms"] = reloc_ms
        out["npz_pose_err"] = {i: {"trans_m": e[0], "rot_rad": e[1]} for i, e in errs.items()}
        if any(not (e[0] < 0.01 and e[1] < 0.01) for e in errs.values()):
            raise AssertionError(f"io: pose errors on the npz map {errs}")
        if int(sysm.tracker.ms.n_keyframes()) != n_kf:
            raise AssertionError("io: localization mode changed the loaded map")

        # 4. the YAML map in a fresh system
        sysm = SDSlamSystem(cfg, sensor=RGBD, device=dev)
        t0 = time.perf_counter()
        ok = sysm.load_trajectory(ymap)
        torch.cuda.synchronize()
        out["yaml_load_ms"] = (time.perf_counter() - t0) * 1e3
        ms = sysm.tracker.ms
        kf_err = max(float(np.abs(T - kf_pose[int(f)]).max()) for f, T, v in zip(
            ms.kf_frame_id.cpu().numpy(), ms.kf_Tcw.cpu().numpy(), ms.kf_valid.cpu().numpy())
            if v)
        out["yaml"] = {"keyframes": int(ms.kf_valid.sum()), "points": int(ms.pt_valid.sum()),
                       "max_pose_diff": kf_err}
        if not (ok and out["yaml"]["keyframes"] == n_kf and kf_err < 1e-3
                and out["yaml"]["points"] > 50):
            raise AssertionError(f"io: YAML map restored {out['yaml']} of {n_kf} keyframes")
        ts, img, dep = ds.raw_frame(5)
        t0 = time.perf_counter()
        sysm.track_rgbd(img, dep, ts)
        sysm.tracker.flush()
        torch.cuda.synchronize()
        e = _pose_err(sysm.tracker.trajectory[-1], gt[5])
        out["yaml_reloc"] = {"status": sysm.tracker.st.status, "trans_m": e[0], "rot_rad": e[1],
                             "ms": (time.perf_counter() - t0) * 1e3}

        # 5. phase 8's sequence as a EuRoC recording through `fusion`
        fcfg = SystemConfig()
        poses = jerky_poses(16)
        fseq = synthetic.SyntheticSequence(fcfg.camera, trajectory="custom", poses=poses,
                                           device=dev)
        frames = mono_frames(fseq, len(poses))
        imu = synth_imu(poses)
        eroot = os.path.join(tmp, "euroc")
        datasets.write_euroc_sequence(eroot, [(ts, img) for img, ts in frames],
                                      [(ts, m) for (_, ts), m in zip(frames, imu)])
        ftraj = os.path.join(tmp, "fusion.txt")
        with contextlib.redirect_stdout(log):
            cli.main(["fusion", config_yaml(fcfg, os.path.join(tmp, "fusion.yaml")), eroot,
                      "--no-loop-closing", "--traj-out", ftraj])
        fest = read_tum_poses(ftraj)
        out["fusion_sim3_ate_cm"] = metrics.ate_rmse(fest, poses, align=True,
                                                     with_scale=True) * 100.0
        if len(fest) != len(poses) or not out["fusion_sim3_ate_cm"] < 8.0:
            raise AssertionError(f"io: fusion {len(fest)} poses, Sim3 ATE "
                                 f"{out['fusion_sim3_ate_cm']:.3f} cm")

        # 6. the stream runner, depth 2 ms behind each image
        sysm = SDSlamSystem(cfg, sensor=RGBD, device=dev)
        runner = stream.StreamRunner(sysm, sensor="rgbd", slop=0.02)
        for i in range(n_stream):
            ts, img, dep = ds.raw_frame(i)
            runner.push_image(stream.ImageMsg(ts, img))
            runner.push_depth(stream.ImageMsg(ts + 0.002, dep))
        sysm.finish()
        odo = runner.odometry
        out["stream"] = {"odometry": len(odo), "tracked": sum(o.tracked for o in odo),
                         "status": sysm.get_tracking_state()}
        if len(odo) != n_stream or not all(np.all(np.isfinite(o.Twc)) for o in odo):
            raise AssertionError(f"io: {len(odo)} odometry messages, expected {n_stream}")
    launches = read_launches("io")
    emit("io", frames=n_frames, launches=launches, **out)
    return launches


def _dist_small_ba(world: int):
    """The multi-chip dry run's small distributed-BA map (K = 8 slots, 4
    keyframes, 48 * world points, exact poses, points off by 1 cm), as
    numpy for the ranks; K6 solves its [48, 48] reduced system."""
    from sdslam_tpu_torch import interop
    from sdslam_tpu_torch.geometry import lie
    from sdslam_tpu_torch.mapping import map_state as M

    cam = main_camera()._replace(fx=160.0, fy=160.0, cx=79.5, cy=59.5, width=160, height=120,
                                 bf=16.0)
    rng = np.random.default_rng(0)
    K, P, N, n_kf, n_pt = 8, 64 * world, 64, 4, 48 * world
    X = rng.uniform([-1, -1, 1.5], [1, 1, 3.0], size=(n_pt, 3)).astype(np.float32)
    T_gt = [np.eye(4, dtype=np.float32)]
    for _ in range(1, n_kf):
        xi = np.concatenate([rng.normal(size=3) * 0.1, rng.normal(size=3) * 0.03])
        T_gt.append(lie.se3_exp(torch.from_numpy(xi.astype(np.float32))).numpy())
    kf_uv = np.zeros((K, N, 2), np.float32)
    kf_ur = np.full((K, N), -1.0, np.float32)
    kf_mp = np.full((K, N), -1, np.int32)
    kp_valid = np.zeros((K, N), bool)
    for k in range(n_kf):
        Xc = X @ T_gt[k][:3, :3].T + T_gt[k][:3, 3]
        z = Xc[:, 2]
        uv = np.stack([cam.fx * Xc[:, 0] / z + cam.cx, cam.fy * Xc[:, 1] / z + cam.cy], 1)
        idx = np.flatnonzero(z > 0.2)[:N]
        kf_uv[k, :len(idx)] = uv[idx]
        kf_ur[k, :len(idx)] = uv[idx, 0] - cam.bf / z[idx]
        kf_mp[k, :len(idx)] = idx
        kp_valid[k, :len(idx)] = True
    T_init = np.stack([np.eye(4, dtype=np.float32)] * K)
    T_init[:n_kf] = np.stack(T_gt)
    X_init = X + rng.normal(size=X.shape).astype(np.float32) * 0.01
    t = torch.from_numpy
    ms = M.init_map(K, P, N, ((8, 8),), device="cpu")._replace(
        kf_valid=t(np.arange(K) < n_kf), kf_Tcw=t(T_init), kf_uv_und=t(kf_uv),
        kf_uright=t(kf_ur), kf_mp=t(kf_mp), kf_kp_valid=t(kp_valid),
        pt_valid=t(np.arange(P) < n_pt),
        pt_pos=t(np.concatenate([X_init, np.zeros((P - n_pt, 3), np.float32)])))
    cam_active = (np.arange(K) < n_kf) & (np.arange(K) > 0)
    return cam, interop.map_state_to_numpy(ms), cam_active, np.arange(P) < n_pt


def _dist_ring(Kp: int = 96, drift: float = 0.25):
    """The dry run's loop-bearing ring of Kp keyframes (odometry chain,
    covisibility and one loop edge; [7K, 7K] = [672, 672]) as numpy:
    (S_est, valid, fixed, edges, T_gt, T_est)."""
    from sdslam_tpu_torch.geometry import lie
    from sdslam_tpu_torch.solvers import pose_graph as pg

    rng = np.random.default_rng(11)
    T_gt = []
    for k in range(Kp):
        th = 2 * np.pi * k / Kp
        xi = np.array([np.sin(th), 0.1 * np.sin(2 * th), 1 - np.cos(th), 0, th, 0], np.float32)
        T_gt.append(lie.se3_exp(torch.from_numpy(xi * 0.5)).numpy())
    T_gt = np.stack(T_gt)
    T_est = [T_gt[0]]
    for k in range(1, Kp):
        rel = T_gt[k] @ np.linalg.inv(T_gt[k - 1])
        d = rng.normal(size=6).astype(np.float32) * drift / Kp
        T_est.append(lie.se3_exp(torch.from_numpy(d)).numpy() @ rel @ T_est[-1])
    T_est = np.stack(T_est)
    covis = np.zeros((Kp, Kp), np.int32)
    for k in range(1, Kp):
        covis[k - 1, k] = covis[k, k - 1] = 150
    t = torch.from_numpy
    edges, _ = pg.make_edges_from_covisibility(
        t(T_est), torch.ones(Kp, dtype=torch.bool), t(covis),
        t(np.concatenate([[-1], np.arange(Kp - 1)]).astype(np.int32)),
        loop_i=torch.tensor([Kp - 1]), loop_j=torch.tensor([0]),
        loop_S=t((T_gt[Kp - 1] @ np.linalg.inv(T_gt[0]))[None]), covis_min=100, max_edges=512)
    fixed = np.zeros(Kp, bool)
    fixed[0] = True
    return (T_est, np.ones(Kp, bool), fixed, tuple(e.numpy() for e in edges), T_gt, T_est)


def _loop_gap(T_all, T_gt):
    """Largest |log| of the first-to-last relative pose against the truth."""
    from sdslam_tpu_torch.geometry import lie

    rel = T_all[-1] @ np.linalg.inv(T_all[0])
    rel_gt = T_gt[-1] @ np.linalg.inv(T_gt[0])
    return float(np.abs(lie.se3_log(torch.from_numpy(rel @ np.linalg.inv(rel_gt))).numpy()).max())


def _dist_align_pool(K: int = 64, N: int = 256):
    """The dry run's pool of K textured stored pyramids (levels 2..4 of
    640x480), every slot valid, as numpy for the ranks; the query is slot
    DIST_QUERY's own pyramid."""
    from sdslam_tpu_torch import interop
    from sdslam_tpu_torch.mapping import map_state as M

    shapes = ((120, 160), (60, 80), (30, 40))
    rng = np.random.default_rng(5)
    freqs = rng.uniform(0.01, 0.12, (K, 6, 2)).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, (K, 6)).astype(np.float32)

    def tex_level(shape, lvl):
        h, w = shape
        s = 2.0 ** (lvl + 2)
        v, u = np.meshgrid(np.arange(h) * s, np.arange(w) * s, indexing="ij")
        imgs = np.zeros((K, h, w), np.float32)
        for k in range(K):
            ph = (u[None] * freqs[k, :, 0, None, None] + v[None] * freqs[k, :, 1, None, None]
                  + phases[k, :, None, None])
            imgs[k] = 128.0 + 100.0 * np.sin(ph).mean(0)
        return imgs

    pyr = tuple(tex_level(sh, i) for i, sh in enumerate(shapes))
    uv = rng.uniform([24, 24], [616, 456], (K, N, 2)).astype(np.float32)
    t = torch.from_numpy
    ms = M.init_map(K, 512, N, shapes, device="cpu")._replace(
        kf_valid=torch.ones(K, dtype=torch.bool), kf_uv=t(uv), kf_uv_und=t(uv),
        kf_depth=torch.full((K, N), 2.0), kf_mp=torch.zeros((K, N), dtype=torch.int32),
        kf_kp_valid=torch.ones((K, N), dtype=torch.bool), kf_pyramid=tuple(t(p) for p in pyr))
    query = [np.zeros((2, 2), np.float32)] * 2 + [p[DIST_QUERY] for p in pyr]
    return interop.map_state_to_numpy(ms), query


DIST_QUERY = 37
DIST_WORLDS = ((1, "nccl"), (4, "gloo"))  # NCCL refuses two ranks on one card


def phase_dist(dev):
    """The distributed solvers at the dry run's production shapes in ranks
    spawned on the card: a world of one over NCCL, a world of four over
    gloo on CUDA tensors. Each group runs, per solve, one warm-up call and
    one measured call; returns the measured calls' launches, summed."""
    from sdslam_tpu_torch.geometry import lie
    from sdslam_tpu_torch.io.synthetic import make_dist_ba_problem
    from sdslam_tpu_torch.parallel import dist_align, dist_ba, dist_pose_graph
    from sdslam_tpu_torch.parallel import multihost as mh

    cam = main_camera()
    big = make_dist_ba_problem(np.random.default_rng(0), 64, 16384, 8, cam)
    ring = _dist_ring()
    pool, query = _dist_align_pool()
    align_kw = dict(scale_factor=2.0, n_levels=5, store_min_level=2, iters=8)
    small = _dist_small_ba(DIST_WORLDS[-1][0])
    names = ("ba_k64", "ba_k8", "pgo_k96", "align_k64")
    calls = [(dist_ba.rank_gn_steps, (cam, big, np.arange(64) > 0, 2)),
             (dist_ba.rank_bundle_adjust, small + (1,)),
             (dist_pose_graph.rank_pose_graph, ring[:4] + (8,)),
             (dist_align.rank_align_scan, (cam, pool, query, align_kw))]
    runs, out = {}, {"backends": {}}
    for world, backend in DIST_WORLDS:
        t0 = time.perf_counter()
        # every solve twice: a warm-up call, then the measured one
        ranks = mh.launch(mh.run_calls, world, args=(calls + calls,), backend=backend,
                          devices=str(dev), threads=2, timeout=400.0)
        ranks = [r[len(calls):] for r in ranks]
        out["backends"][world] = backend
        out[f"world{world}_seconds"] = time.perf_counter() - t0
        # a replicated result must be the same bits on every rank
        for r in ranks[1:]:
            for a, b in zip(ranks[0], r):
                for k, v in a.items():
                    if isinstance(v, np.ndarray) and not np.array_equal(v, b[k]):
                        raise AssertionError(f"dist world {world}: ranks differ in {k}")
        runs[world] = ranks
        print(f"dist: world {world} on {backend}, {str(dev)}", flush=True)
    (w1, _), (wn, _) = DIST_WORLDS
    one, many = runs[w1][0], runs[wn][0]
    for i, name in enumerate(names):
        out[f"{name}_ms"] = {w: max(r[i]["ms"] for r in runs[w]) for w in runs}
    out["dT"] = float(np.abs(one[0]["T"] - many[0]["T"]).max())
    out["dX"] = float(np.abs(one[0]["X"] - many[0]["X"]).max())
    out["dT_k8"] = float(np.abs(one[1]["kf_Tcw"] - many[1]["kf_Tcw"]).max())
    out["dX_k8"] = float(np.abs(one[1]["pt_pos"] - many[1]["pt_pos"]).max())
    out["ba_k64_pose_err_before"] = float(np.abs(big[0] - big[7]).max())
    out["ba_k64_pose_err_after"] = float(np.abs(many[0]["T"] - big[7]).max())
    out["dS"] = float(np.abs(one[2]["S"] - many[2]["S"]).max())
    T_opt = lie.sim3_to_se3(torch.from_numpy(many[2]["S"])).numpy()
    out["gap_before"], out["gap_after"] = _loop_gap(ring[5], ring[4]), _loop_gap(T_opt, ring[4])
    e1, en = one[3]["errors"], many[3]["errors"]
    both = np.isfinite(e1) & np.isfinite(en)
    out["dA"] = float(np.abs(np.where(both, e1 - en, 0.0)).max())
    out["align_finite_equal"] = bool((np.isfinite(e1) == np.isfinite(en)).all())
    out["align_winner"], out["align_winner_error"] = int(np.argmin(en)), float(en[DIST_QUERY])
    launches = {k: sum(c["launches"][k] for w in runs for r in runs[w] for c in r)
                for k in one[0]["launches"]}
    launches = read_launches("dist", launches)
    emit("dist", launches=launches, **out)
    if not (out["dT"] < 5e-4 and out["dX"] < 5e-3 and out["dT_k8"] < 5e-4
            and out["dX_k8"] < 5e-3):
        raise AssertionError(f"dist-BA shard-count variance: {out}")
    if not out["ba_k64_pose_err_after"] < out["ba_k64_pose_err_before"]:
        raise AssertionError("dist-BA did not move the poses toward the truth")
    if not (out["dS"] < 5e-4 and out["gap_after"] < 0.02
            and out["gap_after"] < 0.5 * out["gap_before"]):
        raise AssertionError(f"dist-PGO: dS {out['dS']:.2e}, loop gap "
                             f"{out['gap_before']:.3f} -> {out['gap_after']:.3f}")
    if not (out["dA"] < 1e-5 and out["align_finite_equal"] and out["align_winner"] == DIST_QUERY
            and out["align_winner_error"] < 1e-3):
        raise AssertionError(f"dist-align: dA {out['dA']:.2e}, winner {out['align_winner']} "
                             f"error {out['align_winner_error']:.4f}")
    return launches


def phase_pipelined(dev, n_frames: int = 60):
    """Phase 4's orbit through PipelinedRGBDTracker: tracking on the
    card's current stream, every keyframe's mapping pass on a second
    stream issued from the worker thread; returns {kernel: launches}."""
    from sdslam_tpu_torch.io import synthetic
    from sdslam_tpu_torch.parallel.pipelined import PipelinedRGBDTracker
    from sdslam_tpu_torch.utils import metrics

    cfg = main_config()
    seq = synthetic.SyntheticSequence(cfg.camera, n_frames=n_frames, trajectory="orbit",
                                      radius=0.06, yaw_amp=0.04, device=dev)
    frames = sensor_frames(seq, range(n_frames))
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    tracker = PipelinedRGBDTracker(cfg, device=dev)
    if tracker.map_stream is None or tracker.map_stream == torch.cuda.current_stream(dev):
        raise AssertionError("the mapping pass has no stream of its own")
    t0 = time.perf_counter()
    for img, dep, ts in frames:
        tracker.track(img, dep, ts)
    tracker.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("pipelined")
    est = np.stack([np.asarray(p) for p in tracker.trajectory])
    gt = seq.poses.numpy()
    ate = metrics.ate_rmse(est, gt, align=False)
    n_kf = int(tracker.ms.kf_valid.sum())
    on_device = all(t.device == tracker.track_device for v in tracker.ms
                    for t in (v if isinstance(v, tuple) else (v,)))
    ft = tracker.frame_ms["track"]
    main = EMITTED.get("main", {})
    emit("pipelined", frames=n_frames, status=tracker.st.status, ate_cm=ate * 100.0,
         keyframes=n_kf, points=int(tracker.ms.pt_valid.sum()), wall_fps=n_frames / wall,
         median_frame_ms=statistics.median(ft),
         main_wall_fps=main.get("wall_fps"), main_median_track_ms=main.get("median_track_ms"),
         main_median_kf_ms=main.get("median_kf_ms"), kf_dispatched=tracker.kf_dispatched,
         kf_skipped=tracker.kf_skipped, kf_events=tracker.kf_events,
         tracking_thread_syncs_per_frame=tracker.host_syncs / n_frames,
         map_thread_syncs=tracker.map_syncs, map_device=str(tracker.map_device),
         snapshot_on_tracking_device=on_device,
         max_memory_allocated_mb=torch.cuda.max_memory_allocated() / 2**20, launches=launches)
    if tracker.st.status != "OK":
        raise AssertionError(f"pipelined tracker status {tracker.st.status}")
    if not np.all(np.isfinite(est)) or est.shape != gt.shape:
        raise AssertionError("pipelined trajectory not finite or of the wrong shape")
    if not ate < 0.02:
        raise AssertionError(f"pipelined ATE {ate * 100:.3f} cm >= 2 cm")
    if n_kf < 2:
        raise AssertionError(f"pipelined: only {n_kf} keyframes")
    if not on_device:
        raise AssertionError("the tracking snapshot left the tracking device")
    return launches

def path_length(T) -> float:
    """Length of the camera-centre path of world->camera poses [N,4,4]."""
    from sdslam_tpu_torch.utils import metrics

    return float(np.linalg.norm(np.diff(metrics.camera_centers(T), axis=0), axis=1).sum())


def calibration_views(dev, cell: float = 0.0302):
    """Six u8 views of a board of `cell` m squares on the poster, turned and
    moved back as tests/test_pattern.py's calibration round trip does."""
    from sdslam_tpu_torch.io import synthetic

    return [synthetic.PosterSequence(main_camera(), np.eye(4, dtype=np.float32)[None],
                                     z=0.5 + 0.08 * i, tilt=(0.25 + 0.12 * i, -0.25 + 0.12 * i, 0.0),
                                     cell=cell, device=dev).frame(0)[1] for i in range(6)]


def phase_pattern(dev, n_frames: int = 30):
    """The monocular SDSlamSystem with chessboard initialization (UsePattern)
    and loop closing at the main configuration on the poster scene: the
    board at 0.5 m in frame 0 gives a metric map, which the next frames
    track. Then the CLI's `calibration` on six rendered board views.
    Returns {kernel: launches}."""
    import contextlib
    import dataclasses
    import io
    import os
    import re
    import tempfile

    from PIL import Image

    from sdslam_tpu_torch import cli
    from sdslam_tpu_torch.io import synthetic
    from sdslam_tpu_torch.system import MONOCULAR, SDSlamSystem
    from sdslam_tpu_torch.utils import metrics

    base = main_config()
    cfg = dataclasses.replace(base, tracking=dataclasses.replace(base.tracking, use_pattern=True))
    seq = synthetic.PosterSequence(cfg.camera, synthetic.poster_trajectory(n_frames), device=dev)
    frames = [seq.frame(i) for i in range(n_frames)]
    gt = seq.poses.numpy()
    out = {}

    # an attempt without a board (a frame of phase 4's room): no map yet
    room = synthetic.SyntheticSequence(cfg.camera, n_frames=2, device=dev).frame(0)[1]
    room = room.cpu().numpy().astype(np.uint8)
    probe = SDSlamSystem(cfg, sensor=MONOCULAR, device=dev)
    no_board = []
    for k in range(2):
        t0 = time.perf_counter()
        probe.track_monocular(room, k / 30.0)
        torch.cuda.synchronize()
        no_board.append((time.perf_counter() - t0) * 1e3)
    out["attempt_ms_no_board"] = no_board
    if probe.tracker.st.status != "NOT_INITIALIZED":
        raise AssertionError("pattern: a frame without a board initialized a map")

    reset_launches()
    sysm = SDSlamSystem(cfg, sensor=MONOCULAR, loop_closing=True, device=dev)
    tr = sysm.tracker
    t_all = time.perf_counter()
    with SyncCounter() as syncs:
        ts, img = frames[0]
        t0 = time.perf_counter()
        sysm.track_monocular(img, ts)
        torch.cuda.synchronize()
        out["init_ms"] = (time.perf_counter() - t0) * 1e3
    out["init_status"] = tr.st.status
    out["init_host_reads"] = tr.host_syncs
    out["init_host_syncs"] = syncs.n
    valid = tr.ms.pt_valid
    out["init_points"] = int(valid.sum())
    out["init_median_depth_m"] = float(tr.ms.pt_pos[valid][:, 2].median()) if out["init_points"] else None
    for ts, img in frames[1:]:
        sysm.track_monocular(img, ts)
    sysm.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    est = np.stack([np.asarray(p) for p in tr.trajectory])
    out["status"] = sysm.get_tracking_state()
    out["se3_ate_cm"] = metrics.ate_rmse(est, gt, align=True, with_scale=False) * 100.0
    out["sim3_scale"] = float(metrics.umeyama(metrics.camera_centers(est),
                                              metrics.camera_centers(gt), True)[0])
    out["path_length_m"] = {"tracked": path_length(est), "truth": path_length(gt)}
    out["path_length_ratio"] = out["path_length_m"]["tracked"] / out["path_length_m"]["truth"]
    ft = tr.frame_ms
    out.update(keyframes=int(tr.ms.kf_valid.sum()), points=int(tr.ms.pt_valid.sum()),
               wall_fps=n_frames / wall,
               median_track_ms=statistics.median(ft["track"]) if ft["track"] else None,
               median_kf_ms=statistics.median(ft["kf"]) if ft["kf"] else None,
               detections=sum("detected" in i for i in sysm.loop_infos))
    launches = read_launches("pattern")

    # the calibration CLI on six board views written as PNGs
    with tempfile.TemporaryDirectory() as tmp:
        for i, v in enumerate(calibration_views(dev)):
            Image.fromarray(v).save(os.path.join(tmp, f"view{i}.png"))
        yaml_path = os.path.join(tmp, "calibration.yaml")
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            cli.main(["calibration", tmp, "--out", yaml_path])
        out["calibration_ms"] = (time.perf_counter() - t0) * 1e3
        text = open(yaml_path).read()
    rms = float(re.search(r"reprojection RMS ([0-9.]+)", log.getvalue()).group(1))
    fx = float(re.search(r"Camera\.fx: ([0-9.]+)", text).group(1))
    out["calibration"] = {"rms_px": rms, "fx": fx, "fx_rel_err": abs(fx - cfg.camera.fx) / cfg.camera.fx}
    emit("pattern", frames=n_frames, launches=launches, **out)

    if out["init_status"] != "OK":
        raise AssertionError(f"pattern: status {out['init_status']} after frame 0")
    if out["init_points"] < 20:
        raise AssertionError(f"pattern: {out['init_points']} metric points from the board")
    if not abs(out["init_median_depth_m"] - 0.5) < 0.15:
        raise AssertionError(f"pattern: median point depth {out['init_median_depth_m']:.3f} m")
    if not np.all(np.isfinite(est)) or est.shape != gt.shape:
        raise AssertionError("pattern: trajectory not finite or of the wrong shape")
    if not out["se3_ate_cm"] < 2.0:
        raise AssertionError(f"pattern: SE(3) ATE {out['se3_ate_cm']:.3f} cm >= 2 cm")
    if not (rms < 1.0 and out["calibration"]["fx_rel_err"] < 0.12):
        raise AssertionError(f"pattern: calibration {out['calibration']}")
    return launches


class BlockingCallCounter:
    """Counts the calls that wait for the card (Tensor.item / cpu / tolist /
    numpy / bool / int / float on a CUDA tensor, and the synchronize calls)
    made on the calling thread while `active` is set."""

    NAMES = ("item", "cpu", "tolist", "numpy", "__bool__", "__int__", "__float__")

    def __init__(self):
        import threading

        self.count = 0
        self.local = threading.local()
        self._saved = []

    def _wrap(self, owner, name, on_cuda):
        orig = getattr(owner, name)
        counter = self

        def wrapped(*a, **k):
            if getattr(counter.local, "active", False) and on_cuda(a):
                counter.count += 1
            return orig(*a, **k)

        self._saved.append((owner, name, orig))
        setattr(owner, name, wrapped)

    def __enter__(self):
        for name in self.NAMES:
            self._wrap(torch.Tensor, name, lambda a: a[0].is_cuda)
        self._wrap(torch.cuda, "synchronize", lambda a: True)
        self._wrap(torch.cuda.Event, "synchronize", lambda a: True)
        self._wrap(torch.cuda.Stream, "synchronize", lambda a: True)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)

    def watch(self, fn):
        """fn, counted while it runs on this thread."""
        def run(*a, **k):
            self.local.active = True
            try:
                return fn(*a, **k)
            finally:
                self.local.active = False
        return run


class FakeRospy:
    """A rospy-compatible transport that records subscriptions and
    publications (no ROS install)."""

    class _Pub:
        def __init__(self):
            self.msgs = []

        def publish(self, m):
            self.msgs.append(m)

    def __init__(self):
        self.subs, self.pubs = {}, {}

    def Subscriber(self, topic, _type, cb, queue_size=10):
        self.subs[topic] = cb

    def Publisher(self, topic, _type, queue_size=10):
        self.pubs[topic] = FakeRospy._Pub()
        return self.pubs[topic]

    def spin(self):
        pass


def ros_image(stamp: float, arr: np.ndarray, encoding: str):
    """A sensor_msgs/Image-like message (little endian, packed rows)."""
    import types

    header = types.SimpleNamespace(stamp=types.SimpleNamespace(to_sec=lambda: stamp))
    data = np.ascontiguousarray(arr).tobytes()
    return types.SimpleNamespace(header=header, height=arr.shape[0], width=arr.shape[1],
                                 encoding=encoding, is_bigendian=False, data=data,
                                 step=len(data) // arr.shape[0])


VIEWER_SCRIPT = {  # frame after which the client acts -> its requests
    10: ["GET", "POST /plane/add"],
    20: ["GET", "POST /localization/on"],
    25: ["POST /localization/off"],
    30: ["GET"],
    35: ["POST /stop_save"],
}
VIEWER_GETS = ("/status.json", "/map.png", "/frame.png", "/ar.png")


def phase_viewer(dev, n_frames: int = 40, n_node: int = 10):
    """The RGB-D SDSlamSystem on phase 4's orbit with a LiveViewer: a client
    thread drives it over HTTP (renders, the AR plane, localization on and
    off, stop) while another polls it; then an RGBDNode over the same
    facade, the CLI with --viewer-port, and the V4L2 camera where the
    machine has one. Returns {kernel: launches}."""
    import contextlib
    import importlib.util
    import io
    import os
    import re
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    from sdslam_tpu_torch import cli
    from sdslam_tpu_torch.io import datasets, ros_nodes, synthetic
    from sdslam_tpu_torch.system import RGBD, SDSlamSystem
    from sdslam_tpu_torch.viewer_server import LiveViewer

    cfg = main_config()
    seq = synthetic.SyntheticSequence(cfg.camera, n_frames=n_frames, trajectory="orbit",
                                      radius=0.06, yaw_amp=0.04, device=dev)
    frames = sensor_frames(seq, range(n_frames))
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    out = {"renders": "matplotlib" if has_mpl else "matplotlib absent"}

    reset_launches()
    sysm = SDSlamSystem(cfg, sensor=RGBD, device=dev)
    viewer = LiveViewer(sysm)
    port = viewer.start(port=0)
    url = f"http://127.0.0.1:{port}"

    def request(method, path):
        t0 = time.perf_counter()
        req = urllib.request.Request(url + path, method=method)
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                code, body = r.status, r.read()
        except urllib.error.HTTPError as e:
            code, body = e.code, e.read()
        return code, body, (time.perf_counter() - t0) * 1e3

    reached = {k: threading.Event() for k in VIEWER_SCRIPT}
    done = {k: threading.Event() for k in VIEWER_SCRIPT}
    gets, posts, errors = [], [], []
    stop_polling = threading.Event()
    polls = []

    def client():
        try:
            for k, steps in VIEWER_SCRIPT.items():
                if not reached[k].wait(120):
                    break
                for step in steps:
                    if step == "GET":
                        for path in VIEWER_GETS:
                            code, body, ms = request("GET", path)
                            gets.append({"frame": k, "path": path, "code": code, "ms": ms,
                                         "png": body[:8] == b"\x89PNG\r\n\x1a\n",
                                         "body": body[:80].decode("latin-1")
                                         if path != "/status.json" and code != 200 else None})
                    else:
                        code, _, ms = request("POST", step.split()[1])
                        posts.append({"frame": k, "path": step.split()[1], "code": code})
                done[k].set()
        except Exception as e:  # reported and failed below
            errors.append(repr(e))
            for ev in done.values():
                ev.set()

    def poller():
        while not stop_polling.is_set():
            for path in ("/status.json", "/map.png"):
                polls.append(request("GET", path)[0])
            stop_polling.wait(0.05)

    threads = [threading.Thread(target=client, daemon=True),
               threading.Thread(target=poller, daemon=True)]
    for t in threads:
        t.start()
    track_s, localization, boundaries = 0.0, [], []  # (frame, actions, staged copies)
    with BlockingCallCounter() as blocking:
        apply = blocking.watch(viewer.apply_pending)

        def logged_apply():
            acts = apply()
            boundaries.append((k, acts, len(viewer._staged_planes)))
            return acts

        viewer.apply_pending = logged_apply
        for k, (img, dep, ts) in enumerate(frames):
            t0 = time.perf_counter()
            sysm.track_rgbd(img, dep, ts)
            track_s += time.perf_counter() - t0
            localization.append(sysm.localization_only)
            if sysm.stop_requested:
                break
            if k in reached:
                reached[k].set()
                done[k].wait(120)
        sysm.finish()
        torch.cuda.synchronize()
    stop_polling.set()
    for t in threads:
        t.join(30)
    n_tracked = k + 1
    viewer.stop()
    staged_at = next((f for f, acts, _ in boundaries if "plane_add" in acts), None)
    cleared_at = next((f for f, _, n in boundaries if staged_at is not None and f >= staged_at
                       and n == 0), None)
    out.update(
        tracked_frames=n_tracked, stop_frame=k, tracking_fps_polled=n_tracked / track_s,
        main_wall_fps=EMITTED.get("main", {}).get("wall_fps"), polls=len(polls),
        poll_codes=sorted(set(polls)), gets=gets, posts=posts,
        plane={"staged_at": staged_at, "cleared_at": cleared_at, "found": len(viewer.planes)},
        localization_frames=[i for i, on in enumerate(localization) if on],
        apply_pending_blocking_calls=blocking.count, client_errors=errors,
        status=sysm.get_tracking_state())
    for path in VIEWER_GETS:
        ms = [g["ms"] for g in gets if g["path"] == path and g["code"] == 200]
        out.setdefault("get_ms", {})[path] = statistics.median(ms) if ms else None

    # an RGBDNode over the same facade after a reset: depth 4 ms late
    sysm.reset()
    ros = FakeRospy()
    node = ros_nodes.RGBDNode(sysm, ros=ros).start()
    for img, dep, ts in frames[:n_node]:
        node.on_image(ros_image(ts, img, "mono8"))
        node.on_depth(ros_image(ts + 0.004, dep, "16UC1"))
    sysm.finish()
    pub = ros.pubs[ros_nodes.ODOM_TOPIC].msgs
    traj = [np.asarray(T, np.float64) for T in sysm.tracker.trajectory]
    node_err = max((float(np.abs(np.asarray(r["position"]) + T[:3, :3].T @ T[:3, 3]).max())
                    for r, T in zip(pub, traj)), default=None)
    out["ros_node"] = {"odometry": len(pub), "max_position_err": node_err,
                       "status": sysm.get_tracking_state()}

    # the CLI with the live viewer on 10 frames written as a TUM folder
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "tum")
        datasets.write_tum_sequence(root, (seq.frame(i) for i in range(n_node)),
                                    seq.poses[:n_node].numpy(),
                                    depth_factor=cfg.tracking.depth_map_factor)
        traj_path = os.path.join(tmp, "trajectory.txt")
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            cli.main(["rgbd", config_yaml(cfg, os.path.join(tmp, "camera.yaml")), root,
                      "--viewer-port", "0", "--max-frames", str(n_node), "--traj-out", traj_path])
        url_line = re.search(r"live viewer at http://127\.0\.0\.1:\d+", log.getvalue())
        out["cli"] = {"url_line": url_line.group(0) if url_line else None,
                      "tum_lines": len(open(traj_path).read().strip().splitlines())}

    if os.path.exists("/dev/video0"):
        from sdslam_tpu_torch.io.camera import V4L2Camera

        with V4L2Camera("/dev/video0", cfg.camera.width, cfg.camera.height) as cam:
            _, img = cam.read()
        out["v4l2"] = {"shape": list(img.shape), "dtype": str(img.dtype)}
    else:
        out["v4l2"] = "no /dev/video0"
    launches = read_launches("viewer")
    emit("viewer", frames=n_frames, launches=launches, **out)

    if errors:
        raise AssertionError(f"viewer: client failed: {errors}")
    for g in gets:
        if g["path"] == "/status.json" or has_mpl:
            if g["code"] != 200 or (g["path"] != "/status.json" and not g["png"]):
                raise AssertionError(f"viewer: GET {g['path']} at frame {g['frame']}: {g}")
        elif g["code"] != 500 or "matplotlib" not in (g["body"] or ""):
            raise AssertionError(f"viewer: without matplotlib GET {g['path']} gave {g}")
    if len(gets) != 3 * len(VIEWER_GETS) or any(p["code"] != 200 for p in posts):
        raise AssertionError(f"viewer: requests {len(gets)} GETs, posts {posts}")
    if staged_at is None or cleared_at is None or cleared_at - staged_at > 5:
        raise AssertionError(f"viewer: plane staging {out['plane']}")
    if out["localization_frames"] != list(range(21, 26)):
        raise AssertionError(f"viewer: localization on at frames {out['localization_frames']}")
    if k != 36:
        raise AssertionError(f"viewer: the loop stopped after frame {k}, not 36")
    if blocking.count != 0:
        raise AssertionError(f"viewer: apply_pending made {blocking.count} blocking calls")
    if not (len(pub) == n_node and node_err is not None and node_err < 1e-6):
        raise AssertionError(f"viewer: ROS node {out['ros_node']}")
    if out["cli"]["url_line"] is None or out["cli"]["tum_lines"] != n_node:
        raise AssertionError(f"viewer: CLI {out['cli']}")
    return launches


class Spy:
    """Records the arguments and results of a module function's calls
    while active (no host sync); the original is restored on exit."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.calls, self.results = [], []

    def __enter__(self):
        self.orig = fn = getattr(self.module, self.name)

        def spy(*a, **kw):
            out = fn(*a, **kw)
            self.calls.append((a, kw))
            self.results.append(out)
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def large_map_config(cam, max_keypoints: int, n_levels: int, n_kf: int, max_points: int):
    from sdslam_tpu_torch.utils.config import MapConfig, ORBConfig, SystemConfig

    return SystemConfig(camera=cam, orb=ORBConfig(max_keypoints=max_keypoints, n_levels=n_levels),
                        map=MapConfig(max_keyframes=n_kf, max_points=max_points,
                                      max_kps_per_frame=max_keypoints))


def build_large_map(cfg, device, radius: float = 0.25, yaw_amp: float = 0.2, sections=None):
    """The large-map recipe of tests/test_large_map.py, with one step
    more: one keyframe per frame of an orbit that fills every slot, at
    its ground-truth pose; points spawned from every second keyframe's
    close depth readings; the statistics finalized over the whole pool at
    the end. The added step gives points more than one observer: each
    keyframe's associations come from search_by_projection of the points
    the previous keyframe observes, projected with the frame's
    ground-truth pose, as the tracker's reference-keyframe search hands
    them to the keyframe pass (pipeline/tracking.py `_track_core` step 2).
    With `sections` (a dict) each step's wall ms per keyframe is appended
    under its name, the device synchronized around it. Returns (sequence,
    extractor, map)."""
    from sdslam_tpu_torch.features import matching
    from sdslam_tpu_torch.features.frame import ORBExtractor, make_frame
    from sdslam_tpu_torch.io import synthetic
    from sdslam_tpu_torch.mapping import map_state as M
    from sdslam_tpu_torch.ops import hamming as ham
    from sdslam_tpu_torch.pipeline.tracking import KF_STORE_MIN_LEVEL, spawn_points

    cam, K = cfg.camera, cfg.map.max_keyframes
    sf, nl = cfg.orb.scale_factor, cfg.orb.n_levels

    def timed(name, fn):
        if sections is None:
            return fn()
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        sections.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    seq = synthetic.SyntheticSequence(cam, n_frames=K, trajectory="orbit", radius=radius,
                                      yaw_amp=yaw_amp, device=device)
    extractor = ORBExtractor(cam, cfg.orb)
    shapes, (h, w) = [], (cam.height, cam.width)
    for lvl in range(nl):
        if lvl >= KF_STORE_MIN_LEVEL:
            shapes.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    ms = M.init_map(K, cfg.map.max_points, cfg.orb.max_keypoints, tuple(shapes), device=device)
    P, N = ms.P, ms.N
    close = torch.tensor(4.0, device=device)

    def associate(f, Tcw, ref):
        q = ms.kf_mp[ref]
        safe = torch.clamp(q, 0, P - 1).long()
        res = matching.search_by_projection(
            cam, Tcw, ms.pt_pos[safe], ms.pt_desc[safe], (q >= 0) & ms.pt_valid[safe],
            ms.kf_octave[ref], f.uv_und, f.desc, f.valid, f.octave, radius_px=8.0,
            th_desc=ham.TH_HIGH, scale_factor=sf)
        kq = res.kp_to_query
        return torch.where(kq >= 0, q[torch.clamp(kq, 0, N - 1).long()], torch.full_like(kq, -1))

    for i in range(K):
        fr = timed("frame", lambda: make_frame(extractor, *seq.frame(i)[1:]))
        f = fr.features
        Tcw = seq.poses[i].to(device)
        assoc = (timed("association", lambda: associate(f, Tcw, i - 1)) if i > 0
                 else torch.full((N,), -1, dtype=torch.int32, device=device))
        ms = timed("insert", lambda: M.insert_keyframe(
            ms, i, Tcw, f.uv, f.uv_und, f.octave, f.angle, f.desc, f.valid, fr.depth,
            fr.uright, assoc, tuple(fr.pyramid[KF_STORE_MIN_LEVEL:]), i * 4, float(i), i - 1))
        if i % 2 == 0:
            ms = timed("spawn", lambda: spawn_points(cam, ms, i, close, scale_factor=sf,
                                                     n_levels=nl, update_stats=False))
    ms = timed("finalize", lambda: M.finalize_point_statistics(ms, sf, nl))
    return seq, extractor, ms


def relocalize_branch(cam, ms, fr, generator, scale_factor: float, n_levels: int):
    """relocalize() on frame fr; returns (result, the branch that won:
    "photometric", "epnp" or None). The photometric branch wins when any of
    its verifications succeeds (relocalization.py `pick`)."""
    from sdslam_tpu_torch.pipeline import relocalization as RL
    from sdslam_tpu_torch.pipeline.tracking import KF_STORE_MIN_LEVEL

    f = fr.features
    with Spy(RL, "_verify_photometric") as photo:
        rr = RL.relocalize(cam, ms, f.uv_und, f.desc, f.octave, f.valid, fr.uright, fr.pyramid,
                           generator=generator, scale_factor=scale_factor, n_levels=n_levels,
                           store_min_level=KF_STORE_MIN_LEVEL)
    if not bool(rr.success):
        return rr, None
    won = any(bool(ok) and int(n) > 0 for ok, _, _, n in photo.results)
    return rr, "photometric" if won else "epnp"


def local_ba_window(cam, ms, slot: int, scale_factor: float, covis_min: int = 15):
    """local_ba() at `slot`; returns (new map, {local_kfs and local_points:
    the local set before the window's caps (24 cameras, 2048 points),
    cameras: those with an edge in the window, optimized, points, edges,
    whether the centre moved}) as the solver saw them."""
    from sdslam_tpu_torch.mapping import map_state as M
    from sdslam_tpu_torch.solvers import ba

    inc = M.incidence_matrix(ms)
    local = (M.covisibility(ms, inc=inc)[slot] >= covis_min) & ms.kf_valid
    local[slot] = True
    oldest = torch.argmin(torch.where(ms.kf_valid, ms.kf_frame_id, ms.kf_frame_id.max() + 1))
    local[oldest] = False
    local_pts = ((local.to(inc.dtype) @ inc) > 0) & ms.pt_valid
    with Spy(ba, "_ba_core") as core:
        out = ba.local_ba(cam, ms, slot, scale_factor=scale_factor, covis_min=covis_min)
    (a, _), = core.calls
    es, obs_ok, cam_act, pt_act = a[3], a[4], a[5], a[6]
    return out, {"local_kfs": int(local.sum()), "local_points": int(local_pts.sum()),
                 "cameras": int(torch.unique(es.cam_idx[obs_ok.T]).numel()),
                 "optimized": int(cam_act.sum()), "points": int(pt_act.sum()),
                 "edges": int(obs_ok.sum()),
                 "centre_moved": bool((out.kf_Tcw[slot] != ms.kf_Tcw[slot]).any())}


LARGE_QUERY = 77


def phase_large(dev, n_kf: int = 256, max_points: int = 65536):
    """The large-map regime at full width: build_large_map over a 256-frame
    orbit fills every keyframe slot (640x480, 1024 keypoints, 65536
    points); then the O(K) and O(P) passes over the full pool: incidence
    and covisibility, relocalization of frame 77, the world-1 alignment
    scan, local BA at slot 77 and at the newest keyframe, the slot the
    tracker's keyframe pass runs it on. Returns {kernel: launches}."""
    from sdslam_tpu_torch.features.frame import make_frame
    from sdslam_tpu_torch.mapping import map_state as M
    from sdslam_tpu_torch.parallel import dist_align
    from sdslam_tpu_torch.pipeline.tracking import KF_STORE_MIN_LEVEL

    main = main_config()
    cfg = large_map_config(main.camera, main.orb.max_keypoints, main.orb.n_levels, n_kf,
                           max_points)
    cam, sf, nl = cfg.camera, cfg.orb.scale_factor, cfg.orb.n_levels
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    sections = {}
    t0 = time.perf_counter()
    seq, extractor, ms = build_large_map(cfg, dev, sections=sections)
    build_s = time.perf_counter() - t0
    n_valid, n_pt = int(ms.kf_valid.sum()), int(ms.pt_valid.sum())
    n_obs = M.point_obs_count(ms)
    multi = int((n_obs >= 2).sum())
    covis_ms = median_ms(lambda: M.covisibility(ms, inc=M.incidence_matrix(ms)), reps=5,
                         warmup=1)

    q = LARGE_QUERY
    fr = make_frame(extractor, *seq.frame(q)[1:])
    _sync(dev)
    t0 = time.perf_counter()
    rr, branch = relocalize_branch(cam, ms, fr, torch.Generator(device=dev).manual_seed(SEED),
                                   sf, nl)
    reloc_ms = (time.perf_counter() - t0) * 1e3
    reloc_err = _pose_err(rr.Tcw.cpu().numpy(), seq.poses[q].numpy())

    _sync(dev)
    t0 = time.perf_counter()
    _, errors = dist_align.distributed_align_scan(cam, ms, fr.pyramid, scale_factor=sf,
                                                  n_levels=nl, store_min_level=KF_STORE_MIN_LEVEL)
    argmin = int(torch.argmin(errors))
    scan_ms = (time.perf_counter() - t0) * 1e3

    # local BA at the query, and at the newest keyframe; both keep the
    # reference's window: past 2048 local points the first 2048 by index,
    # of which few have edges into the window (ROADMAP.md section 3), so
    # the query's poses move by about 0.12 and are not gated
    newest = int(torch.argmax(torch.where(ms.kf_valid, ms.kf_frame_id, -1)))
    ba_runs = {}
    for name, slot in (("query", q), ("newest", newest)):
        _sync(dev)
        t0 = time.perf_counter()
        ms2, window = local_ba_window(cam, ms, slot, sf)
        _sync(dev)
        ba_runs[name] = {"slot": slot, "ms": (time.perf_counter() - t0) * 1e3, **window,
                         "max_pose_change": float((ms2.kf_Tcw - ms.kf_Tcw).abs().max())}
    launches = read_launches("large")
    med = {k: statistics.median(v) for k, v in sections.items() if k != "finalize"}
    emit("large", slots=n_kf, valid_slots=n_valid, points=n_pt, multi_observer_points=multi,
         build_s=build_s, median_kf_ms=med,
         finalize_point_statistics_ms=sections["finalize"][0],
         incidence_covisibility_ms=covis_ms,
         reloc={"ms": reloc_ms, "success": bool(rr.success), "branch": branch,
                "best_kf": int(rr.best_kf), "trans_m": reloc_err[0], "rot_rad": reloc_err[1]},
         scan={"ms": scan_ms, "argmin": argmin,
               "finite_slots": int(torch.isfinite(errors).sum())},
         local_ba=ba_runs,
         max_memory_allocated_mb=torch.cuda.max_memory_allocated() / 2**20, launches=launches)
    if n_valid != n_kf or not n_pt > 5000:
        raise AssertionError(f"large: {n_valid} valid slots of {n_kf}, {n_pt} points")
    if not (rr.success and reloc_err[0] < 0.02):
        raise AssertionError(f"large: relocalization of frame {q}: {bool(rr.success)}, "
                             f"{reloc_err[0]} m")
    if abs(argmin - q) > 2:
        raise AssertionError(f"large: the scan's argmin {argmin}, query {q}")
    wq, wn = ba_runs["query"], ba_runs["newest"]
    if not (wq["cameras"] >= 2 and wq["edges"] > 0 and wn["cameras"] >= 2
            and wn["optimized"] >= 1 and wn["edges"] > 0 and wn["centre_moved"]
            and wn["max_pose_change"] < 0.05):
        raise AssertionError(f"large: local BA {ba_runs}")
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    # the port itself: outside a checkout of the repository this fails here,
    # before anything is printed
    import sdslam_tpu_torch  # noqa: F401  (precision flags)
    from sdslam_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    cap = torch.cuda.get_device_capability(dev)
    if cap < (9, 0):
        raise SystemExit(f"chip_smoke: compute capability {cap} < (9, 0)")
    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0), capability=list(cap),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    logs = _build.build()
    emit("build", seconds=time.perf_counter() - t0)
    # registers, shared memory and spills of every compiled function
    emit("ptxas", **{k: ptxas_summary(v) for k, v in logs.items()})

    seconds = {}
    t0 = time.perf_counter()
    table = phase_kernels(dev)
    seconds["kernels"] = time.perf_counter() - t0
    by_path = {}
    for name, fn in (("main", phase_main), ("reloc", phase_reloc), ("loop", phase_loop),
                     ("mono", phase_mono), ("fusion", phase_fusion), ("io", phase_io),
                     ("dist", phase_dist), ("pipelined", phase_pipelined),
                     ("pattern", phase_pattern), ("viewer", phase_viewer),
                     ("large", phase_large)):
        t0 = time.perf_counter()
        by_path[name] = fn(dev)
        seconds[name] = time.perf_counter() - t0
    emit("seconds", **seconds)
    if seconds["pattern"] + seconds["viewer"] > 60.0:
        raise AssertionError(f"phases 12 and 13 took {seconds['pattern'] + seconds['viewer']:.1f} s "
                             "> 60 s")

    # per kernel: its last case's numbers (the shape of its main-path call),
    # and launches x (ms - bound_ms) and launches x (device_ms - bound_ms),
    # the order of the redesign queue
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        cases = table[name]
        last = cases[-1]
        launches = sum(p[name] for p in by_path.values())
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches,
            "excess_ms": launches * (last["ms"] - last["bound_ms"]),
            "device_excess_ms": launches * (last["device_ms"] - last["bound_ms"]),
            "launches_by_path": {path: p[name] for path, p in by_path.items()},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **{k: last[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
            "cases": [{k: c[k] for k in c if k in ("shape", "level", "B", "K", "N", "E", "n",
                                                   "prior_rad", "system", "ms", "device_ms",
                                                   "kernels_per_call", "device_all_ms",
                                                   "seq_device_all_ms", "mask_device_all_ms",
                                                   "worst_err_over_tol", "plain_ms", "bound_ms",
                                                   "bound_by", "library_ms")}
                      for c in cases],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
