"""On-card smoke test of the PyTorch/CUDA port (sdslam_tpu_torch).

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits nonzero):
  1. device   card name / power limit (nvidia-smi), torch name, capability
  2. build    nvcc for every kernel source, all in parallel
  3. kernels  each CUDA kernel against its plain PyTorch version on the
              card at main-path shapes, with median times (CUDA events)
  4. main     the RGB-D tracking + keyframe-mapping path at full size
              (640x480, 1024 keypoints, 256 KF slots, 16384 points) on a
              60-frame synthetic orbit rendered on the card; checks ATE,
              keyframes and that every kernel was launched
Then the kernel table as one JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.

It imports nothing from JAX or the JAX package and never runs on the CPU.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

SEED = 0
REPS = 25


def emit(phase: str, **kw):
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
        cases.append({"shape": [na, nb], "max_abs_err": 0.0,
                      "ms": median_ms(lambda: hk.hamming_matrix(da, db)),
                      "plain_ms": median_ms(lambda: hk.hamming_matrix_plain(da, db))})
    emit("kernel", name="hamming", tol="exact", cases=cases)
    rows["hamming"] = cases

    # K1: T within 1e-4 at levels 4, 3, 2; chi2 within 1e-4 relative and
    # n_px equal, since the tracker gates alignment on both
    cases = []
    for level in (4, 3, 2):
        args = _align_inputs(dev, level)
        T, chi2, n = ak.align_level(*args)
        Tp, chi2p, np_ = ak.align_level_plain(*args)
        torch.cuda.synchronize()
        err, chi2_rel = _max_abs(T, Tp), _rel(chi2, chi2p)
        if not (err <= 1e-4 and chi2_rel <= 1e-4 and int(n) == int(np_)):
            raise AssertionError(f"align level {level}: |T - T_plain| = {err}, chi2 rel "
                                 f"{chi2_rel}, n_px {int(n)} vs {int(np_)}")
        cases.append({"level": level, "hw": list(args[0].shape), "max_abs_err": err,
                      "chi2": float(chi2), "chi2_plain": float(chi2p), "chi2_rel_err": chi2_rel,
                      "n_px": int(n), "n_px_plain": int(np_),
                      "ms": median_ms(lambda: ak.align_level(*args)),
                      "plain_ms": median_ms(lambda: ak.align_level_plain(*args), reps=20)})
    emit("kernel", name="align_level", tol="T 1e-4 abs, chi2 1e-4 rel, n_px equal", cases=cases)
    rows["align_level"] = cases

    # K2: T within 1e-4, inlier masks equal, the kernel's own inlier count
    # equal to the plain count and to its mask, chi2 within 1e-4 relative.
    # Priors 1.2 rad and pi - 0.1 rad from the truth run the full-range
    # SE(3) log of csrc/sd_common.cuh past the TPU series' 0.5 rad; the
    # main path's case (a prior close to the truth) comes last.
    cases = []
    for prior_rot in (1.2, math.pi - 0.1, 0.005):
        args = _pose_inputs(dev, prior_rot)
        T, m, n, c = pk.pose_optimize(*args)
        Tp, mp, n_p, cp = pk.pose_optimize_plain(*args)
        torch.cuda.synchronize()
        err, chi2_rel = _max_abs(T, Tp), _rel(c, cp)
        counts = (int(n), int(n_p), int(m.sum()))
        if not (err <= 1e-4 and torch.equal(m, mp) and len(set(counts)) == 1
                and chi2_rel <= 1e-4):
            raise AssertionError(
                f"pose_gn prior {prior_rot} rad: |T - T_plain| = {err}, masks equal "
                f"{torch.equal(m, mp)}, n / n_plain / mask sum {counts}, chi2 rel {chi2_rel}")
        cases.append({"n": args[0].shape[0], "schedule": [2, 5], "prior_rad": prior_rot,
                      "max_abs_err": err, "chi2_rel_err": chi2_rel,
                      "n_inliers": int(n), "n_inliers_plain": int(n_p),
                      "ms": median_ms(lambda: pk.pose_optimize(*args)),
                      "plain_ms": median_ms(lambda: pk.pose_optimize_plain(*args))})
    emit("kernel", name="pose_gn",
         tol="T 1e-4 abs, masks and counts equal, chi2 1e-4 rel", cases=cases)
    rows["pose_gn"] = cases

    # K3, both modes, channel by channel against the plain version
    # evaluated in float64: every entry within 1e-4 (see _channel_rel), or,
    # in a channel whose float32 conditioning is worse (the residual-derived
    # ones, u - u_obs cancels ~300 px to ~0.5 px), within 8x the float32
    # plain version's own error there
    cases = []
    for K, emit_zt in ((24, True), (80, False)):
        args = _ba_inputs(dev, K)
        out = bk.ba_edge_schur(*args, emit_zt=emit_zt)
        ref = bk.ba_edge_schur_plain(*args, emit_zt=emit_zt)
        ref64 = bk.ba_edge_schur_plain(args[0].double(), *args[1:], emit_zt=emit_zt)
        torch.cuda.synchronize()
        worst, abs_err, where = _ba_compare(K, out, ref, ref64)
        cases.append({"K": K, "emit_zt": emit_zt, "shape": list(args[0].shape),
                      "max_abs_err": abs_err, "worst_err_over_tol": worst, "worst": where,
                      "ms": median_ms(lambda: bk.ba_edge_schur(*args, emit_zt=emit_zt)),
                      "plain_ms": median_ms(lambda: bk.ba_edge_schur_plain(*args, emit_zt=emit_zt))})
    emit("kernel", name="ba_schur", tol="per channel vs float64: max(1e-4, 8x plain f32 err)",
         cases=cases)
    rows["ba_schur"] = cases
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
}


def kernel_modules():
    from sdslam_tpu_torch.kernels import (
        align_kernel, ba_schur_kernel, hamming_kernel, pose_kernel,
    )
    return {"align_level": align_kernel, "pose_gn": pose_kernel,
            "ba_schur": ba_schur_kernel, "hamming": hamming_kernel}


def phase_main(dev, n_frames: int = 60, n_single: int = 6):
    """Drive the port's RGB-D path at full size; returns {kernel: launches}."""
    from sdslam_tpu_torch.io import synthetic
    from sdslam_tpu_torch.pipeline.tracking import RGBDTracker
    from sdslam_tpu_torch.utils import metrics
    from sdslam_tpu_torch.utils.config import MapConfig, ORBConfig, SystemConfig, TrackingConfig

    cam = main_camera()
    cfg = SystemConfig(
        camera=cam,
        orb=ORBConfig(max_keypoints=1024, n_levels=5),
        map=MapConfig(max_keyframes=256, max_points=16384, max_kps_per_frame=1024),
        tracking=TrackingConfig(depth_map_factor=1000.0),
    )
    seq = synthetic.SyntheticSequence(cam, n_frames=n_frames, trajectory="orbit",
                                      radius=0.06, yaw_amp=0.04, device=dev)
    # camera payloads as a sensor delivers them (bench.py): u8 intensity and
    # u16 millimetre depth on the host, packed and uploaded by the tracker
    frames = []
    for k in range(n_frames):
        ts, img, dep = seq.frame(k)
        frames.append((img.cpu().numpy().astype(np.uint8),
                       (dep.cpu().numpy() * 1000).astype(np.uint16), ts))
    mods = kernel_modules()
    for m in mods.values():
        m.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    tracker = RGBDTracker(cfg, device=dev)
    # every call that makes the host wait for the card warns once in sync
    # debug mode; the count covers the tracker's own reads and any hidden
    # host<->device copy
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            for img, dep, ts in frames[:n_single]:
                tracker.track(img, dep, ts)
            tracker.track_batch(frames[n_single:])
            tracker.flush()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    n_syncs = sum("synchroniz" in str(w.message).lower() for w in caught)
    launches = {k: m.LAUNCHES for k, m in mods.items()}
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
         host_syncs_per_frame=n_syncs / n_frames,
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
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
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
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={k: [ln for ln in v.splitlines() if "registers" in ln or "spill" in ln]
                for k, v in logs.items()})

    table = phase_kernels(dev)
    launches = phase_main(dev)

    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        cases = table[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": cases[-1]["ms"], "plain_ms": cases[-1]["plain_ms"],
            "cases": [{k: c[k] for k in c if k in ("shape", "level", "K", "prior_rad", "ms", "plain_ms")}
                      for c in cases],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
