"""One run of one cell: set-up, the measured window, the traced block (with
`--trace 1`), and the comparison that decides `correct`.

The system under test is `sdslam_tpu_torch.system.SDSlamSystem`, built
from the configuration's settings through the program's own loader
(`utils.config.load_config` on the reference's YAML keys), for the
configuration's `sensor`; what depends on the sensor is its row in
`perf_bench/sensors.py`. Frames are offered in a closed loop: the next
frame goes in when the facade returns.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time

import numpy as np
import torch

from perf_bench import check, orb_ref, sensors, stats, trace
from perf_bench import scene as sc
from perf_bench import traffic as tr

ORB_SAMPLE_SPAN = 100  # the ORB check samples tracked frames among the window's first 100


def program_config(conf: dict, control: bool):
    """The program's SystemConfig from the reference's YAML keys. The
    control tells the program the configuration's `control` settings,
    which break one guarantee the configuration states; the benchmark's
    frames and reference keep the published ones."""
    from sdslam_tpu_torch.utils.config import load_config

    keys = dict(conf["settings"])
    if control:
        keys.update(conf["control"]["settings"])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "settings.yaml")
        with open(path, "w") as f:
            f.write("%YAML:1.0\n" + "".join(f"{k}: {v!r}\n" for k, v in keys.items()))
        return load_config(path)


class Runner:
    """Hands frames to the facade, by the sensor's call, and logs each call."""

    def __init__(self, slam, spec: sensors.Sensor, lap: tr.Lap, sched: tr.Schedule,
                 imu: tr.ImuStream = None):
        self.slam, self.lap, self.sched, self.imu = slam, lap, sched, imu
        self.track, self.inputs = getattr(slam, spec.method), spec.inputs
        self.lap_idx = []  # per call, set-up included
        self.calls = []  # per call of the window and the traced block
        # (lap index, features, keypoint depths or None) of the tracked calls
        # among the window's first ORB_SAMPLE_SPAN; the ORB check samples them
        self.orb_frames = []

    def feed(self, log: bool):
        """Hand the facade the schedule's next frame; with `log`, record
        the call (its time, whether the tracker was tracking, and whether
        the call returned a pose: one made while not tracking, not yet
        initialized or lost, and that left the tracker so, returned none)."""
        k, ts = self.sched.next()
        args = self.inputs(self.lap, k, self.imu)
        tracker = self.slam.tracker
        before = tracker.st.status
        t0 = time.perf_counter()
        self.track(*args, ts)
        dt = time.perf_counter() - t0
        self.lap_idx.append(k)
        if log:
            n = len(self.calls)
            self.calls.append({"call": len(self.lap_idx) - 1, "lap_idx": k, "ms": dt * 1e3,
                               "posed": before == "OK" or tracker.st.status == "OK"})
            if n < ORB_SAMPLE_SPAN and before == "OK":
                f = tracker.st.last_frame  # its features and keypoint depths: no copy, no sync
                self.orb_frames.append((k, f.features,
                                        None if self.lap.depths is None else f.depth))


def _features(f, depth) -> dict:
    """The program's valid keypoints of a frame (its FrameFeatures and, for
    a camera with depth, per-keypoint depths), on the host, in the form
    orb_ref.mismatch compares."""
    v = f.valid.bool()
    out = {"uv": f.uv[v].cpu(), "uv_und": f.uv_und[v].cpu(), "octave": f.octave[v].cpu(),
           "bits": orb_ref.desc_bits(f.desc[v]).cpu()}
    if depth is not None:
        out["depth"] = depth[v].cpu()
    return out


def run_cell(manifest, name: str, seed: int, seconds: float, traced: bool, device="cuda",
             t_start=None, control: bool = False) -> dict:
    """One run: the end-to-end metrics (`e2e`), what the per-layer readers
    read (`ctx`), the numbers `correct` compares (`numbers`), the window's
    frame count, diagnostics and the memory peak. `control` runs the
    configuration's control instead of the program as configured."""
    from sdslam_tpu_torch import system

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cell = manifest.workload(name)
    conf = manifest.config(cell["config"])
    params = manifest.traffic(cell["traffic"])
    settings = conf["settings"]
    spec = sensors.sensor(conf["sensor"])
    if dev.type == "cuda":
        from sdslam_tpu_torch.kernels import _build

        _build.build()  # the first run of a checkout compiles; later runs find them built
    cfg = program_config(conf, control)
    cam = sc.Camera.from_yaml_keys(settings)
    depth_factor = float(settings.get("DepthMapFactor", 1.0)) if spec.depth else None
    lap = tr.make_lap(params, cam, depth_factor, seed, dev)
    imu = tr.ImuStream(lap.poses, params, seed) if spec.imu else None
    sched = tr.Schedule(params, len(lap.poses))
    if dev.type == "cuda":
        warm_libraries(dev)
        torch.cuda.reset_peak_memory_stats()
    slam = system.SDSlamSystem(cfg, sensor=spec.name,
                               loop_closing=bool(params["loop_closing"]), device=dev)
    run = Runner(slam, spec, lap, sched, imu)
    for _ in range(int(params.get("setup_laps", 0)) * len(lap.poses)
                   + int(params.get("setup_frames", 0))):
        run.feed(False)
    if params.get("localize"):
        slam.activate_localization_mode()
    for _ in range(int(params.get("warmup_frames", 0))):
        run.feed(False)
    tracker = slam.tracker
    tracker.flush()
    _sync(dev)
    fm0 = {k: len(v) for k, v in tracker.frame_ms.items()}
    syncs0 = tracker.host_syncs
    infos0 = len(slam.loop_infos)

    # --- the measured window ---
    host0, seg0 = host_time(), _segments(dev)
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_start
    deadline = t_w0 + seconds
    while time.perf_counter() < deadline:
        run.feed(True)
    tracker.flush()
    _sync(dev)
    window_s = time.perf_counter() - t_w0
    host1, seg1 = host_time(), _segments(dev)
    n_win = len(run.calls)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    win_calls = list(run.calls)
    fm = tracker.frame_ms
    ctx = {
        "frames": n_win,
        "window_s": window_s,
        "calls": win_calls,
        "host_syncs": tracker.host_syncs - syncs0,
        "frame_ms": {k: v[fm0[k]:] for k, v in fm.items()},
    }
    infos = slam.loop_infos[infos0:]
    diag = {"track_steps": len(ctx["frame_ms"]["track"]), "kf_steps": len(ctx["frame_ms"]["kf"]),
            "keyframes": int(tracker.ms.kf_valid.sum()), "points": int(tracker.ms.pt_valid.sum()),
            "loop_detections": sum("detected" in i for i in infos),
            "loop_corrections": sum(bool(i.get("corrected")) for i in infos),
            # the host's share of the window: on a CPU, and waiting for one
            "cpu_share": (host1[0] - host0[0]) / window_s,
            "runqueue_share": None if host1[1] is None else (host1[1] - host0[1]) / window_s,
            "cuda_mallocs": seg1 - seg0}
    e2e = {
        "fps": n_win / window_s,
        "frame_ms_p95": stats.percentile([c["ms"] for c in win_calls], 95),
        "setup_s": setup_s,
    }
    if traced:
        if dev.type != "cuda":
            raise RuntimeError("a traced run needs the card")
        ctx["trace"] = trace.traced_block(lambda: run.feed(True),
                                          int(params["traced_frames"]), tracker.flush)
        diag["cuda_mallocs_traced"] = _segments(dev) - seg1

    # --- outputs of the timed path, to the host; the program's state freed ---
    slam.finish()
    rng = np.random.default_rng([seed % 2**63, 2])
    pick = rng.choice(len(run.orb_frames), min(int(params["orb_sample_frames"]),
                                               len(run.orb_frames)), replace=False)
    run.orb_frames = [run.orb_frames[i] for i in sorted(pick)]
    out = collect(slam, run)
    del slam, run, tracker
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.compare(out, lap, cam, settings, dev, fit_sim3=spec.fit_sim3)
    return {"e2e": e2e, "ctx": ctx, "numbers": numbers, "frames": n_win, "diag": diag,
            "memory_peak_bytes": peak}


def host_time():
    """(CPU seconds of this process, seconds its main thread waited for a
    CPU while runnable, from /proc/self/schedstat; None where the kernel
    does not report it)."""
    try:
        with open("/proc/self/schedstat") as f:
            wait = int(f.read().split()[1]) * 1e-9
    except (OSError, IndexError, ValueError):
        wait = None
    return time.process_time(), wait


def warm_libraries(dev):
    """Load and initialize, in set-up, the CUDA math libraries the
    program's solvers call (cuBLAS, cuSOLVER: the SVD, eigh, Cholesky, LU
    and inverse of its geometry and solvers), single and batched, so that
    no library loads inside the window."""
    g = torch.Generator(device=dev).manual_seed(0)
    for shape in ((3, 3), (6, 6), (9, 9), (16, 3, 3), (64, 6, 6)):
        a = torch.randn(shape, generator=g, device=dev)
        spd = a @ a.transpose(-1, -2) + 6.0 * torch.eye(shape[-1], device=dev)
        b = torch.randn(shape[:-1] + (1,), generator=g, device=dev)
        torch.linalg.svd(a)
        torch.linalg.eigh(spd)
        torch.linalg.det(a)
        torch.linalg.inv_ex(spd)
        torch.linalg.solve_ex(spd, b)
        torch.cholesky_solve(b, torch.linalg.cholesky_ex(spd)[0])
        torch.linalg.pinv(a)
    _sync(dev)


def _segments(dev) -> int:
    """cudaMalloc calls of the caching allocator so far (0 on the CPU)."""
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(dev).get("segment.all.allocated", 0))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def collect(slam, run: Runner) -> dict:
    """What the timed path produced, on the host: the pose the facade
    returned for each logged call, the map's keyframes and points, and the
    sampled frames' ORB features."""
    tracker = slam.tracker
    poses = [np.asarray(tracker.trajectory[c["call"]].cpu()
                        if isinstance(tracker.trajectory[c["call"]], torch.Tensor)
                        else tracker.trajectory[c["call"]], np.float64) for c in run.calls]
    ms = tracker.ms
    kf_valid = ms.kf_valid.cpu().numpy()
    # a keyframe's timestamp names the call it came from; the tracker counts
    # it from the first timestamp it stored (the first frame's with depth; a
    # monocular tracker's first keyframe, the bootstrap's first view). The
    # tracker has no public accessor for that offset: read without a
    # default, so that a rename raises instead of naming the wrong calls
    t0 = float(tracker._t0) if kf_valid.any() else 0.0
    calls = np.rint((ms.kf_timestamp.cpu().numpy()[kf_valid].astype(np.float64) + t0)
                    * run.sched.fps)
    lap_idx = np.asarray(run.lap_idx)
    kf_lap = lap_idx[np.clip(calls.astype(np.int64), 0, len(lap_idx) - 1)]
    return {
        "calls": run.calls,
        "first_lap_idx": run.lap_idx[0],
        "poses": poses,
        "kf": {"Tcw": ms.kf_Tcw.cpu().numpy()[kf_valid].astype(np.float64), "lap_idx": kf_lap},
        "points": ms.pt_pos.cpu().numpy()[ms.pt_valid.cpu().numpy()].astype(np.float64),
        "orb_samples": [(k, _features(f, d)) for k, f, d in run.orb_frames],
    }


def no_jax_loaded(modules) -> list:
    """Top-level modules of JAX or the JAX package among `modules` (names
    compared whole: `sdslam_tpu_torch` is not `sdslam_tpu`)."""
    banned = {"jax", "jaxlib", "flax", "sdslam_tpu"}
    return sorted({m.split(".")[0] for m in modules} & banned)
