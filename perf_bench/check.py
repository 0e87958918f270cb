"""The comparison that decides `correct`: what the timed path produced,
against the truth the benchmark rendered and the plain ORB reference.

Numbers (each held to its cell's limit in `perf_bench/limits/<cell>.json`;
a cell compares those its limits file names):

- `orb_miss_pct`: over tracked frames among the window's first 100,
  sampled from the seed (`orb_sample_frames` of them), the share
  (%) of keypoints, the reference's and the program's together, with no
  partner on the other side (orb_ref.mismatch: same octave, raw and
  undistorted position within 0.05 px, descriptors within 16 of 256 bits,
  and the keypoint's metric depth within 1e-4 of its value);
- `ate_cm`: RMSE (cm) of the camera centres the facade returned for the
  window's frames against the truth, in the map's own frame, which is the
  first frame's camera (no fit: RGB-D depth fixes the scale);
- `kf_ate_cm`: the same over the map's keyframes after the run, each
  against the truth of the frame it was made from;
- `map_err_cm`: median distance (cm) of the map's points to the nearest
  true surface of the room, in the truth's frame.
"""

from __future__ import annotations

import math

import numpy as np

from perf_bench import orb_ref
from perf_bench import scene as sc
from perf_bench import stats

ORB_PX_TOL = 0.05
ORB_BIT_TOL = 16
LOST_M = 0.10  # a window frame this far off counts as failed


def _apply(T, X):
    return X @ T[:3, :3].T + T[:3, 3]


def compare(run: dict, lap, cam: sc.Camera, settings: dict, device) -> dict:
    """The numbers, from a run's outputs (see harness.collect)."""
    calls = run["calls"]
    T0 = lap.poses[run["first_lap_idx"]]  # the map's frame: the first frame's camera
    est_c = stats.camera_centers(np.asarray(run["poses"], np.float64))
    true_c = _apply(T0, stats.camera_centers(lap.poses[[c["lap_idx"] for c in calls]]))
    out = {}
    err = np.linalg.norm(est_c - true_c, axis=1)
    out["ate_cm"] = float(np.sqrt((err**2).mean())) * 100 if len(err) else math.inf
    out["failed"] = int((err > LOST_M).sum())

    kf = run["kf"]
    kf_c = stats.camera_centers(kf["Tcw"])
    kf_err = np.linalg.norm(kf_c - _apply(T0, stats.camera_centers(lap.poses[kf["lap_idx"]])),
                            axis=1)
    out["kf_ate_cm"] = float(np.sqrt((kf_err**2).mean())) * 100 if len(kf_err) else math.inf

    d = sc.surface_distance(lap.scene, _apply(np.linalg.inv(T0), run["points"]))
    out["map_err_cm"] = float(np.median(d)) * 100 if len(d) else math.inf

    miss = total = 0
    for k, prog in run["orb_samples"]:
        ref = orb_ref.extract(lap.images[k], cam, int(settings["ORBextractor.nFeatures"]),
                              int(settings["ORBextractor.nLevels"]),
                              float(settings["ORBextractor.scaleFactor"]),
                              float(settings["ORBextractor.thresholdFAST"]), device)
        ref["depth"] = orb_ref.keypoint_depth(lap.depths[k], ref["uv"],
                                              float(settings["DepthMapFactor"]))
        ref = {key: v.cpu() for key, v in ref.items()}
        m, n = orb_ref.mismatch(ref, prog, ORB_PX_TOL, ORB_BIT_TOL)
        miss, total = miss + m, total + n
    out["orb_miss_pct"] = 100.0 * miss / total if total else math.inf
    out["orb_frames"] = len(run["orb_samples"])
    return out


def judge(numbers: dict, limits: dict):
    """(correct, checks): every limited number at or below its limit."""
    checks = {k: {"value": numbers[k], "limit": float(v)} for k, v in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
