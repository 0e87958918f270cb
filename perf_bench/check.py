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
  window's frames against the truth, once the map's frame is carried into
  the truth's: for RGB-D, whose depth fixes the scale, by the first
  frame's camera pose, with no fit;
- `kf_ate_cm`: the same over the map's keyframes after the run, each
  against the truth of the frame it was made from;
- `map_err_cm`: median distance (cm) of the map's points to the nearest
  true surface of the room, in the truth's frame;
- `failed`: window frames more than `LOST_M` off.

A monocular map has a scale of its own, so for a sensor without depth
(`fit_sim3`) one similarity (Umeyama, with scale, float64) is fitted to the
camera centres of the window's calls that returned a pose, against the
truth, and that one similarity carries every output, the window's poses,
the keyframes and the map's points, into the truth's frame before any
number is taken: a keyframe or a point is not fitted again, so a scale
that drifts shows. A call that returned no pose counts in `failed` and is
left out of the fit and of `ate_cm`; with fewer than `MIN_FIT` frames to
fit, every pose and map number is inf. The fit's scale is reported as
`sim3_scale` (information, not a check).
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
MIN_FIT = 3  # window poses a similarity needs


def umeyama(X: np.ndarray, Y: np.ndarray):
    """(s, R, t) of the similarity that takes points X [N,3] closest to Y
    [N,3] in least squares, Y ~ s R X + t (Umeyama, 1991), float64; None
    where X does not span a direction."""
    X, Y = np.asarray(X, np.float64), np.asarray(Y, np.float64)
    mx, my = X.mean(0), Y.mean(0)
    Xc, Yc = X - mx, Y - my
    var = (Xc**2).sum() / len(X)
    if not var > 1e-18:
        return None
    U, D, Vt = np.linalg.svd(Yc.T @ Xc / len(X))
    S = np.diag([1.0, 1.0, -1.0 if np.linalg.det(U) * np.linalg.det(Vt) < 0 else 1.0])
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S)) / var
    return s, R, my - s * R @ mx


def _rms_cm(err) -> float:
    return float(np.sqrt((err**2).mean())) * 100 if len(err) else math.inf


def compare(run: dict, lap, cam: sc.Camera, settings: dict, device,
            fit_sim3: bool = False) -> dict:
    """The numbers, from a run's outputs (see harness.collect)."""
    out = _poses(run, lap, fit_sim3)
    miss = total = 0
    for k, prog in run["orb_samples"]:
        ref = orb_ref.extract(lap.images[k], cam, int(settings["ORBextractor.nFeatures"]),
                              int(settings["ORBextractor.nLevels"]),
                              float(settings["ORBextractor.scaleFactor"]),
                              float(settings["ORBextractor.thresholdFAST"]), device)
        if lap.depths is not None:
            ref["depth"] = orb_ref.keypoint_depth(lap.depths[k], ref["uv"],
                                                  float(settings["DepthMapFactor"]))
        ref = {key: v.cpu() for key, v in ref.items()}
        m, n = orb_ref.mismatch(ref, prog, ORB_PX_TOL, ORB_BIT_TOL)
        miss, total = miss + m, total + n
    out["orb_miss_pct"] = 100.0 * miss / total if total else math.inf
    out["orb_frames"] = len(run["orb_samples"])
    return out


def _to_truth(run: dict, lap, est_c, true_c, fit_sim3: bool):
    """(s, R, t) that carries the map's frame into the truth's, and the
    mask of the window's calls it is judged on; None where no fit can be
    made. With depth the map's frame is the first frame's camera, so the
    transform is inv(T0) with scale 1 and every call is judged; without,
    it is the similarity fitted to the calls that returned a pose."""
    calls = run["calls"]
    if not fit_sim3:
        Twc0 = np.linalg.inv(lap.poses[run["first_lap_idx"]])
        return (1.0, Twc0[:3, :3], Twc0[:3, 3]), np.ones(len(calls), bool)
    posed = np.array([c["posed"] for c in calls], bool)
    fit = umeyama(est_c[posed], true_c[posed]) if posed.sum() >= MIN_FIT else None
    return fit, posed


def _poses(run: dict, lap, fit_sim3: bool) -> dict:
    """Pose and map numbers, with every output carried into the truth's
    frame by one transform (see `_to_truth`)."""
    calls = run["calls"]
    true_c = stats.camera_centers(lap.poses[[c["lap_idx"] for c in calls]])
    est_c = stats.camera_centers(np.asarray(run["poses"], np.float64)) if calls else true_c
    fit, used = _to_truth(run, lap, est_c, true_c, fit_sim3)
    if fit is None:
        return {"ate_cm": math.inf, "failed": len(calls), "kf_ate_cm": math.inf,
                "map_err_cm": math.inf, "sim3_scale": math.nan}
    s, R, t = fit

    def to_truth(X):
        return s * X @ R.T + t

    err = np.linalg.norm(to_truth(est_c[used]) - true_c[used], axis=1)
    kf = run["kf"]
    kf_err = np.linalg.norm(to_truth(stats.camera_centers(kf["Tcw"]))
                            - stats.camera_centers(lap.poses[kf["lap_idx"]]), axis=1)
    d = sc.surface_distance(lap.scene, to_truth(run["points"]))
    out = {"ate_cm": _rms_cm(err), "failed": int((~used).sum() + (err > LOST_M).sum()),
           "kf_ate_cm": _rms_cm(kf_err),
           "map_err_cm": float(np.median(d)) * 100 if len(d) else math.inf}
    if fit_sim3:
        out["sim3_scale"] = s
    return out


def judge(numbers: dict, limits: dict):
    """(correct, checks): every limited number at or below its limit."""
    checks = {k: {"value": numbers[k], "limit": float(v)} for k, v in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
