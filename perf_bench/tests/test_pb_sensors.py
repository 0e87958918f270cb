"""The sensor table: an RGB-D lap rendered as before, bit for bit; the
similarity fit of the monocular comparison; the IMU synthesizer; and whole
monocular and monocular + IMU runs of the harness on the CPU, sound and
with faults planted in the timed path.

    python3 -m pytest perf_bench/tests/test_pb_sensors.py -p no:cacheprovider
"""

import hashlib
import json
import math
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from perf_bench import check, harness, sensors, stats
from perf_bench import scene as sc
from perf_bench import traffic as tr
from perf_bench.manifest import Manifest
from perf_bench.tests.test_pb_correct import _half

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
CAM = sc.Camera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120,
                k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314)
PARAMS = {"lap": {"kind": "orbit", "lap_frames": 12, "radius_m": 0.24, "yaw_amp_rad": 0.16,
                  "fps": 30.0},
          "scene_seed": 0, "image_noise_sigma": 2.0}
SEED = 3_000_000_017
# SHA-256 of make_lap(PARAMS, CAM, 5000.0, SEED)'s images then depths, as the
# generator rendered them before it knew of other sensors
RGBD_LAP_SHA256 = "c0cee0c1ec2c3a154e253ebdf9ff116b1b2b835cbe47c91f42fb1c1e5a0af011"


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# --- (a) the RGB-D lap is unchanged ------------------------------------------


def test_rgbd_lap_is_pinned(one_thread):
    lap = tr.make_lap(PARAMS, CAM, 5000.0, SEED, CPU)
    assert _digest(lap.images + lap.depths) == RGBD_LAP_SHA256


def test_monocular_lap_has_the_same_images_and_no_depth(one_thread):
    lap = tr.make_lap(PARAMS, CAM, None, SEED, CPU)
    ref = tr.make_lap(PARAMS, CAM, 5000.0, SEED, CPU)
    assert lap.depths is None
    assert all(np.array_equal(a, b) for a, b in zip(lap.images, ref.images))


def test_the_table_names_the_facades_sensors():
    from sdslam_tpu_torch import system

    assert set(sensors.SENSORS) == {system.RGBD, system.MONOCULAR, system.MONOCULAR_IMU}
    for s in sensors.SENSORS.values():
        assert callable(getattr(system.SDSlamSystem, s.method))
    with pytest.raises(ValueError, match="not 'stereo'"):
        sensors.sensor("stereo")


# --- (b) the similarity fit ---------------------------------------------------


def _similarity(seed):
    rng = np.random.default_rng(seed)
    R = sc.so3_exp(rng.normal(size=3))
    return 0.37, R, np.array([0.4, -1.2, 2.5])


def test_umeyama_recovers_a_planted_similarity():
    s, R, t = _similarity(1)
    X = np.random.default_rng(2).normal(size=(50, 3))
    got = check.umeyama(X, s * X @ R.T + t)
    assert abs(got[0] - s) < 1e-9
    assert np.abs(got[1] - R).max() < 1e-9 and np.abs(got[2] - t).max() < 1e-9
    assert check.umeyama(np.ones((5, 3)), X[:5]) is None  # no direction to fit


def _mono_outputs(offset_m=0.0, unposed=()):
    """A monocular run's outputs whose camera centres, keyframes and points
    are the truth carried by one similarity into a map frame, with every
    other window frame moved by +-offset_m (truth metres) along x. The lap
    spans a room (radius 0.6 m): a fit may shrink the map towards a point,
    so no error after it exceeds the spread of the truth's centres about
    their mean (8.6 cm on the localizing cell's 0.12-m orbit)."""
    poses = tr.lap_poses({"lap": {"kind": "orbit", "lap_frames": 48, "radius_m": 0.6,
                                  "yaw_amp_rad": 0.08}})
    lap = tr.Lap(poses, [], None, sc.make_room_scene(0))
    s, R, t = _similarity(3)

    def to_map(Xw):
        return (Xw - t) @ R / s

    idx = np.arange(60) % 48
    true_c = stats.camera_centers(poses[idx])
    shift = np.zeros_like(true_c)
    shift[:, 0] = offset_m * np.where(np.arange(60) % 2 == 0, 1.0, -1.0)
    est = to_map(true_c + shift)
    Tcw = np.repeat(np.eye(4)[None], 60, 0)
    Tcw[:, :3, 3] = -est
    kf_idx = np.arange(0, 48, 6)
    kf = np.repeat(np.eye(4)[None], len(kf_idx), 0)
    kf[:, :3, 3] = -to_map(stats.camera_centers(poses[kf_idx]))
    pts = np.array([[0.0, 0.0, 2.5], [0.3, 0.1, 2.5], [-0.4, 0.2, 2.5]])
    calls = [{"call": i, "lap_idx": int(k), "ms": 1.0, "posed": i not in unposed}
             for i, k in enumerate(idx)]
    run = {"calls": calls, "first_lap_idx": 0, "poses": list(Tcw),
           "kf": {"Tcw": kf, "lap_idx": kf_idx}, "points": to_map(pts), "orb_samples": []}
    return run, lap, s


def _compare(run, lap, fit_sim3=True):
    return check.compare(run, lap, CAM, {}, CPU, fit_sim3=fit_sim3)


def test_one_similarity_carries_poses_keyframes_and_points():
    run, lap, s = _mono_outputs()
    out = _compare(run, lap)
    assert out["ate_cm"] < 1e-7 and out["kf_ate_cm"] < 1e-7 and out["map_err_cm"] < 1e-7
    assert out["failed"] == 0 and abs(out["sim3_scale"] - s) < 1e-9


def test_an_alternating_offset_survives_the_fit():
    run, lap, _ = _mono_outputs(offset_m=0.30)
    out = _compare(run, lap)
    assert out["ate_cm"] >= 20.0 and out["failed"] > 30


def test_a_call_without_a_pose_fails_and_is_not_fitted():
    run, lap, _ = _mono_outputs(unposed=(0, 1, 2))
    for i in (0, 1, 2):  # an uninitialized tracker's identity, far from the truth
        run["poses"][i] = np.eye(4)
    out = _compare(run, lap)
    assert out["failed"] == 3 and out["ate_cm"] < 1e-7
    run, lap, _ = _mono_outputs(unposed=tuple(range(58)))
    out = _compare(run, lap)
    assert out["failed"] == 60 and math.isinf(out["ate_cm"]) and math.isinf(out["map_err_cm"])


@pytest.mark.parametrize("first", [0, 5, 31])
def test_rgbd_is_scored_in_the_first_frames_camera_without_a_fit(first):
    """RGB-D's numbers read as they did when the scorer worked in the map's
    own frame (the first frame's camera): the one transform, inv(T0) at
    scale 1, changes them by float64 rounding alone."""
    poses = tr.lap_poses({"lap": {"kind": "orbit", "lap_frames": 48, "radius_m": 0.24,
                                  "yaw_amp_rad": 0.16}})
    lap = tr.Lap(poses, [], None, sc.make_room_scene(0))
    rng = np.random.default_rng(first)
    T0 = poses[first]
    idx = (first + np.arange(200)) % 48
    Tcw = np.stack([poses[k] @ np.linalg.inv(T0) for k in idx])
    Tcw[:, :3, 3] += rng.normal(scale=0.004, size=(200, 3))
    Tcw[7, :3, 3] += 0.3  # one lost frame
    kf_idx = idx[:40:3]
    kf = np.stack([poses[k] @ np.linalg.inv(T0) for k in kf_idx])
    kf[:, :3, 3] += rng.normal(scale=0.003, size=(len(kf_idx), 3))
    pts = rng.uniform([-1.0, -0.5, 0.5], [1.0, 0.5, 2.4], size=(500, 3)) @ T0[:3, :3].T + T0[:3, 3]
    calls = [{"call": i, "lap_idx": int(k), "ms": 1.0, "posed": i > 2}
             for i, k in enumerate(idx)]
    run = {"calls": calls, "first_lap_idx": first, "poses": list(Tcw),
           "kf": {"Tcw": kf, "lap_idx": kf_idx}, "points": pts, "orb_samples": []}

    def in_map(X):
        return X @ T0[:3, :3].T + T0[:3, 3]

    err = np.linalg.norm(stats.camera_centers(Tcw) - in_map(stats.camera_centers(poses[idx])),
                         axis=1)
    kf_err = np.linalg.norm(stats.camera_centers(kf)
                            - in_map(stats.camera_centers(poses[kf_idx])), axis=1)
    d = sc.surface_distance(lap.scene, (pts - T0[:3, 3]) @ T0[:3, :3])
    want = {"ate_cm": np.sqrt((err**2).mean()) * 100, "kf_ate_cm": np.sqrt((kf_err**2).mean()) * 100,
            "map_err_cm": np.median(d) * 100}
    out = _compare(run, lap, fit_sim3=False)
    assert out["failed"] == 1 and "sim3_scale" not in out  # every call judged, none fitted
    for k, v in want.items():
        assert abs(out[k] - v) <= 1e-12 * v, k


# --- (c) the IMU synthesizer ------------------------------------------------


def test_gyro_integrates_to_the_truths_rotations():
    P = tr.lap_poses({"lap": {"kind": "orbit", "lap_frames": 120, "radius_m": 0.24,
                              "yaw_amp_rad": 0.16}})
    fps = 20.0
    imu = tr.imu_truth(P, fps)
    R = P[0][:3, :3]
    worst = 0.0
    for k in range(1, len(P)):
        R = sc.so3_exp(imu[k, :3] / fps) @ R
        worst = max(worst, np.linalg.norm(tr.so3_log(R @ P[k][:3, :3].T)))
    assert worst < 1e-3


def test_a_level_camera_at_rest_reads_gravity_upwards():
    # the room is y down: a real accelerometer at rest reads 9.81 m/s^2
    # along -y, up, away from the floor
    imu = tr.imu_truth(np.repeat(np.eye(4)[None], 5, 0), 20.0)
    assert np.array_equal(imu, np.tile([0.0, 0.0, 0.0, 0.0, -9.81, 0.0], (5, 1)))


def test_accelerometer_reads_minus_gravity_at_constant_velocity():
    fps, g = 30.0, np.array([0.0, 9.81, 0.0])
    n = 20
    P = np.repeat(np.eye(4)[None], n, 0)
    for k in range(n):
        R = sc.so3_exp(np.array([0.01 * k, 0.3 - 0.02 * k, 0.05]))
        c = np.array([0.1, -0.2, 0.3]) + np.array([0.5, 0.1, -0.2]) * k / fps
        P[k, :3, :3], P[k, :3, 3] = R, -R @ c
    imu = tr.imu_truth(P, fps)
    for k in range(1, n - 1):  # the ends wrap round to the other end of the lap
        assert np.abs(imu[k, 3:] - P[k, :3, :3] @ -g).max() < 1e-6


def _imu(**noise):
    imu = dict.fromkeys(tr.IMU_KEYS, 0.0)
    imu.update(rate_hz=200.0, **noise)
    return {"lap": {"fps": 20.0}, "imu": imu}


AT_REST = np.repeat(np.eye(4)[None], 100, 0)


def test_imu_noise_is_seeded_and_has_the_stated_density():
    params = _imu(gyro_noise_density=1.6968e-4, accel_noise_density=2.0e-3)
    a, b = tr.ImuStream(AT_REST, params, SEED), tr.ImuStream(AT_REST, params, SEED)
    x = np.stack([a.sample(k % 100) for k in range(10_000)])
    assert np.array_equal(x[:50], np.stack([b.sample(k) for k in range(50)]))
    want = np.repeat([1.6968e-4, 2.0e-3], 3) * math.sqrt(200.0)
    assert np.all(np.abs(x.std(0) / want - 1.0) < 0.10)
    quiet = tr.ImuStream(AT_REST, _imu(), SEED)
    truth = tr.imu_truth(AT_REST, 20.0)
    assert all(np.array_equal(quiet.sample(k), truth[k]) for k in range(20))


def test_an_imu_without_its_settings_is_refused():
    with pytest.raises(ValueError, match="missing rate_hz, gyro_noise_density"):
        tr.ImuStream(AT_REST, {"lap": {"fps": 20.0}}, SEED)
    params = _imu()
    del params["imu"]["accel_random_walk"]
    with pytest.raises(ValueError, match="missing accel_random_walk$"):
        tr.ImuStream(AT_REST, params, SEED)


def test_bias_walks_by_the_stated_density():
    params = _imu(gyro_random_walk=1.9393e-5, accel_random_walk=3.0e-3)
    s = tr.ImuStream(AT_REST[:1], params, SEED)
    x = np.stack([s.sample(0) for _ in range(10_000)])
    want = np.repeat([1.9393e-5, 3.0e-3], 3) * math.sqrt(1.0 / 20.0)
    assert np.all(np.abs(np.diff(x, axis=0).std(0) / want - 1.0) < 0.10)


# --- (d) whole monocular runs through the harness ---------------------------

SECONDS = 4.0
FAULT_SECONDS = 2.5  # a fault shows in the window's first frames
MONO_CELLS = ["tum1-mono.orbit", "tum1-mono-imu.orbit"]
# Limits of these CPU runs, each with its reason. The runs: a half-width
# image, a 24-frame lap, 6 set-up frames, a 4-s window of 6 or 7 frames.
# Sound runs on 5 seeds read ORB 0, ATE 0.13-1.00 cm, keyframes 0.55-1.83 cm,
# map 6.1-13.0 cm, no failed frame; the alternating fault ATE 2.5-3.9 cm,
# keyframes 9.2 cm, map 44-69 cm (the fit shrinks the map to a scale of
# 0.2 against a sound 2.4); the half fault ORB 20%.
LIMITS = {
    # the plain reference is the program's own extraction semantics: it
    # reads 0 on every cell of the benchmark; 10% is the benchmark's room
    "orb_miss_pct": 10.0,
    # the window's poses a few mm off after the fit. A fault cannot read
    # more than the spread of the window's true centres about their mean,
    # some 5 cm here: the fit may shrink the map towards a point
    "ate_cm": 3.0,
    # the keyframes and the map under the window's similarity: a fault that
    # moves poses shows here, where the shrunk map misses the truth
    "kf_ate_cm": 4.0,
    # a map this young was triangulated from baselines of a few cm, so its
    # points' median error is several cm
    "map_err_cm": 25.0,
    # every window frame of a sound run returns a pose within 10 cm
    "failed": 0,
}


@pytest.fixture(scope="module")
def mono_root(tmp_path_factory):
    """The benchmark's files with a monocular and a monocular + IMU copy of
    tum1-rgbd (TUM fr1 lens, depth keys dropped, 320x240, 1000 features
    over 4 levels, a 32-slot pool) on a 24-frame lap of the localizing
    cell's orbit, mapping without loop closing, at 30 and 20 Hz; the IMU
    at EuRoC imu0's densities. At 500 features the two-view bootstrap
    finds about 100 matches, its threshold, and may start late."""
    dst = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "perf_bench", dst / "perf_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((ROOT / "perf_bench/configs/tum1-rgbd.json").read_text())
    s = base["settings"]
    for k in ("Camera.bf", "ThDepth", "DepthMapFactor"):
        del s[k]
    for k in ("fx", "fy", "cx", "cy"):
        s[f"Camera.{k}"] /= 2
    s.update({"Camera.Width": 320, "Camera.Height": 240, "ORBextractor.nFeatures": 1000,
              "ORBextractor.nLevels": 4, "Map.MaxKeyframes": 32, "Map.MaxPoints": 4096})
    base["control"] = {"settings": {f"Camera.{k}": 0.0 for k in ("k1", "k2", "p1", "p2", "k3")},
                       "why": "breaks the undistortion guarantee"}
    traffic = json.loads((ROOT / "perf_bench/traffic/localize.json").read_text())
    traffic.update(setup_laps=0, setup_frames=6, localize=False, warmup_frames=0,
                   orb_sample_frames=1, loop_closing=False)
    traffic["lap"].update(lap_frames=24)
    for cell, sensor, fps in (("tum1-mono.orbit", "monocular", 30.0),
                              ("tum1-mono-imu.orbit", "monocular_imu", 20.0)):
        conf, name = cell.split(".")
        c = json.loads(json.dumps(base))
        c.update(name=conf, sensor=sensor)
        c["settings"]["Camera.fps"] = fps
        (dst / f"perf_bench/configs/{conf}.json").write_text(json.dumps(c))
        t = json.loads(json.dumps(traffic))
        t["lap"]["fps"] = fps
        if sensor == "monocular_imu":
            t["imu"] = {"rate_hz": 200.0, "gyro_noise_density": 1.6968e-4,
                        "gyro_random_walk": 1.9393e-5, "accel_noise_density": 2.0e-3,
                        "accel_random_walk": 3.0e-3}
        (dst / f"perf_bench/traffic/{conf}-{name}.json").write_text(json.dumps(t))
        (dst / f"perf_bench/limits/{cell}.json").write_text(json.dumps(LIMITS))
        bench["configs"].append({"name": conf, "source": "https://example.org", "reduced": [],
                                 "file": f"perf_bench/configs/{conf}.json", "why": sensor})
        bench["workloads"].append({"name": cell, "config": conf, "traffic": f"{conf}-{name}",
                                   "chips": 1, "why": sensor})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture(autouse=True, scope="module")
def four_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_render():
    """The generator is a function of its arguments: the runs of a cell
    share one rendering of its lap."""
    orig, laps = tr.make_lap, {}

    def make_lap(params, cam, depth_factor, seed, device):
        key = (json.dumps(params, sort_keys=True), cam, depth_factor, seed, str(device))
        if key not in laps:
            laps[key] = orig(params, cam, depth_factor, seed, device)
        return laps[key]

    tr.make_lap = make_lap
    yield
    tr.make_lap = orig


def run(root, cell, seconds=SECONDS, seed=20261018):
    m = Manifest(root)
    res = harness.run_cell(m, cell, seed, seconds, False, device="cpu")
    ok, checks = check.judge(res["numbers"], m.limits(cell))
    return ok, checks, res


@pytest.mark.parametrize("cell", MONO_CELLS)
def test_monocular_sound_run_is_correct(mono_root, one_render, cell):
    ok, checks, res = run(mono_root, cell)
    assert ok, json.dumps(checks)
    assert res["frames"] > 0 and 0.0 < res["numbers"]["sim3_scale"] < math.inf


def _alternating(orig):
    state = {"n": 0}

    def core(*a, **kw):
        out = orig(*a, **kw)
        state["n"] += 1
        T = out.Tcw.clone()
        T[0, 3] += 0.30 if state["n"] % 2 else -0.30
        return out._replace(Tcw=T)
    return core


@pytest.mark.parametrize("cell,fault", [("tum1-mono.orbit", "half"),
                                        ("tum1-mono-imu.orbit", "alternating")])
def test_monocular_fault_is_not_correct(mono_root, one_render, cell, fault, monkeypatch):
    from sdslam_tpu_torch.features import frame
    from sdslam_tpu_torch.pipeline import tracking

    if fault == "half":
        monkeypatch.setattr(frame.ORBExtractor, "extract", _half(frame.ORBExtractor.extract))
    else:
        monkeypatch.setattr(tracking, "_track_core", _alternating(tracking._track_core))
    ok, checks, _ = run(mono_root, cell, FAULT_SECONDS)
    assert not ok, checks
