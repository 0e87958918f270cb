"""Monocular + IMU tracking through EuRoC cam0's barrel lens, on the CPU:
the facade's `track_fusion` over a reduced lap of `perf_bench/scene.py`'s
room (intrinsics halved to 376x240, cam0's lens coefficients, imu0's
noise at 20 Hz), scored by a similarity fit of the returned camera centres
to the truth, as the benchmark scores a monocular cell.

The same lap, before the aligner read lens-corrected levels, read 5.42 cm
(and the JAX package's tracker 5.29 cm) against a ceiling of 9.11 cm, the
lap's RMS spread about its mean, which no fitted ATE can exceed; with them
it reads 0.64 cm (`ROADMAP.md`, queue 1, item 2).
"""

import numpy as np
import torch

from sdslam_tpu_torch.system import MONOCULAR_IMU, SDSlamSystem
from sdslam_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

SETTINGS = {"Camera.fx": 229.327, "Camera.fy": 228.648, "Camera.cx": 183.6075,
            "Camera.cy": 124.1875, "Camera.Width": 376, "Camera.Height": 240,
            "Camera.k1": -0.28340811, "Camera.k2": 0.07395907, "Camera.p1": 0.00019359,
            "Camera.p2": 1.76187114e-05, "Camera.fps": 20.0, "UsePattern": 0,
            "ORBextractor.nFeatures": 500, "ORBextractor.scaleFactor": 2.0,
            "ORBextractor.nLevels": 5, "ORBextractor.thresholdFAST": 20,
            "Map.MaxKeyframes": 32, "Map.MaxPoints": 2048}
LAP = {"lap": {"kind": "orbit", "lap_frames": 48, "radius_m": 0.12, "yaw_amp_rad": 0.08,
               "fps": 20.0}, "scene_seed": 0, "image_noise_sigma": 2.0,
       "imu": {"rate_hz": 200, "gyro_noise_density": 1.6968e-4, "gyro_random_walk": 1.9393e-5,
               "accel_noise_density": 2.0e-3, "accel_random_walk": 3.0e-3}}
SEED = 2147483659
# 0.64 cm measured; the lap before the lens-corrected levels read 5.42 cm
# with its map's scale collapsed (1.11 against a sound 2.05): 1.5 cm leaves
# the reading twice its size and sits far under the fault
ATE_LIMIT_CM = 1.5


def test_reduced_euroc_lap_tracks_through_the_lens(tmp_path):
    from perf_bench import check, stats
    from perf_bench import scene as sc
    from perf_bench import traffic as tr

    path = tmp_path / "euroc_half.yaml"
    path.write_text("%YAML:1.0\n" + "".join(f"{k}: {v!r}\n" for k, v in SETTINGS.items()))
    lap = tr.make_lap(LAP, sc.Camera.from_yaml_keys(SETTINGS), None, SEED, torch.device("cpu"))
    imu = tr.ImuStream(lap.poses, LAP, SEED)
    slam = SDSlamSystem(load_config(str(path)), sensor=MONOCULAR_IMU, loop_closing=False,
                        device="cpu")
    posed = []
    for k in range(len(lap.poses)):
        before = slam.tracker.st.status
        slam.track_fusion(lap.images[k], imu.sample(k), k / 20.0)
        posed.append(before == "OK" or slam.tracker.st.status == "OK")
    slam.finish()
    est = np.stack([np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p, np.float64)
                    for p in slam.tracker.trajectory])
    posed = np.array(posed)
    true_c = stats.camera_centers(lap.poses)[posed]
    est_c = stats.camera_centers(est)[posed]
    assert posed.sum() >= len(posed) - 4  # the bootstrap's two views, at most
    s, R, t = check.umeyama(est_c, true_c)
    err = np.linalg.norm(s * est_c @ R.T + t - true_c, axis=1)
    ate_cm = float(np.sqrt((err**2).mean())) * 100
    assert ate_cm < ATE_LIMIT_CM, (ate_cm, s)
