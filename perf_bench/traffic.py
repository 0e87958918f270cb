"""The one traffic generator: turns a cell's traffic file and a seed into
the frames a camera hands the SLAM facade, and the truth they come from.

A traffic file (`perf_bench/traffic/<cell>.json`) holds only parameters:

- `lap`: the periodic camera path (`orbit`: `lap_frames`, `radius_m`,
  `yaw_amp_rad`) and `fps`, the camera's rate (timestamps only: frames are
  offered in a closed loop);
- `scene_seed`: the room; every run of a cell sees the same room, so every
  seed does the same work in another order;
- `image_noise_sigma`: grey levels of Gaussian sensor noise;
- `setup_laps` / `setup_frames`: frames fed before the window (a mapped
  lap, or the first frames of the patrol);
- `localize`: localization mode from the end of the set-up;
- `warmup_frames`: frames fed after that, before the window;
- `traced_frames`: frames the `--trace 1` run profiles after its window;
- `orb_sample_frames`: window frames whose ORB extraction is checked;
- `imu` (required for a sensor with an IMU, read by no other): the IMU's
  `rate_hz` and noise, `gyro_noise_density` (rad/s/sqrt(Hz)),
  `gyro_random_walk` (rad/s^2/sqrt(Hz)), `accel_noise_density`
  (m/s^2/sqrt(Hz)) and `accel_random_walk` (m/s^3/sqrt(Hz)), every key
  given (0 for a noise the IMU has not).

The seed draws the sensor noise (and which window frames the ORB check
samples): every seed patrols the same lap from the same start, so the
work is the same and only the noise differs. The lap is
rendered once, on the device, and copied to the host as the camera's
payloads: a u8 image, and for an RGB-D camera a u16 depth at the
configuration's DepthMapFactor.

The IMU gives one [gyro(3), accel(3)] sample with each frame, in the
convention the facade's `track_fusion` takes (the port's motion model
left-multiplies the last pose by the twist). The gyro is the rotation from
the previous frame's camera to this one's as a rate, so3_log(R_k
R_{k-1}^T) * fps, in this camera's frame: the opposite sign of a physical
gyro's body rate, as the port's own IMU tests give it. The accelerometer
is the specific force in this camera's frame, R_k (a_k - g), where a_k is
the camera centre's acceleration (the second difference of the truth's
centres at the lap's `fps`) and g is `GRAVITY_WORLD`, along the room's
down axis: a level camera at rest reads 9.81 m/s^2 upwards, along -y. The
port's filter learns gravity by low-passing the accelerometer and reads
the rest as motion; the benchmark gives it the physical reading all the
same. White
noise is that of one sample at `rate_hz` (density * sqrt(rate_hz)); the
bias walks by random_walk * sqrt(1 / fps) between frames. The noise comes
from a generator of its own, seeded from [seed, 3], drawn in call order,
so the image noise is the same with or without an IMU.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from perf_bench import scene as sc


GRAVITY_WORLD = 9.81 * np.array(sc.DOWN)  # m/s^2, in the room's frame
IMU_KEYS = ("rate_hz", "gyro_noise_density", "gyro_random_walk", "accel_noise_density",
            "accel_random_walk")


class Lap(NamedTuple):
    poses: np.ndarray  # [L,4,4] Tcw (float64); frame 0 is the identity
    images: List[np.ndarray]  # L x [H,W] u8
    depths: Optional[List[np.ndarray]]  # L x [H,W] u16; None without depth
    scene: sc.PlaneScene


def lap_poses(params: dict) -> np.ndarray:
    lap = params["lap"]
    if lap["kind"] != "orbit":
        raise ValueError(f"unknown lap kind {lap['kind']!r}")
    return sc.orbit_trajectory(int(lap["lap_frames"]), float(lap["radius_m"]),
                               float(lap["yaw_amp_rad"]))


def make_lap(params: dict, cam: sc.Camera, depth_factor: Optional[float], seed: int,
             device) -> Lap:
    """Render the seed's lap on `device` and bring it to the host, with
    depth at `depth_factor` (none where it is None)."""
    poses = lap_poses(params)
    scene = sc.make_room_scene(int(params["scene_seed"])).to(device)
    rays = sc.pixel_rays(cam, device)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    sigma = float(params["image_noise_sigma"])
    images, depths = [], []
    for T in poses:
        img, dep = sc.render(scene, rays, torch.as_tensor(T, dtype=torch.float32, device=device))
        noise = torch.randn(img.shape, generator=gen, device=device) * sigma
        images.append(torch.clamp(torch.round(img + noise), 0, 255).to(torch.uint8))
        if depth_factor is not None:
            depths.append(torch.clamp(torch.round(dep * depth_factor), 0, 65535).to(torch.int32))
    images = [a.cpu().numpy() for a in images]
    depths = (None if depth_factor is None
              else [a.cpu().numpy().astype(np.uint16) for a in depths])
    return Lap(poses, images, depths, scene.to("cpu"))


def so3_log(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector, float64 (angles below pi)."""
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = float(np.arccos(c))
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return 0.5 * w if th < 1e-9 else th / (2.0 * np.sin(th)) * w


def imu_truth(poses: np.ndarray, fps: float) -> np.ndarray:
    """[L,6] noise-free [gyro, accel] of each frame of a periodic lap of Tcw
    poses (frame L would be frame 0 again), float64; see the module's
    docstring for the convention."""
    P = np.asarray(poses, np.float64)
    R = P[:, :3, :3]
    c = -np.einsum("nji,nj->ni", R, P[:, :3, 3])  # camera centres in the world
    acc = (np.roll(c, -1, 0) - 2.0 * c + np.roll(c, 1, 0)) * fps**2
    f = np.einsum("nij,nj->ni", R, acc - GRAVITY_WORLD)
    gyro = np.stack([so3_log(R[k] @ R[k - 1].T) * fps for k in range(len(P))])
    return np.concatenate([gyro, f], 1)


class ImuStream:
    """The IMU sample handed over with each call: the lap frame's noise-free
    sample (`imu_truth` of the lap's poses), plus white noise and the bias's
    random walk drawn in call order from the run's own IMU generator."""

    def __init__(self, poses: np.ndarray, params: dict, seed: int):
        imu, fps = params.get("imu"), float(params["lap"]["fps"])
        missing = [k for k in IMU_KEYS if k not in (imu or {})]
        if missing:
            raise ValueError(f"a sensor with an IMU needs the traffic file's `imu` object "
                             f"with {', '.join(IMU_KEYS)}; missing {', '.join(missing)}")
        rate, gyro_w, gyro_b, accel_w, accel_b = (float(imu[k]) for k in IMU_KEYS)
        self.truth = imu_truth(poses, fps)
        self.white = np.repeat([gyro_w, accel_w], 3) * np.sqrt(rate)
        self.walk = np.repeat([gyro_b, accel_b], 3) * np.sqrt(1.0 / fps)
        self.bias = np.zeros(6)
        self.rng = np.random.default_rng([seed % 2**63, 3])

    def sample(self, k: int) -> np.ndarray:
        z = self.rng.standard_normal(12)
        self.bias = self.bias + self.walk * z[6:]
        return self.truth[k] + self.bias + self.white * z[:6]


class Schedule:
    """The frame sequence of a run: the lap cycled from its start, one
    (lap index, timestamp) at a time."""

    def __init__(self, params: dict, lap_frames: int):
        self.L = lap_frames
        self.fps = float(params["lap"]["fps"])
        self.n = 0

    def next(self):
        k, ts = self.n % self.L, self.n / self.fps
        self.n += 1
        return k, ts
