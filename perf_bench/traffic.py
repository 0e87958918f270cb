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
- `orb_sample_frames`: window frames whose ORB extraction is checked.

The seed draws the sensor noise (and which window frames the ORB check
samples): every seed patrols the same lap from the same start, so the
work is the same and only the noise differs. The lap is
rendered once, on the device, and copied to the host as an RGB-D
camera's payloads (u8 image; u16 depth at the configuration's
DepthMapFactor).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from perf_bench import scene as sc


class Lap(NamedTuple):
    poses: np.ndarray  # [L,4,4] Tcw (float64); frame 0 is the identity
    images: List[np.ndarray]  # L x [H,W] u8
    depths: List[np.ndarray]  # L x [H,W] u16
    scene: sc.PlaneScene


def lap_poses(params: dict) -> np.ndarray:
    lap = params["lap"]
    if lap["kind"] != "orbit":
        raise ValueError(f"unknown lap kind {lap['kind']!r}")
    return sc.orbit_trajectory(int(lap["lap_frames"]), float(lap["radius_m"]),
                               float(lap["yaw_amp_rad"]))


def make_lap(params: dict, cam: sc.Camera, depth_factor: float, seed: int, device) -> Lap:
    """Render the seed's lap on `device` and bring it to the host."""
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
        depths.append(torch.clamp(torch.round(dep * depth_factor), 0, 65535).to(torch.int32))
    images = [a.cpu().numpy() for a in images]
    depths = [a.cpu().numpy().astype(np.uint16) for a in depths]
    return Lap(poses, images, depths, scene.to("cpu"))


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
