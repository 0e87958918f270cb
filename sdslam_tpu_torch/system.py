"""System facade: the public API of the port (sdslam_tpu/system.py).

`SDSlamSystem(cfg, sensor=MONOCULAR, loop_closing=True, device="cuda")`
routes frames by sensor: `track_monocular(img, ts)`, `track_rgbd(img,
depth, ts)` and `track_fusion(img, [gx, gy, gz, ax, ay, az], ts)`. After
each frame the new keyframes go to the loop closer (detection dispatched
without a host sync, results drained once their copies land) and an
accepted correction re-anchors the tracker. Monocular maps close loops
with a 7-DoF Sim3 (scale drifts), RGB-D maps with a fixed scale. No
threads: tracking, mapping and loop closing run in sequence on one stream.

Persistence: `save_trajectory_tum` writes the TUM evaluation format,
`save_map` / `load_map` an npz checkpoint of the whole map in the JAX
package's layout (a map saved by either package loads into the other),
and `save_trajectory` / `load_trajectory` the reference's YAML + PNG map
(io/map_yaml.py). A loaded map leaves the tracker LOST, to relocalize
against it.
"""

from __future__ import annotations

import numpy as np
import torch

from sdslam_tpu_torch import _device, interop
from sdslam_tpu_torch.geometry import lie
from sdslam_tpu_torch.pipeline.loop_closing import LoopCloser
from sdslam_tpu_torch.pipeline.sensors import IMUStateEKF
from sdslam_tpu_torch.pipeline.tracking import MonoTracker, RGBDTracker
from sdslam_tpu_torch.utils.config import SystemConfig
from sdslam_tpu_torch.utils.profiling import frame_span

MONOCULAR = "monocular"
RGBD = "rgbd"
MONOCULAR_IMU = "monocular_imu"


class SDSlamSystem:
    """Facade over the tracking / mapping / loop-closing pipeline."""

    def __init__(self, config: SystemConfig, sensor: str = MONOCULAR, loop_closing: bool = True,
                 device="cuda"):
        if sensor not in (MONOCULAR, RGBD, MONOCULAR_IMU):
            raise ValueError(f"unknown sensor type: {sensor}")
        self.config = config
        self.sensor = sensor
        self.device = _device.resolve(device)
        self._build()
        self.loop_closing_enabled = loop_closing
        self.localization_only = False
        # cooperative stop flag (System::RequestStop), polled by the
        # front-end loop, which then stops and saves
        self.stop_requested = False

    def _build(self):
        tracker = RGBDTracker if self.sensor == RGBD else MonoTracker
        self.tracker = tracker(self.config, device=self.device)
        # host mirror of the fusion sensor's IMU filter (introspection only:
        # the tracker's step runs the filter on the device)
        self.imu = IMUStateEKF() if self.sensor == MONOCULAR_IMU else None
        self.loop_closer = LoopCloser(cam=self.config.camera,
                                      scale_factor=self.config.orb.scale_factor,
                                      n_levels=self.config.orb.n_levels,
                                      fix_scale=self.sensor == RGBD)
        # every info dict the loop closer returned, in order (detections,
        # verifications, corrections)
        self.loop_infos = []

    def track_monocular(self, image, timestamp: float) -> np.ndarray:
        assert self.sensor == MONOCULAR, "system built for another sensor"
        with frame_span(len(self.tracker.trajectory)):
            pose = self.tracker.track(image, timestamp)
            self._after_frame()
        return pose

    def track_rgbd(self, image, depth, timestamp: float) -> np.ndarray:
        assert self.sensor == RGBD, "system built for another sensor"
        with frame_span(len(self.tracker.trajectory)):
            pose = self.tracker.track(image, depth, timestamp)
            self._after_frame()
        return pose

    def track_fusion(self, image, measurements, timestamp: float) -> np.ndarray:
        """Monocular + IMU: measurements = [gx, gy, gz, ax, ay, az]. The
        sample rides this frame's step, where the device filter fuses it
        with the frame's tracked pose; the host mirror `self.imu` fuses
        the last drained pose."""
        assert self.sensor == MONOCULAR_IMU, "system built for another sensor"
        m = np.asarray(measurements, float).reshape(-1)
        dt = max(timestamp - self.tracker.st.last_ts, 1e-3)
        with frame_span(len(self.tracker.trajectory)):
            self.tracker.inject_imu(m[:3], m[3:6])
            if self.tracker.st.status != "NOT_INITIALIZED" and self.tracker.st.T_last is not None:
                self.imu.predict(dt)
                self.imu.update(np.asarray(self.tracker.st.T_last), m[:3], m[3:6], dt)
            pose = self.tracker.track(image, timestamp)
            self._after_frame()
        return pose

    def _apply_infos(self, infos):
        self.loop_infos.extend(infos)
        for info in infos:
            if info.get("corrected"):
                # tracking follows the corrected map
                self.tracker.reset_reference(info["kf"])

    def _after_frame(self):
        # live-viewer menu actions apply here, at the frame boundary, on the
        # thread that owns the tracking loop (viewer_server.py)
        lv = getattr(self, "_live_viewer", None)
        if lv is not None:
            lv.apply_pending()
        if self.localization_only:
            return
        if not self.loop_closing_enabled:
            self.tracker.kf_events.clear()
            return
        while self.tracker.kf_events:
            self.loop_closer.dispatch_keyframe(self.tracker.ms, self.tracker.kf_events.pop(0))
        self.tracker.ms, infos = self.loop_closer.poll(self.tracker.ms)
        self._apply_infos(infos)

    def finish(self):
        """Drain every in-flight frame and loop-closing result (call at the
        end of a sequence before reading trajectories or the map)."""
        self.tracker.flush()
        if self.loop_closing_enabled and not self.localization_only:
            self.tracker.ms, infos = self.loop_closer.poll(self.tracker.ms, force=True)
            self._apply_infos(infos)

    def request_stop(self):
        """Ask the owning front-end loop to stop after the current frame
        and save (System::RequestStop)."""
        self.stop_requested = True

    def activate_localization_mode(self):
        """Track against the frozen map: no new keyframes or points."""
        self.localization_only = True
        self.tracker.mapping_enabled = False

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.tracker.mapping_enabled = True

    def reset(self):
        """Clear the map and restart tracking (System::Reset)."""
        self._build()

    def get_tracking_state(self) -> str:
        self.tracker.flush()
        return self.tracker.st.status

    def map_changed(self) -> int:
        return int(self.tracker.ms.next_kf_id)

    # -- persistence (System.cc:277-533) ---------------------------------------

    def save_trajectory_tum(self, path: str):
        """TUM format: timestamp tx ty tz qx qy qz qw (camera-to-world)."""
        self.tracker.flush()
        with open(path, "w") as f:
            for ts, Tcw in zip(self.tracker.timestamps, self.tracker.trajectory):
                Twc = np.linalg.inv(np.asarray(Tcw))
                q = lie.mat_to_quat(torch.as_tensor(Twc[:3, :3], dtype=torch.float32)).numpy()
                t = Twc[:3, 3]
                f.write(f"{float(ts):.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                        f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")

    def save_trajectory(self, path: str, folder: str):
        """The reference's YAML map (System::SaveTrajectory): camera block,
        keyframe poses with one PNG each in `folder`, points with their
        pixel observations."""
        from sdslam_tpu_torch.io.map_yaml import save_trajectory_yaml

        save_trajectory_yaml(self, path, folder)

    def load_trajectory(self, path: str) -> bool:
        """The reference's YAML map load (System::LoadTrajectory): features
        re-extracted from the saved images, points relinked by pixel, the
        tracker left LOST."""
        from sdslam_tpu_torch.io.map_yaml import load_trajectory_yaml

        return load_trajectory_yaml(self, path) > 0

    def save_map(self, path: str):
        """Checkpoint the whole map as npz in the JAX package's layout: one
        array per field, the pyramid as kf_pyramid_0.., descriptors uint32."""
        arrays = {}
        for field, value in interop.map_state_to_numpy(self.tracker.ms).items():
            if field == "kf_pyramid":
                arrays.update({f"kf_pyramid_{i}": lvl for i, lvl in enumerate(value)})
            else:
                arrays[field] = value
        np.savez_compressed(path, **arrays)

    def load_map(self, path: str):
        """Restore a map checkpoint on this system's device; the tracker
        starts LOST and relocalizes against it (System.cc:529)."""
        with np.load(path) as data:
            fields = {k: data[k] for k in data.files}
        n_levels = sum(k.startswith("kf_pyramid_") for k in fields)
        fields["kf_pyramid"] = [fields.pop(f"kf_pyramid_{i}") for i in range(n_levels)]
        # checkpoints from before the map kept its loop edges
        fields.setdefault("loop_edges", np.full((32, 2), -1, np.int32))
        tracker = self.tracker
        tracker.flush()
        tracker.ms = interop.map_state_from_numpy(fields, device=self.device)
        tracker.st.status = "LOST"
        tracker.st.T_last = np.eye(4, dtype=np.float32)
        tracker.st.last_kf_slot = int(np.flatnonzero(fields["kf_valid"])[-1])

    def shutdown(self):
        """No threads to join (the reference joins LocalMapping and
        LoopClosing, System.cc:256-275); kept for the API."""
