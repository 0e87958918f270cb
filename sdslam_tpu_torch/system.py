"""System facade: the public API of the port (sdslam_tpu/system.py's
tracking, loop-closing and mode parts).

`SDSlamSystem(cfg, sensor=MONOCULAR, loop_closing=True, device="cuda")`
routes frames by sensor: `track_monocular(img, ts)`, `track_rgbd(img,
depth, ts)` and `track_fusion(img, [gx, gy, gz, ax, ay, az], ts)`. After
each frame the new keyframes go to the loop closer (detection dispatched
without a host sync, results drained once their copies land) and an
accepted correction re-anchors the tracker. Monocular maps close loops
with a 7-DoF Sim3 (scale drifts), RGB-D maps with a fixed scale. No
threads: tracking, mapping and loop closing run in sequence on one stream.
"""

from __future__ import annotations

import numpy as np

from sdslam_tpu_torch import _device
from sdslam_tpu_torch.pipeline.loop_closing import LoopCloser
from sdslam_tpu_torch.pipeline.sensors import IMUStateEKF
from sdslam_tpu_torch.pipeline.tracking import MonoTracker, RGBDTracker
from sdslam_tpu_torch.utils.config import SystemConfig

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
        pose = self.tracker.track(image, timestamp)
        self._after_frame()
        return pose

    def track_rgbd(self, image, depth, timestamp: float) -> np.ndarray:
        assert self.sensor == RGBD, "system built for another sensor"
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
