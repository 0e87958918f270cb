"""System facade: the public API of the port (the RGB-D part of
sdslam_tpu/system.py).

`SDSlamSystem(cfg, sensor=RGBD, loop_closing=True, device="cuda")` tracks
frames with `track_rgbd`; after each frame the new keyframes go to the loop
closer (detection dispatched without a host sync, results drained once
their copies land) and an accepted correction re-anchors the tracker.
No threads: tracking, mapping and loop closing run in sequence on one
stream.
"""

from __future__ import annotations

import numpy as np

from sdslam_tpu_torch import _device
from sdslam_tpu_torch.pipeline.loop_closing import LoopCloser
from sdslam_tpu_torch.pipeline.tracking import RGBDTracker
from sdslam_tpu_torch.utils.config import SystemConfig

MONOCULAR = "monocular"
RGBD = "rgbd"
MONOCULAR_IMU = "monocular_imu"

# sensors of the JAX package that the port has not reached yet
_NOT_PORTED = {
    MONOCULAR: "ROADMAP.md M13 (monocular)",
    MONOCULAR_IMU: "ROADMAP.md M13 and M15 (monocular, IMU fusion)",
}


class SDSlamSystem:
    """Facade over the tracking / mapping / loop-closing pipeline."""

    def __init__(self, config: SystemConfig, sensor: str = RGBD, loop_closing: bool = True,
                 device="cuda"):
        if sensor in _NOT_PORTED:
            raise NotImplementedError(f"sensor {sensor!r} is not ported yet: {_NOT_PORTED[sensor]}")
        if sensor != RGBD:
            raise ValueError(f"unknown sensor type: {sensor}")
        self.config = config
        self.sensor = sensor
        self.device = _device.resolve(device)
        self._build()
        self.loop_closing_enabled = loop_closing
        self.localization_only = False

    def _build(self):
        self.tracker = RGBDTracker(self.config, device=self.device)
        self.loop_closer = LoopCloser(cam=self.config.camera,
                                      scale_factor=self.config.orb.scale_factor,
                                      n_levels=self.config.orb.n_levels, fix_scale=True)
        # every info dict the loop closer returned, in order (detections,
        # verifications, corrections)
        self.loop_infos = []

    def track_rgbd(self, image, depth, timestamp: float) -> np.ndarray:
        pose = self.tracker.track(image, depth, timestamp)
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
