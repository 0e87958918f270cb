"""Streaming front-end: message types, approximate-time sync, odometry out
(sdslam_tpu/io/stream.py).

The ROS-free counterpart of the reference's ROS nodes (ros_monocular.cc,
ros_rgbd.cc, ros_fusion.cc): message containers for camera, depth and IMU
samples; approximate-time pairing of two asynchronous streams (the
reference's message_filters ApproximateTime with queue size 10); and a
runner that feeds synchronized pairs into `SDSlamSystem` and emits
odometry records (the `/sdslam/odom` publisher), optionally stamped with
the original image times so trajectories line up with TUM ground truth
(Config::UseImagesTimeStamps).

Everything here runs on the host; the system the runner drives owns the
device.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ImageMsg:
    """A stamped intensity or depth image (sensor_msgs/Image)."""

    stamp: float  # seconds
    data: np.ndarray  # [H,W] u8 intensity or u16/f32 depth
    frame_id: str = "camera"


@dataclasses.dataclass(frozen=True)
class ImuMsg:
    """A stamped IMU sample (sensor_msgs/Imu: angular velocity and linear
    acceleration, what the reference's fusion node consumes)."""

    stamp: float
    angular_velocity: np.ndarray  # [3] rad/s
    linear_acceleration: np.ndarray  # [3] m/s^2


@dataclasses.dataclass(frozen=True)
class OdometryMsg:
    """A stamped pose estimate (nav_msgs/Odometry): world-from-camera."""

    stamp: float
    Twc: np.ndarray  # [4,4]
    tracked: bool
    frame_id: str = "world"
    child_frame_id: str = "camera"

    @property
    def position(self) -> np.ndarray:
        return self.Twc[:3, 3]

    @property
    def quaternion_xyzw(self) -> np.ndarray:
        from sdslam_tpu_torch.geometry.lie import mat_to_quat

        R = torch.as_tensor(np.asarray(self.Twc)[:3, :3], dtype=torch.float32)
        q = mat_to_quat(R).numpy()  # [w,x,y,z]
        return np.array([q[1], q[2], q[3], q[0]])


class ApproximateTimeSync:
    """Pair two asynchronous stamped streams by nearest timestamp.

    message_filters ApproximateTime as the reference's RGB-D and fusion
    nodes configure it: each stream buffers up to `queue_size` messages;
    whenever a pair with time difference <= `slop` exists, the closest
    such pair goes to the callback and older messages are discarded.
    """

    def __init__(self, callback: Callable[[object, object], None], queue_size: int = 10,
                 slop: float = 0.02):
        self._cb = callback
        self._slop = float(slop)
        self._qa: Deque = deque(maxlen=queue_size)
        self._qb: Deque = deque(maxlen=queue_size)
        self._lock = threading.Lock()

    def push_a(self, msg) -> None:
        with self._lock:
            self._qa.append(msg)
            self._try_emit()

    def push_b(self, msg) -> None:
        with self._lock:
            self._qb.append(msg)
            self._try_emit()

    def _try_emit(self) -> None:
        while self._qa and self._qb:
            best: Optional[Tuple[int, int, float]] = None
            for i, a in enumerate(self._qa):
                for j, b in enumerate(self._qb):
                    dt = abs(a.stamp - b.stamp)
                    if dt <= self._slop and (best is None or dt < best[2]):
                        best = (i, j, dt)
            if best is None:
                # drop the oldest of whichever stream has run ahead
                if (len(self._qa) == self._qa.maxlen
                        and self._qa[0].stamp < self._qb[0].stamp - self._slop):
                    self._qa.popleft()
                    continue
                if (len(self._qb) == self._qb.maxlen
                        and self._qb[0].stamp < self._qa[0].stamp - self._slop):
                    self._qb.popleft()
                    continue
                return
            i, j, _ = best
            a, b = self._qa[i], self._qb[j]
            # discard everything at or before the matched messages
            for _ in range(i + 1):
                self._qa.popleft()
            for _ in range(j + 1):
                self._qb.popleft()
            self._cb(a, b)


def associate_imu_to_frames(frame_stamps: Sequence[float],
                            imu_msgs: Sequence[ImuMsg]) -> List[Optional[ImuMsg]]:
    """One IMU sample per frame: the one nearest in time (the fusion
    example's CSV association, monocular_imu.cc:105-145)."""
    if not imu_msgs:
        return [None] * len(frame_stamps)
    stamps = np.array([m.stamp for m in imu_msgs])
    return [imu_msgs[int(np.argmin(np.abs(stamps - t)))] for t in frame_stamps]


class StreamRunner:
    """Drive an `SDSlamSystem` from pushed messages, emitting odometry.

    RGB-D: push intensity to `push_image` and depth to `push_depth`; pairs
    are approximate-time synchronized and tracked. Monocular: push images
    only. Fusion: push IMU samples too; the latest one at or before each
    frame rides with it (else the oldest buffered, else zeros).

    `use_image_timestamps` keeps the image stamps on the emitted odometry;
    otherwise each record carries the wall clock at emission.
    """

    def __init__(self, system, sensor: str = "rgbd", queue_size: int = 10, slop: float = 0.02,
                 use_image_timestamps: bool = True,
                 odom_callback: Optional[Callable[[OdometryMsg], None]] = None):
        self.system = system
        self.sensor = sensor
        self.use_image_timestamps = use_image_timestamps
        self.odometry: List[OdometryMsg] = []
        self._odom_cb = odom_callback
        self._imu_buf: Deque[ImuMsg] = deque(maxlen=200)
        self._sync = (ApproximateTimeSync(self._on_rgbd_pair, queue_size=queue_size, slop=slop)
                      if sensor == "rgbd" else None)

    # -- message inputs ------------------------------------------------------

    def push_image(self, msg: ImageMsg) -> None:
        if self.sensor == "rgbd":
            self._sync.push_a(msg)
        elif self.sensor == "fusion":
            self._on_fusion_frame(msg)
        else:
            self._on_mono_frame(msg)

    def push_depth(self, msg: ImageMsg) -> None:
        if self.sensor != "rgbd":
            raise ValueError("the depth stream exists only for RGB-D")
        self._sync.push_b(msg)

    def push_imu(self, msg: ImuMsg) -> None:
        self._imu_buf.append(msg)

    # -- per-frame tracking ----------------------------------------------------

    def _emit(self, stamp: float, Tcw) -> None:
        # the tracker returns a device tensor until the frame drains
        if isinstance(Tcw, torch.Tensor):
            Tcw = Tcw.detach().cpu().numpy()
        Tcw = np.asarray(Tcw, np.float64)
        R, t = Tcw[:3, :3], Tcw[:3, 3]
        Twc = np.eye(4)
        Twc[:3, :3] = R.T
        Twc[:3, 3] = -R.T @ t
        odo = OdometryMsg(stamp=stamp if self.use_image_timestamps else time.time(), Twc=Twc,
                          tracked=self.system.tracker.st.status == "OK")
        self.odometry.append(odo)
        if self._odom_cb is not None:
            self._odom_cb(odo)

    def _on_rgbd_pair(self, img: ImageMsg, depth: ImageMsg) -> None:
        self._emit(img.stamp, self.system.track_rgbd(img.data, depth.data, img.stamp))

    def _on_mono_frame(self, img: ImageMsg) -> None:
        self._emit(img.stamp, self.system.track_monocular(img.data, img.stamp))

    def _on_fusion_frame(self, img: ImageMsg) -> None:
        m = next((s for s in reversed(self._imu_buf) if s.stamp <= img.stamp), None)
        if m is None and self._imu_buf:
            m = self._imu_buf[0]
        meas = (np.concatenate([m.angular_velocity, m.linear_acceleration]) if m is not None
                else np.zeros(6))
        self._emit(img.stamp, self.system.track_fusion(img.data, meas, img.stamp))

    # -- outputs -----------------------------------------------------------------

    def write_tum_trajectory(self, path: str) -> None:
        """The odometry as a TUM file (timestamp tx ty tz qx qy qz qw)."""
        with open(path, "w") as f:
            for o in self.odometry:
                p, q = o.position, o.quaternion_xyzw
                f.write(f"{o.stamp:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
