"""ROS node layer: topic transport for the streaming front-end (port of
sdslam_tpu/io/ros_nodes.py; host only).

The counterpart of the reference's ROS package (Examples/ROS/SD-SLAM/src/
{ros_monocular,ros_rgbd,ros_fusion}.cc): three nodes that subscribe to
configurable image / depth / IMU topics, feed the SLAM system, and publish
`/sdslam/odom` (nav_msgs/Odometry), optionally stamped with the original
image times so TUM evaluation lines up with the ground truth
(Config::UseImagesTimeStamps).

ROS itself is optional: the sync and tracking logic lives in the ROS-free
`io/stream.py`, and this module is only the transport shim. `rospy` is
imported at node start unless a rospy-compatible module is injected, so the
wiring is testable (and usable over a bridge) without a ROS install. Image
decoding covers the encodings the reference nodes consume through
cv_bridge (mono8 / rgb8 / bgr8 intensity, 16UC1 / 32FC1 depth), read
directly from the sensor_msgs/Image fields.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from sdslam_tpu_torch.io.stream import ImageMsg, ImuMsg, OdometryMsg, StreamRunner

DEFAULT_CAMERA_TOPIC = "/camera/image_raw"
DEFAULT_DEPTH_TOPIC = "/camera/depth/image_raw"
DEFAULT_IMU_TOPIC = "/imu/data"
ODOM_TOPIC = "/sdslam/odom"


def decode_image(msg) -> np.ndarray:
    """sensor_msgs/Image -> numpy array (the encodings the reference's
    nodes consume via cv_bridge)."""
    enc = msg.encoding
    H, W = int(msg.height), int(msg.width)
    buf = np.frombuffer(bytes(msg.data), dtype=np.uint8)
    if enc == "mono8":
        img = buf.reshape(H, msg.step)[:, :W]
    elif enc in ("rgb8", "bgr8"):
        rgb = buf.reshape(H, msg.step)[:, : W * 3].reshape(H, W, 3)
        if enc == "bgr8":
            rgb = rgb[:, :, ::-1]
        # ITU-R BT.601 luma; round-half-up before the cast to match OpenCV
        # cvtColor's fixed-point descale ((x + (1<<13)) >> 14), which rounds
        # to nearest — a bare astype truncates and can differ by 1 LSB
        img = (
            0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
            + 0.5
        ).astype(np.uint8)
    elif enc == "16UC1":
        dt = np.dtype(np.uint16).newbyteorder(">" if msg.is_bigendian else "<")
        img = (
            np.frombuffer(bytes(msg.data), dtype=dt)
            .reshape(H, msg.step // 2)[:, :W]
            .astype(np.uint16)
        )
    elif enc == "32FC1":
        dt = np.dtype(np.float32).newbyteorder(">" if msg.is_bigendian else "<")
        img = (
            np.frombuffer(bytes(msg.data), dtype=dt)
            .reshape(H, msg.step // 4)[:, :W]
            .astype(np.float32)
        )
    else:
        raise ValueError(f"unsupported image encoding: {enc!r}")
    return np.ascontiguousarray(img)


def _stamp_seconds(header) -> float:
    s = header.stamp
    # rospy.Time has .to_sec(); ROS2-style has .sec/.nanosec
    if hasattr(s, "to_sec"):
        return float(s.to_sec())
    return float(s.sec) + float(getattr(s, "nanosec", 0)) * 1e-9


@dataclasses.dataclass
class NodeConfig:
    """Topic configuration (the reference's Config ROS.* keys)."""

    camera_topic: str = DEFAULT_CAMERA_TOPIC
    depth_topic: str = DEFAULT_DEPTH_TOPIC
    imu_topic: str = DEFAULT_IMU_TOPIC
    base_frame: str = "world"
    camera_frame: str = "camera"
    use_image_timestamps: bool = True
    queue_size: int = 10
    slop: float = 0.02


class SDSlamNode:
    """Base node: owns a StreamRunner, subscribes per sensor type, and
    republishes each emitted odometry record.

    `ros` is any rospy-compatible module (must provide Subscriber,
    Publisher, spin); pass a stub for tests or bridges. Odometry is
    published as a plain dict unless nav_msgs is importable — the contract
    is the data, not the message class.
    """

    def __init__(self, system, sensor: str, cfg: Optional[NodeConfig] = None,
                 ros=None):
        self.cfg = cfg or NodeConfig()
        self.ros = ros
        self.runner = StreamRunner(
            system,
            sensor=sensor,
            queue_size=self.cfg.queue_size,
            slop=self.cfg.slop,
            use_image_timestamps=self.cfg.use_image_timestamps,
            odom_callback=self._publish_odometry,
        )
        self._odom_pub = None
        self._published = []  # kept for tests/bridges without a publisher

    # -- transport ---------------------------------------------------------

    def _rospy(self):
        if self.ros is not None:
            return self.ros
        try:
            import rospy  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "rospy is not installed; either run under ROS or pass a "
                "rospy-compatible transport via ros="
            ) from e
        self.ros = rospy
        return rospy

    @staticmethod
    def _msg_classes():
        """Real ROS message classes when the ROS stack is installed
        (rospy's Publisher/Subscriber REQUIRE a genpy Message subclass as
        data_class — passing None raises ValueError). Returns
        (Image, Imu, Odometry), each None when unavailable, in which case
        the transport must be an injected stub that accepts None."""
        try:
            from sensor_msgs.msg import Image as ImageCls  # type: ignore
            from sensor_msgs.msg import Imu as ImuCls  # type: ignore
        except ImportError:
            ImageCls = ImuCls = None
        try:
            from nav_msgs.msg import Odometry as OdomCls  # type: ignore
        except ImportError:
            OdomCls = None
        return ImageCls, ImuCls, OdomCls

    def start(self):
        """Subscribe to the configured topics and create the odometry
        publisher. Returns self (call `spin()` to block)."""
        ros = self._rospy()
        image_cls, imu_cls, self._odom_cls = self._msg_classes()
        self._odom_pub = ros.Publisher(ODOM_TOPIC, self._odom_cls,
                                       queue_size=10)
        ros.Subscriber(self.cfg.camera_topic, image_cls, self.on_image,
                       queue_size=self.cfg.queue_size)
        if self.runner.sensor == "rgbd":
            ros.Subscriber(self.cfg.depth_topic, image_cls, self.on_depth,
                           queue_size=self.cfg.queue_size)
        if self.runner.sensor == "fusion":
            ros.Subscriber(self.cfg.imu_topic, imu_cls, self.on_imu,
                           queue_size=200)
        return self

    def spin(self):
        self._rospy().spin()

    # -- subscriber callbacks (sensor_msgs in, stream msgs through) --------

    def on_image(self, msg):
        self.runner.push_image(
            ImageMsg(stamp=_stamp_seconds(msg.header), data=decode_image(msg),
                     frame_id=self.cfg.camera_frame)
        )

    def on_depth(self, msg):
        self.runner.push_depth(
            ImageMsg(stamp=_stamp_seconds(msg.header), data=decode_image(msg),
                     frame_id=self.cfg.camera_frame)
        )

    def on_imu(self, msg):
        av, la = msg.angular_velocity, msg.linear_acceleration
        self.runner.push_imu(
            ImuMsg(
                stamp=_stamp_seconds(msg.header),
                angular_velocity=np.array([av.x, av.y, av.z]),
                linear_acceleration=np.array([la.x, la.y, la.z]),
            )
        )

    # -- publisher ---------------------------------------------------------

    def _publish_odometry(self, odo: OdometryMsg):
        """nav_msgs/Odometry and TF equivalent: pose =
        Twc with the configured frames; stamp = image stamp or now()
        depending on use_image_timestamps (already resolved upstream).

        Publishes a real nav_msgs/Odometry when the ROS stack is installed
        (data_class wired in start()); otherwise the dict record (stub /
        bridge transports)."""
        q = odo.quaternion_xyzw
        record = {
            "stamp": odo.stamp,
            "frame_id": self.cfg.base_frame,
            "child_frame_id": self.cfg.camera_frame,
            "position": odo.position.tolist(),
            "orientation_xyzw": q.tolist(),
            "tracked": odo.tracked,
        }
        self._published.append(record)
        if self._odom_pub is None:
            return
        payload = record
        if getattr(self, "_odom_cls", None) is not None:
            msg = self._odom_cls()
            msg.header.stamp = self.ros.Time.from_sec(float(odo.stamp))
            msg.header.frame_id = self.cfg.base_frame
            msg.child_frame_id = self.cfg.camera_frame
            pos = msg.pose.pose.position
            pos.x, pos.y, pos.z = (float(v) for v in odo.position)
            ori = msg.pose.pose.orientation
            ori.x, ori.y, ori.z, ori.w = (float(v) for v in q)
            payload = msg
        self._odom_pub.publish(payload)


class MonocularNode(SDSlamNode):
    """The reference's ros_monocular node."""

    def __init__(self, system, cfg=None, ros=None):
        super().__init__(system, "monocular", cfg, ros)


class RGBDNode(SDSlamNode):
    """The reference's ros_rgbd node (approximate-time image + depth sync)."""

    def __init__(self, system, cfg=None, ros=None):
        super().__init__(system, "rgbd", cfg, ros)


class FusionNode(SDSlamNode):
    """The reference's ros_fusion node (image + IMU)."""

    def __init__(self, system, cfg=None, ros=None):
        super().__init__(system, "fusion", cfg, ros)
