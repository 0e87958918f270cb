"""The device front-ends: the port's io/camera.py and io/ros_nodes.py
against sdslam_tpu's (conversions, ioctl ABI, image decoding, node wiring
with tests/test_ros_nodes.py's stubs), an RGBDNode over a CPU
SDSlamSystem, and the CLI with its live viewer."""

import contextlib
import io
import re
import urllib.request

import numpy as np
import pytest
import torch

from sdslam_tpu.io import camera as jcamera
from sdslam_tpu.io import ros_nodes as jrn
from sdslam_tpu_torch import cli
from sdslam_tpu_torch.geometry.camera import CameraModel as TCam
from sdslam_tpu_torch.io import camera as tcamera
from sdslam_tpu_torch.io import ros_nodes as trn
from sdslam_tpu_torch.io import synthetic as tsyn
from sdslam_tpu_torch.system import RGBD, SDSlamSystem
from sdslam_tpu_torch.utils.config import MapConfig, ORBConfig, SystemConfig
from test_ros_nodes import _FakeRospy, _FakeSystem, _ImageMsg, _ImuRosMsg

torch.set_num_threads(2)

ABI = ["VIDIOC_QUERYCAP", "VIDIOC_S_FMT", "VIDIOC_REQBUFS", "VIDIOC_QUERYBUF", "VIDIOC_QBUF",
       "VIDIOC_DQBUF", "VIDIOC_STREAMON", "VIDIOC_STREAMOFF", "V4L2_BUF_TYPE_VIDEO_CAPTURE",
       "V4L2_MEMORY_MMAP", "V4L2_FIELD_NONE", "PIX_GREY", "PIX_YUYV", "PIX_MJPG"]


@pytest.mark.parametrize("name", ABI)
def test_v4l2_abi(name):
    assert getattr(tcamera, name) == getattr(jcamera, name)


def test_frame_conversions():
    rng = np.random.default_rng(31)
    w, h = 16, 6
    buf = rng.integers(0, 256, h * w * 2, dtype=np.uint8).tobytes()
    np.testing.assert_array_equal(tcamera.yuyv_to_gray(buf, w, h), jcamera.yuyv_to_gray(buf, w, h))
    from PIL import Image

    img = rng.uniform(0, 255, (32, 48)).astype(np.uint8)
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", quality=90)
    np.testing.assert_array_equal(tcamera.mjpg_to_gray(b.getvalue()),
                                  jcamera.mjpg_to_gray(b.getvalue()))


def test_v4l2_camera_without_device(tmp_path):
    with pytest.raises(OSError):
        tcamera.V4L2Camera(str(tmp_path / "video9"))


def _msg(arr, enc, big=False, pad=0):
    """A sensor_msgs/Image with `pad` bytes of row padding."""
    a = arr.astype(arr.dtype.newbyteorder(">" if big else "<"))
    rows = a.reshape(a.shape[0], -1).view(np.uint8)
    rows = np.concatenate([rows, np.zeros((rows.shape[0], pad), np.uint8)], 1)
    m = _ImageMsg(1.0, rows, enc)
    m.width, m.is_bigendian = arr.shape[1], big
    return m


@pytest.mark.parametrize("enc,big", [("mono8", False), ("rgb8", False), ("bgr8", False),
                                     ("16UC1", False), ("16UC1", True), ("32FC1", False),
                                     ("32FC1", True)])
def test_decode_image(enc, big):
    rng = np.random.default_rng(32)
    arr = {"mono8": rng.integers(0, 256, (7, 9), dtype=np.uint8),
           "rgb8": rng.integers(0, 256, (7, 9, 3), dtype=np.uint8),
           "bgr8": rng.integers(0, 256, (7, 9, 3), dtype=np.uint8),
           "16UC1": rng.integers(0, 65535, (7, 9)).astype(np.uint16),
           "32FC1": rng.random((7, 9)).astype(np.float32)}[enc]
    m = _msg(arr, enc, big, pad=4)
    a, b = jrn.decode_image(m), trn.decode_image(m)
    assert a.dtype == b.dtype and a.shape == b.shape == (7, 9)
    np.testing.assert_array_equal(a, b)
    if enc in ("mono8", "16UC1", "32FC1"):
        np.testing.assert_array_equal(b, arr)
    m.encoding = "yuv422"
    with pytest.raises(ValueError):
        trn.decode_image(m)


def _drive(mod, node_cls, sensor):
    """Feed one stubbed node three frames (and IMU samples); returns the
    system's calls and the published records."""
    ros, sys_ = _FakeRospy(), _FakeSystem()
    cfg = mod.NodeConfig(camera_topic="/cam0", base_frame="map")
    node = getattr(mod, node_cls)(sys_, cfg=cfg, ros=ros).start()
    g = np.arange(48, dtype=np.uint8).reshape(8, 6)
    d = (np.arange(48) * 40).astype(np.uint16).reshape(8, 6)
    for k in range(3):
        t = 100.0 + 0.1 * k
        if sensor == "fusion":
            ros.subs[mod.DEFAULT_IMU_TOPIC](_ImuRosMsg(t - 0.01, (0.1 * k, 0.2, 0.3),
                                                       (1.0, 2.0, 9.8)))
        ros.subs["/cam0"](_ImageMsg(t, g, "mono8"))
        if sensor == "rgbd":
            ros.subs[mod.DEFAULT_DEPTH_TOPIC](_ImageMsg(t + 0.004, d, "16UC1"))
    return sorted(ros.subs), sys_.calls, ros.pubs[mod.ODOM_TOPIC].msgs, node


@pytest.mark.parametrize("node_cls,sensor", [("MonocularNode", "mono"), ("RGBDNode", "rgbd"),
                                             ("FusionNode", "fusion")])
def test_node_wiring(node_cls, sensor):
    ja, tb = _drive(jrn, node_cls, sensor), _drive(trn, node_cls, sensor)
    assert ja[0] == tb[0]  # the same topics
    assert ja[1] == tb[1] and len(tb[1]) == 3
    assert ja[2] == tb[2] and len(tb[2]) == 3
    assert tb[2][0]["frame_id"] == "map" and np.allclose(tb[2][0]["position"], [0, 0, -2])


def test_rgbd_node_over_cpu_system():
    """Three frames through an RGBDNode (depth 4 ms late) into a CPU
    SDSlamSystem: the published positions are the tracker's camera
    centres."""
    cam = TCam(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320, height=240, bf=32.0)
    cfg = SystemConfig(camera=cam, orb=ORBConfig(max_keypoints=256, n_levels=3),
                       map=MapConfig(max_keyframes=8, max_points=2048, max_kps_per_frame=256))
    seq = tsyn.SyntheticSequence(cam, n_frames=16, trajectory="orbit", radius=0.06,
                                 yaw_amp=0.04, device="cpu")
    sysm = SDSlamSystem(cfg, sensor=RGBD, loop_closing=False, device="cpu")
    ros = _FakeRospy()
    node = trn.RGBDNode(sysm, ros=ros).start()
    for i in range(3):
        ts, img, dep = seq.frame(i)
        node.on_image(_ImageMsg(ts, img.numpy().astype(np.uint8), "mono8"))
        node.on_depth(_ImageMsg(ts + 0.004, (dep.numpy() * 1000).astype(np.uint16), "16UC1"))
    sysm.finish()
    pub = ros.pubs[trn.ODOM_TOPIC].msgs
    assert len(pub) == 3 and sysm.get_tracking_state() == "OK"
    traj = [np.asarray(T, np.float64) for T in sysm.tracker.trajectory]
    for rec, T in zip(pub, traj):
        np.testing.assert_allclose(rec["position"], -T[:3, :3].T @ T[:3, 3], atol=1e-6)
    assert [r["stamp"] for r in pub] == [seq.timestamps[i] for i in range(3)]


def test_cli_viewer_port(tmp_path):
    """`synthetic --viewer-port 0` prints the viewer's URL, serves it while
    tracking and writes one trajectory line per frame."""
    traj = str(tmp_path / "traj.txt")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        cli.main(["synthetic", "--frames", "3", "--device", "cpu", "--viewer-port", "0",
                  "--traj-out", traj])
    m = re.search(r"live viewer at (http://127\.0\.0\.1:\d+)", log.getvalue())
    assert m is not None
    assert len(open(traj).read().strip().splitlines()) == 3
    with pytest.raises(OSError):  # stopped with the run
        urllib.request.urlopen(m.group(1) + "/status.json", timeout=2)
