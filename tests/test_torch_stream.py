"""The port's streaming front-end against sdslam_tpu's: approximate-time
pairing and IMU association on seeded message streams, odometry records,
and the StreamRunner driving the port's RGB-D facade on the CPU (the
cases of tests/test_stream.py).
"""

import numpy as np
import pytest
import torch

from sdslam_tpu.io import stream as jstream
from sdslam_tpu_torch.geometry.camera import CameraModel
from sdslam_tpu_torch.io import stream as tstream
from sdslam_tpu_torch.io.synthetic import SyntheticSequence
from sdslam_tpu_torch.system import RGBD, SDSlamSystem
from sdslam_tpu_torch.utils.config import MapConfig, ORBConfig, SystemConfig

torch.set_num_threads(2)


def _stream_events(seed):
    """An interleaved push order of two jittered streams (30 Hz images,
    depth with a lag, dropped and repeated messages)."""
    rng = np.random.default_rng(seed)
    events = []
    for k in range(60):
        t = k / 30.0 + rng.normal(0.0, 0.003)
        if rng.uniform() > 0.1:
            events.append((t, "a", t))
        if rng.uniform() > 0.15:
            tb = t + 0.006 + rng.normal(0.0, 0.006)
            events.append((tb + rng.uniform(0.0, 0.05), "b", tb))  # arrives late
        if rng.uniform() < 0.05:
            events.append((t + 0.001, "a", t + 0.001))
    events.sort(key=lambda e: e[0])
    return [(side, stamp) for _, side, stamp in events]


@pytest.mark.parametrize("seed,queue,slop", [(0, 10, 0.02), (1, 3, 0.01), (2, 5, 0.005),
                                             (3, 10, 0.0)])
def test_approximate_time_sync_parity(seed, queue, slop):
    """Both packages' ApproximateTimeSync emit the same pairs, in order."""
    events = _stream_events(seed)
    out = {}
    for name, mod in (("jax", jstream), ("port", tstream)):
        pairs = []
        sync = mod.ApproximateTimeSync(lambda a, b: pairs.append((a.stamp, b.stamp)),
                                       queue_size=queue, slop=slop)
        for side, stamp in events:
            msg = mod.ImageMsg(stamp, np.zeros((2, 2), np.uint8))
            (sync.push_a if side == "a" else sync.push_b)(msg)
        out[name] = pairs
    assert out["port"] == out["jax"]
    assert all(abs(a - b) <= slop for a, b in out["port"])
    if slop > 0:
        assert len(out["port"]) > 10


@pytest.mark.parametrize("seed", range(3))
def test_associate_imu_to_frames_parity(seed):
    """The same IMU sample for every frame, including frames outside the IMU
    stream's span and an empty stream."""
    rng = np.random.default_rng(seed)
    stamps = np.sort(rng.uniform(-0.1, 2.1, 40))
    out = {}
    for name, mod in (("jax", jstream), ("port", tstream)):
        imu = [mod.ImuMsg(float(t), rng.normal(size=3), rng.normal(size=3))
               for t in np.arange(0.0, 2.0, 0.005)]
        got = mod.associate_imu_to_frames(list(stamps), imu)
        out[name] = [m.stamp for m in got]
        assert mod.associate_imu_to_frames(list(stamps), []) == [None] * len(stamps)
    assert out["port"] == out["jax"]


def test_odometry_msg_fields():
    """Position and the xyzw quaternion of random poses as the JAX package
    gives them (1e-6)."""
    rng = np.random.default_rng(4)
    for _ in range(8):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        Twc = np.eye(4)
        Twc[:3, :3], Twc[:3, 3] = R, rng.normal(size=3)
        oj = jstream.OdometryMsg(stamp=1.5, Twc=Twc, tracked=True)
        ot = tstream.OdometryMsg(stamp=1.5, Twc=Twc, tracked=True)
        np.testing.assert_array_equal(ot.position, oj.position)
        np.testing.assert_allclose(ot.quaternion_xyzw, np.asarray(oj.quaternion_xyzw),
                                   rtol=0, atol=1e-6)
    ident = tstream.OdometryMsg(stamp=0.0, Twc=np.eye(4), tracked=True)
    np.testing.assert_allclose(ident.quaternion_xyzw, [0, 0, 0, 1], atol=1e-6)


def _small_cfg():
    cam = CameraModel(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120, bf=10.0)
    return SystemConfig(camera=cam, orb=ORBConfig(max_keypoints=256, n_levels=3),
                        map=MapConfig(max_keyframes=8, max_points=1024, max_kps_per_frame=256))


def test_stream_runner_rgbd(tmp_path):
    """tests/test_stream.py's runner case on the port: depth 2 ms behind each
    image, one odometry record per frame at the image's stamp, each the
    inverse of the facade's drained pose of that frame (the record is made
    from the pose the step returned, before the drain); an 8-field TUM
    file."""
    cfg = _small_cfg()
    seq = SyntheticSequence(cfg.camera, n_frames=6, trajectory="orbit", radius=0.04,
                            device="cpu")
    frames = [seq.frame(i) for i in range(6)]
    sysm = SDSlamSystem(cfg, sensor=RGBD, loop_closing=False, device="cpu")
    runner = tstream.StreamRunner(sysm, sensor="rgbd", slop=0.02)
    for ts, img, depth in frames:
        runner.push_image(tstream.ImageMsg(ts, img.numpy().astype(np.uint8)))
        runner.push_depth(tstream.ImageMsg(ts + 0.002, depth.numpy()))
    sysm.tracker.flush()
    assert len(runner.odometry) == 6
    for o, Tcw, (ts, _, _) in zip(runner.odometry, sysm.tracker.trajectory, frames):
        assert o.stamp == ts
        np.testing.assert_allclose(o.Twc, np.linalg.inv(np.asarray(Tcw, np.float64)),
                                   rtol=0, atol=1e-5)
    path = tmp_path / "odo.txt"
    runner.write_tum_trajectory(str(path))
    lines = path.read_text().strip().splitlines()
    assert len(lines) == 6 and all(len(line.split()) == 8 for line in lines)
    with pytest.raises(ValueError):
        tstream.StreamRunner(sysm, sensor="monocular").push_depth(runner.odometry[0])
