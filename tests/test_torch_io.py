"""The port's data front-ends against sdslam_tpu's: TUM RGB-D, TUM
monocular and EuRoC sequences written by either package's writers read
identically by both packages' loaders; nearest-timestamp association; the
profiling helpers; and the CLI (synthetic smoke, rgbd on a sequence the
JAX writer wrote, the parts that are not ported yet, the default device).
"""

import os
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

import sdslam_tpu
from sdslam_tpu.geometry.camera import CameraModel as JCam
from sdslam_tpu.io import datasets as jds
from sdslam_tpu.io import synthetic as jsyn
from sdslam_tpu.utils import profiling as jprof
from sdslam_tpu_torch import cli
from sdslam_tpu_torch.io import datasets as tds
from sdslam_tpu_torch.system import RGBD, SDSlamSystem
from sdslam_tpu_torch.utils import config as tconfig
from sdslam_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)

# tests/test_stream.py's small camera
CAM_KW = dict(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120, bf=10.0)
N_FRAMES = 8


@pytest.fixture(scope="module")
def rendered():
    """(frames, Tcw poses) of a small orbit, rendered once by the JAX package."""
    seq = jsyn.SyntheticSequence(JCam(**CAM_KW), n_frames=N_FRAMES, trajectory="orbit",
                                 radius=0.02, yaw_amp=0.02)
    frames = [tuple(np.asarray(x) if i else x for i, x in enumerate(seq.frame(k)))
              for k in range(N_FRAMES)]
    return frames, np.asarray(seq.poses)


def _imu_rows(n, rng):
    return [(1.0 + k * 0.005, list(rng.normal(0.0, 1.0, 6))) for k in range(n)]


WRITERS = {"jax": jds, "port": tds}


def _read_text(root, *names):
    return {n: open(os.path.join(root, n)).read() for n in names}


def _numbers(text):
    return np.array([float(x) for line in text.splitlines() if not line.startswith("#")
                     for x in line.split()])


def test_writers_write_the_same_files(rendered, tmp_path):
    """Both packages' writers: the same lists and CSVs (ground truth within
    1e-6 per number) and the same PNG pixels."""
    frames, poses = rendered
    rng = np.random.default_rng(5)
    imu = _imu_rows(40, rng)
    for name, mod in WRITERS.items():
        mod.write_tum_sequence(str(tmp_path / name / "tum"), frames, poses)
        mod.write_euroc_sequence(str(tmp_path / name / "euroc"),
                                 [(ts, img) for ts, img, _ in frames], imu)
    j, t = tmp_path / "jax", tmp_path / "port"
    lists = ("rgb.txt", "depth.txt")
    assert _read_text(j / "tum", *lists) == _read_text(t / "tum", *lists)
    gj, gt = (_read_text(r / "tum", "groundtruth.txt")["groundtruth.txt"] for r in (j, t))
    assert len(gj.splitlines()) == len(gt.splitlines()) == N_FRAMES + 2
    np.testing.assert_allclose(_numbers(gt), _numbers(gj), rtol=0, atol=1e-6)
    csvs = ("mav0/cam0/data.csv", "mav0/imu0/data.csv")
    assert _read_text(j / "euroc", *csvs) == _read_text(t / "euroc", *csvs)
    pngs = sorted(p.relative_to(j) for p in j.rglob("*.png"))
    assert len(pngs) == 3 * N_FRAMES
    assert pngs == sorted(p.relative_to(t) for p in t.rglob("*.png"))
    for p in pngs:
        a, b = Image.open(j / p), Image.open(t / p)
        assert a.mode == b.mode
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("writer", list(WRITERS))
def test_tum_rgbd_loader_parity(writer, rendered, tmp_path):
    """A sequence either package wrote: association, timestamps, frames,
    the prefetched frames and the raw (u8 / u16) ingest all equal to the
    JAX loader's, bit for bit; the raw depth is the written counts."""
    frames, poses = rendered
    root = str(tmp_path / "seq")
    WRITERS[writer].write_tum_sequence(root, frames, poses)
    dj, dt = jds.TUMRGBDDataset(root), tds.TUMRGBDDataset(root)
    assert dt.assoc == dj.assoc and len(dt) == N_FRAMES
    for (tj, ij, ej), (tt, it, et) in zip(dj, dt):
        assert tt == tj
        assert it.dtype == ij.dtype and et.dtype == ej.dtype
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(et, ej)
    for raw in (False, True):
        pj = list(dj.prefetch_iter(raw=raw))
        pt = list(dt.prefetch_iter(n_threads=3, depth=2, raw=raw))
        assert len(pt) == len(pj) == N_FRAMES
        for a, b in zip(pj, pt):
            assert a[0] == b[0]
            for x, y in zip(a[1:], b[1:]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    _, img, dep = dt.raw_frame(3)
    assert img.dtype == np.uint8 and dep.dtype == np.uint16
    written = np.clip(frames[3][2] * 5000.0, 0, 65535).astype(np.uint16)
    np.testing.assert_array_equal(dep, written)


@pytest.mark.parametrize("writer", list(WRITERS))
def test_euroc_and_mono_loader_parity(writer, rendered, tmp_path):
    """EuRoC (frames, timestamps, IMU rows, imu_between) and TUM monocular
    (an rgb.txt list and a bare image folder) equal to the JAX loaders'."""
    frames, poses = rendered
    rng = np.random.default_rng(7)
    root = str(tmp_path / "euroc")
    WRITERS[writer].write_euroc_sequence(root, [(ts + 1.0, img) for ts, img, _ in frames],
                                         _imu_rows(60, rng))
    ej, et = jds.EuRoCDataset(root), tds.EuRoCDataset(root)
    assert et.items == ej.items and et.imu == ej.imu and len(et) == N_FRAMES
    for (tj, ij), (tt, it) in zip(ej, et):
        assert tt == tj and it.dtype == ij.dtype
        np.testing.assert_array_equal(it, ij)
    for k in range(1, N_FRAMES):
        t0, t1 = et.items[k - 1][0], et.items[k][0]
        assert et.imu_between(t0, t1) == ej.imu_between(t0, t1)
    assert len(et.imu_between(1.0, 1.1)) == 20

    tum = str(tmp_path / "tum")
    WRITERS[writer].write_tum_sequence(tum, frames, poses)
    folder = os.path.join(tum, "rgb")
    for path in (tum, folder):
        mj, mt = jds.TUMMonoDataset(path), tds.TUMMonoDataset(path)
        assert mt.items == mj.items and len(mt) == N_FRAMES
        for (tj, ij), (tt, it) in zip(mj, mt):
            assert tt == tj
            np.testing.assert_array_equal(it, ij)


def _jax_python_associate(monkeypatch):
    """The JAX package's pure-Python association (its C extension hidden)."""
    monkeypatch.setitem(sys.modules, "sdslam_tpu._native", None)
    monkeypatch.delattr(sdslam_tpu, "_native", raising=False)
    return jds.associate


@pytest.mark.parametrize("seed", range(4))
def test_associate_parity(seed, monkeypatch):
    """Jittered 30 Hz stamp lists with an offset, duplicated stamps and gaps:
    the port pairs exactly as the JAX package's Python association (the
    reference's associate.py semantics, which the port carries)."""
    rng = np.random.default_rng(seed)
    n = 80
    ta = 1000.0 + np.arange(n) / 30.0 + rng.normal(0.0, 0.004, n)
    tb = 1000.0 + np.arange(n) / 30.0 + 0.005 + rng.normal(0.0, 0.004, n)
    a = [(float(np.round(t, 6)), f"rgb/{i}.png") for i, t in enumerate(ta)]
    b = [(float(np.round(t, 6)), f"depth/{i}.png") for i, t in enumerate(tb)]
    for k in rng.choice(n, 5, replace=False):  # duplicated stamps
        a.insert(int(k), (a[int(k)][0], f"rgb/dup{k}.png"))
    b = [x for x in b if rng.uniform() > 0.1]  # dropped depth frames
    offset = (0.0, -0.005, -0.012, 0.003)[seed]
    for max_diff in (0.02, 0.01):
        port = tds.associate(a, b, max_difference=max_diff, offset=offset)
        assert port == _jax_python_associate(monkeypatch)(a, b, max_diff, offset)
        assert len(port) > n // 4


def test_associate_matches_native_on_separated_stamps():
    """Where each stamp has one partner in range, the port also equals the
    JAX package's C association (tests/test_io.py's cases)."""
    a = [(1.0, "a0"), (2.0, "a1"), (3.0, "a2"), (4.0, "a3")]
    b = [(1.009, "b0"), (2.5, "bx"), (3.001, "b2"), (4.019, "b3")]
    out = tds.associate(a, b, max_difference=0.02)
    assert out == jds.associate(a, b, max_difference=0.02)
    assert [(x[1], x[3]) for x in out] == [("a0", "b0"), ("a2", "b2"), ("a3", "b3")]


def test_profiling_helpers_match(monkeypatch, tmp_path):
    """StageTimes and FrameMetrics give the JAX package's summaries on the
    same recorded durations; Timer measures; device_trace(None) is a no-op
    and a path gets a Chrome trace."""
    rng = np.random.default_rng(3)
    durations = [(("orb", "track", "kf")[k % 3], float(rng.uniform(1e-4, 2e-2)))
                 for k in range(30)]
    summaries = []
    for mod in (jprof, tprof):
        clock = iter(np.cumsum([0.0] + [d for _, d in durations for d in (d, 0.0)]))
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
        st = mod.StageTimes()
        for name, _ in durations:
            with st.stage(name):
                pass
        fm = mod.FrameMetrics()
        for k, (name, d) in enumerate(durations):
            fm.record(frame=k, stage=name, ms=d * 1e3)
        path = tmp_path / f"{mod.__name__}.jsonl"
        fm.save_jsonl(str(path))
        summaries.append((st.summary(), st.report(), fm.column("ms"), path.read_text()))
    monkeypatch.undo()
    assert summaries[0] == summaries[1]
    assert set(summaries[1][0]) == {"orb", "track", "kf"}
    t = tprof.Timer(start=True)
    time.sleep(0.01)
    assert t.stop() >= 10.0
    with tprof.device_trace(None):
        torch.ones(3).sum()
    assert not any(tmp_path.glob("**/trace.json"))
    with tprof.device_trace(str(tmp_path / "trace")):
        torch.ones(3).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_cli_synthetic_smoke(tmp_path):
    """tests/test_io.py::test_cli_synthetic_smoke on the port, on the CPU."""
    traj, mp = str(tmp_path / "traj.txt"), str(tmp_path / "map.npz")
    cli.main(["synthetic", "--frames", "6", "--device", "cpu", "--traj-out", traj,
              "--save-map", mp])
    assert len(open(traj).read().strip().splitlines()) == 6
    assert os.path.exists(mp)


def _config_yaml(path):
    """A reference-keys config for the small camera: 256 keypoints, 3
    levels, 16 keyframe slots, 2048 points, TUM's 5000 depth counts/m."""
    c = CAM_KW
    keys = {"Camera.fx": c["fx"], "Camera.fy": c["fy"], "Camera.cx": c["cx"],
            "Camera.cy": c["cy"], "Camera.Width": c["width"], "Camera.Height": c["height"],
            "Camera.bf": c["bf"], "Camera.fps": 30.0, "ORBextractor.nFeatures": 256,
            "ORBextractor.nLevels": 3, "ORBextractor.scaleFactor": 2.0, "ThDepth": 40.0,
            "DepthMapFactor": 5000.0, "Map.MaxKeyframes": 16, "Map.MaxPoints": 2048}
    with open(path, "w") as f:
        f.write("%YAML:1.0\n" + "".join(f"{k}: {v}\n" for k, v in keys.items()))
    return path


def test_cli_rgbd_on_jax_written_sequence(rendered, tmp_path):
    """`rgbd` on a sequence the JAX writer wrote gives the trajectory (within
    1e-6 per number) of the port's facade fed the loader's frames
    directly, and saves a map that loads."""
    frames, poses = rendered
    root = str(tmp_path / "seq")
    jds.write_tum_sequence(root, frames, poses)
    cfg_path = _config_yaml(str(tmp_path / "cam.yaml"))
    traj, mp = str(tmp_path / "cli.txt"), str(tmp_path / "map.npz")
    cli.main(["rgbd", cfg_path, root, "--device", "cpu", "--no-loop-closing",
              "--traj-out", traj, "--save-map", mp])

    cfg = tconfig.load_config(cfg_path)
    direct = SDSlamSystem(cfg, sensor=RGBD, loop_closing=False, device="cpu")
    ds = tds.TUMRGBDDataset(root, depth_factor=cfg.tracking.depth_map_factor)
    for i in range(len(ds)):
        ts, img, dep = ds.raw_frame(i)
        direct.track_rgbd(img, dep, ts)
    direct.finish()
    assert direct.get_tracking_state() == "OK"
    ref = str(tmp_path / "direct.txt")
    direct.save_trajectory_tum(ref)
    got, want = open(traj).read(), open(ref).read()
    assert len(got.strip().splitlines()) == N_FRAMES
    np.testing.assert_allclose(_numbers(got), _numbers(want), rtol=0, atol=1e-6)
    fresh = SDSlamSystem(cfg, sensor=RGBD, device="cpu")
    fresh.load_map(mp)
    assert int(fresh.tracker.ms.n_points()) == int(direct.tracker.ms.n_points())


@pytest.mark.parametrize("case", ["dev_video", "viewer_port", "calibration", "default_device"])
def test_cli_unported_parts_and_default_device(case, tmp_path, monkeypatch, capsys):
    """The parts the CLI once left unported now run: live capture opens the
    V4L2 device (a missing one raises OSError), the live viewer serves and
    prints its URL, calibration reads the image folder (an empty one
    exits naming it); without a card the default --device cuda raises."""
    cfg_path = _config_yaml(str(tmp_path / "cam.yaml"))
    traj = ["--traj-out", str(tmp_path / "t.txt")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if case == "viewer_port":
        cli.main(["synthetic", "--frames", "2", "--device", "cpu", "--viewer-port", "0"] + traj)
        assert "live viewer at http://127.0.0.1:" in capsys.readouterr().out
        assert len(open(tmp_path / "t.txt").read().strip().splitlines()) == 2
        return
    argv, err, match = {
        "dev_video": (["monocular", cfg_path, "/dev/video_missing", "--device", "cpu"] + traj,
                      OSError, "video_missing"),
        "calibration": (["calibration", str(tmp_path / "views")], SystemExit, "no images"),
        "default_device": (["synthetic", "--frames", "2"] + traj, RuntimeError,
                           "CUDA is not available"),
    }[case]
    (tmp_path / "views").mkdir()
    with pytest.raises(err, match=match):
        cli.main(argv)