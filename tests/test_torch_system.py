"""The slice as a whole: the port's SDSlamSystem (RGB-D, loop closing on)
against sdslam_tpu's on a 16-frame orbit at test size; the persistence of
both facades on the map that run built (the npz map, the TUM trajectory
and the reference's YAML map, each written by one package and read by
the other); the sensors the facade builds (monocular by default, as in the
JAX package); and the entry points' default device: they run on the card
unless the caller asks for the CPU, and without a card the default raises.
"""

import re

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from sdslam_tpu import system as jsystem
from sdslam_tpu.io import synthetic as jsyn
from sdslam_tpu_torch import interop
from sdslam_tpu_torch import system as tsystem
from sdslam_tpu_torch.io import synthetic as tsyn
from sdslam_tpu_torch.mapping import map_state as TM
from sdslam_tpu_torch.pipeline import sensors as tsensors
from sdslam_tpu_torch.pipeline.tracking import MonoTracker, RGBDTracker
from sdslam_tpu_torch.utils import metrics
from test_torch_relocalization import JCAM, ORBIT, TCAM, jax_cfg, np_tree, port_cfg

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def facades():
    """Both facades after the 16-frame orbit (one JAX tracker compile for
    every test of this file), and the frames."""
    seq = jsyn.SyntheticSequence(JCAM, **ORBIT)
    frames = [seq.frame(i) for i in range(len(seq))]
    sj = jsystem.SDSlamSystem(jax_cfg(), sensor=jsystem.RGBD, loop_closing=True)
    st = tsystem.SDSlamSystem(port_cfg(), sensor=tsystem.RGBD, loop_closing=True, device="cpu")
    for ts, img, depth in frames:
        sj.track_rgbd(img, depth, ts)
        st.track_rgbd(np.array(img), np.array(depth), ts)
    sj.finish()
    st.finish()
    return dict(seq=seq, frames=frames, sj=sj, st=st, jmap=np_tree(sj.tracker.ms))


def port_holding(jmap):
    """A fresh port facade whose map is the JAX map's values."""
    sysm = tsystem.SDSlamSystem(port_cfg(), sensor=tsystem.RGBD, device="cpu")
    sysm.tracker.ms = interop.map_state_from_numpy(jmap, device="cpu")
    return sysm


def test_sdslam_system_rgbd_parity(facades):
    """16 frames through track_rgbd on both facades: status OK, the port's
    trajectory within 1e-3 m (and 5e-3 in rotation entries) of JAX's, the
    same keyframe count, and the ATE gate of tests/test_odometry.py."""
    seq, sj, st = facades["seq"], facades["sj"], facades["st"]
    assert st.get_tracking_state() == sj.get_tracking_state() == "OK"
    ej = np.stack([np.asarray(p) for p in sj.tracker.trajectory])
    et = np.stack([np.asarray(p) for p in st.tracker.trajectory])
    assert np.abs(et[:, :3, 3] - ej[:, :3, 3]).max() < 1e-3
    assert np.abs(et[:, :3, :3] - ej[:, :3, :3]).max() < 5e-3
    assert st.map_changed() == sj.map_changed()
    assert metrics.ate_rmse(et, np.asarray(seq.poses), align=False) < 0.02


def test_sensor_type_enforced():
    """tests/test_system.py's case: a frame of another sensor raises, and
    so does an unknown sensor."""
    sysm = tsystem.SDSlamSystem(port_cfg(), sensor=tsystem.MONOCULAR, device="cpu")
    with pytest.raises(AssertionError):
        sysm.track_rgbd(np.zeros((240, 320)), np.zeros((240, 320)), 0.0)
    with pytest.raises(ValueError):
        tsystem.SDSlamSystem(port_cfg(), sensor="stereo", device="cpu")


def test_default_sensor_is_monocular():
    """The JAX package's facade defaults to the monocular sensor; so does
    the port's, and every sensor builds."""
    assert isinstance(tsystem.SDSlamSystem(port_cfg(), device="cpu").tracker, MonoTracker)
    assert jsystem.SDSlamSystem.__init__.__defaults__[0] == tsystem.MONOCULAR
    for sensor, tracker in ((tsystem.RGBD, RGBDTracker), (tsystem.MONOCULAR, MonoTracker),
                            (tsystem.MONOCULAR_IMU, MonoTracker)):
        sysm = tsystem.SDSlamSystem(port_cfg(), sensor=sensor, device="cpu")
        assert type(sysm.tracker) is tracker
        assert sysm.loop_closer.fix_scale == (sensor == tsystem.RGBD)
        assert (sysm.imu is not None) == (sensor == tsystem.MONOCULAR_IMU)


@pytest.mark.parametrize("entry", ["RGBDTracker", "SDSlamSystem", "init_map",
                                   "SyntheticSequence", "map_state_from_numpy", "ekf_init",
                                   "imu_init"])
def test_default_device_needs_cuda(entry, monkeypatch):
    """On a machine without CUDA, an entry point called without a device
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "RGBDTracker": lambda: RGBDTracker(port_cfg()),
        "SDSlamSystem": lambda: tsystem.SDSlamSystem(port_cfg()),
        "init_map": lambda: TM.init_map(4, 16, 8, ((12, 16),)),
        "SyntheticSequence": lambda: tsyn.SyntheticSequence(TCAM, n_frames=2),
        "map_state_from_numpy": lambda: interop.map_state_from_numpy(
            interop.map_state_to_numpy(TM.init_map(4, 16, 8, ((12, 16),), device="cpu"))),
        "ekf_init": lambda: tsensors.ekf_init(),
        "imu_init": lambda: tsensors.imu_init(),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


# -- persistence ----------------------------------------------------------------


def test_npz_map_across_packages(facades, tmp_path):
    """The same map (the JAX run's, carried into a port facade) saved by
    both facades: the same keys, shapes, dtypes and values. The port's
    load_map of the JAX file equals map_state_from_numpy of it exactly and
    leaves the tracker LOST; the JAX load_map of the port's file equals the
    JAX map exactly; a checkpoint without loop edges gets the default. Then
    tests/test_system.py::test_map_save_load_localization's gates on the
    port: frames 4-6 relocalize to OK in localization mode, keyframes
    unchanged."""
    jmap = facades["jmap"]
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    facades["sj"].save_map(pj)
    port_holding(jmap).save_map(pt)
    with np.load(pj) as a, np.load(pt) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "kf_pyramid_0" in a.files and "kf_pyramid" not in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert b["kf_desc"].dtype == np.uint32
        fields = {k: a[k] for k in a.files}
    fields["kf_pyramid"] = [fields.pop(f"kf_pyramid_{i}") for i in range(len(jmap["kf_pyramid"]))]

    fresh = tsystem.SDSlamSystem(port_cfg(), sensor=tsystem.RGBD, device="cpu")
    fresh.load_map(pj)
    ref = interop.map_state_from_numpy(fields, device="cpu")
    for name, got, want in zip(ref._fields, fresh.tracker.ms, ref):
        for g, w in zip(got, want) if name == "kf_pyramid" else ((got, want),):
            assert g.dtype == w.dtype and torch.equal(g, w), name
    assert fresh.get_tracking_state() == "LOST"
    assert fresh.tracker.st.last_kf_slot == int(np.flatnonzero(jmap["kf_valid"])[-1])
    np.testing.assert_array_equal(fresh.tracker.st.T_last, np.eye(4))

    back = jsystem.SDSlamSystem(jax_cfg(), sensor=jsystem.RGBD)
    back.load_map(pt)
    got = np_tree(back.tracker.ms)
    for name in jmap:
        for g, w in zip(got[name], jmap[name]) if name == "kf_pyramid" else \
                ((got[name], jmap[name]),):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)

    old = str(tmp_path / "old.npz")
    with np.load(pt) as b:
        np.savez(old, **{k: b[k] for k in b.files if k != "loop_edges"})
    legacy = tsystem.SDSlamSystem(port_cfg(), sensor=tsystem.RGBD, device="cpu")
    legacy.load_map(old)
    assert torch.equal(legacy.tracker.ms.loop_edges, torch.full((32, 2), -1, dtype=torch.int32))

    fresh.activate_localization_mode()
    kf_before = int(fresh.tracker.ms.n_keyframes())
    for i in (4, 5, 6):
        ts, img, depth = facades["frames"][i]
        fresh.track_rgbd(np.array(img), np.array(depth), 100.0 + i * 0.03)
    assert fresh.get_tracking_state() == "OK"
    assert int(fresh.tracker.ms.n_keyframes()) == kf_before


def _tum_numbers(path):
    return np.array([[float(x) for x in line.split()] for line in open(path)])


def test_tum_trajectory_text_parity(facades, tmp_path):
    """The same trajectory list (the JAX run's poses and stamps) gives the
    same TUM text from both facades, within 1e-6 per number."""
    sj = facades["sj"]
    sp = tsystem.SDSlamSystem(port_cfg(), sensor=tsystem.RGBD, device="cpu")
    sp.tracker.trajectory = [np.array(p) for p in sj.tracker.trajectory]
    sp.tracker.timestamps = list(sj.tracker.timestamps)
    pj, pt = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    sj.save_trajectory_tum(pj)
    sp.save_trajectory_tum(pt)
    a, b = _tum_numbers(pj), _tum_numbers(pt)
    assert a.shape == b.shape == (len(facades["frames"]), 8)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    assert np.abs((b[:, 4:] ** 2).sum(1) - 1.0).max() < 1e-3


_NUMBER = re.compile(r"^(\s*(?:- )?(?:\w+: )?)(-?\d+\.\d+)$")


def test_yaml_map_writers_agree(facades, tmp_path):
    """The same map gives the same YAML from both writers: equal lines but
    for the PNG folder, numbers within 1e-6, and the same keyframe PNGs
    pixel for pixel (PIL's bilinear upscale in both)."""
    jmap = facades["jmap"]
    yj, yt = tmp_path / "jax.yaml", tmp_path / "port.yaml"
    facades["sj"].save_trajectory(str(yj), str(tmp_path / "jax_images"))
    port_holding(jmap).save_trajectory(str(yt), str(tmp_path / "port_images"))
    lj, lt = yj.read_text().splitlines(), yt.read_text().splitlines()
    assert len(lj) == len(lt) and lj[0] == "%YAML:1.0"
    n_numbers = 0
    for a, b in zip(lj, lt):
        if "filename:" in a:
            assert a.replace("jax_images", "port_images") == b
            continue
        ma, mb = _NUMBER.match(a), _NUMBER.match(b)
        if ma is None:
            assert a == b
            continue
        assert mb is not None and ma.group(1) == mb.group(1), (a, b)
        assert abs(float(ma.group(2)) - float(mb.group(2))) <= 1e-6 + 1e-12, (a, b)
        n_numbers += 1
    assert n_numbers > 1000
    n_kf = int(jmap["kf_valid"].sum())
    pngs = sorted(p.name for p in (tmp_path / "jax_images").glob("*.png"))
    assert len(pngs) == n_kf
    for name in pngs:
        a = np.asarray(Image.open(tmp_path / "jax_images" / name))
        b = np.asarray(Image.open(tmp_path / "port_images" / name))
        assert a.shape == (TCAM.height, TCAM.width)
        np.testing.assert_array_equal(b, a)


def test_yaml_map_written_by_jax_loads_into_port(facades, tmp_path):
    """tests/test_map_yaml.py's round trip across packages: the port's
    load_trajectory of the JAX-written YAML restores the keyframe count,
    the poses within 1e-3 and more than 50 linked points, leaves the
    tracker LOST, and relocalizes from frame 5 as that test requires."""
    jmap = facades["jmap"]
    path = str(tmp_path / "map.yaml")
    facades["sj"].save_trajectory(path, str(tmp_path / "images"))
    with open(path) as f:
        data = yaml.safe_load(re.sub(r"^%YAML.*$", "", f.read(), flags=re.M))
    assert len(data["keyframes"]) == int(jmap["kf_valid"].sum())

    sysm = tsystem.SDSlamSystem(port_cfg(), sensor=tsystem.RGBD, loop_closing=False,
                                device="cpu")
    assert sysm.load_trajectory(path)
    ms = sysm.tracker.ms
    assert int(ms.kf_valid.sum()) == int(jmap["kf_valid"].sum())
    assert sysm.tracker.st.status == "LOST"
    want = {int(f): T for f, T, v in zip(jmap["kf_frame_id"], jmap["kf_Tcw"], jmap["kf_valid"])
            if v}
    for f, T, v in zip(ms.kf_frame_id.numpy(), ms.kf_Tcw.numpy(), ms.kf_valid.numpy()):
        if v:
            np.testing.assert_allclose(T, want[int(f)], atol=1e-3)
    assert int(ms.pt_valid.sum()) > 50

    ts, img, depth = facades["frames"][5]
    pose = sysm.track_rgbd(np.array(img), np.array(depth), ts)
    sysm.tracker.flush()
    if sysm.tracker.st.status == "OK":
        gt = np.asarray(facades["seq"].poses[5])
        assert np.linalg.norm(np.asarray(pose)[:3, 3] - gt[:3, 3]) < 0.1
