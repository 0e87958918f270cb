"""The slice as a whole: the port's SDSlamSystem (RGB-D, loop closing on)
against sdslam_tpu's on a 16-frame orbit at test size; the sensors the
facade builds (monocular by default, as in the JAX package); and the
entry points' default device: they run on the card unless the caller asks
for the CPU, and without a card the default raises.
"""

import numpy as np
import pytest
import torch

from sdslam_tpu import system as jsystem
from sdslam_tpu.io import synthetic as jsyn
from sdslam_tpu_torch import system as tsystem
from sdslam_tpu_torch.io import synthetic as tsyn
from sdslam_tpu_torch.mapping import map_state as TM
from sdslam_tpu_torch.pipeline.tracking import MonoTracker, RGBDTracker
from sdslam_tpu_torch.utils import metrics
from test_torch_relocalization import JCAM, ORBIT, TCAM, jax_cfg, port_cfg

torch.set_num_threads(2)


def test_sdslam_system_rgbd_parity():
    """16 frames through track_rgbd on both facades: status OK, the port's
    trajectory within 1e-3 m (and 5e-3 in rotation entries) of JAX's, the
    same keyframe count, and the ATE gate of tests/test_odometry.py."""
    seq = jsyn.SyntheticSequence(JCAM, **ORBIT)
    frames = [seq.frame(i) for i in range(len(seq))]
    sj = jsystem.SDSlamSystem(jax_cfg(), sensor=jsystem.RGBD, loop_closing=True)
    st = tsystem.SDSlamSystem(port_cfg(), sensor=tsystem.RGBD, loop_closing=True, device="cpu")
    for ts, img, depth in frames:
        sj.track_rgbd(img, depth, ts)
        st.track_rgbd(np.array(img), np.array(depth), ts)
    sj.finish()
    st.finish()
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
                                   "SyntheticSequence"])
def test_default_device_needs_cuda(entry, monkeypatch):
    """On a machine without CUDA, an entry point called without a device
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "RGBDTracker": lambda: RGBDTracker(port_cfg()),
        "SDSlamSystem": lambda: tsystem.SDSlamSystem(port_cfg()),
        "init_map": lambda: TM.init_map(4, 16, 8, ((12, 16),)),
        "SyntheticSequence": lambda: tsyn.SyntheticSequence(TCAM, n_frames=2),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
