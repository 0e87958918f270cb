"""The port's synthetic renderer against sdslam_tpu.io.synthetic."""

import numpy as np
import pytest
import torch

from sdslam_tpu.geometry.camera import CameraModel as JCam
from sdslam_tpu.io import synthetic as jsyn
from sdslam_tpu_torch.geometry.camera import CameraModel as TCam
from sdslam_tpu_torch.io import synthetic as tsyn

torch.set_num_threads(2)

CAM = dict(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320, height=240, bf=32.0)


def test_scene_parameters_identical():
    a = jsyn.make_room_scene(seed=0)
    b = tsyn.make_room_scene(seed=0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("trajectory,kw", [("orbit", dict(radius=0.06, yaw_amp=0.04)),
                                           ("forward", dict(step=0.01))])
def test_render_parity(trajectory, kw):
    js = jsyn.SyntheticSequence(JCam(**CAM), n_frames=16, trajectory=trajectory, **kw)
    ts_ = tsyn.SyntheticSequence(TCam(**CAM), n_frames=16, trajectory=trajectory,
                                device="cpu", **kw)
    # ground-truth poses: same float32 trajectory recipe
    np.testing.assert_allclose(np.asarray(js.poses), ts_.poses.numpy(), atol=1e-6)
    for i in (0, 9):
        t0, img0, d0 = js.frame(i)
        t1, img1, d1 = ts_.frame(i)
        assert t0 == t1
        # depth: ray/plane intersections in float32, evaluated in another
        # order (einsum contractions) -> sub-0.1 mm
        np.testing.assert_allclose(np.asarray(d0), d1.numpy(), atol=1e-4)
        # intensity: a 128-wave sine sum; float order moves pixels by far
        # less than one intensity level almost everywhere
        diff = np.abs(np.asarray(img0) - img1.numpy())
        assert (diff <= 1.0).mean() >= 0.999, diff.max()
        assert img1.std() > 10
