"""The traffic generator: the same seed gives the same frames, another
seed other noise on the same lap; the schedule cycles the lap; the
renderer's rays invert the published lens exactly."""

import numpy as np
import pytest
import torch

from perf_bench import scene as sc
from perf_bench import traffic as tr

CAM = sc.Camera(fx=120.0, fy=120.0, cx=79.5, cy=59.5, width=160, height=120,
                k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314)
PARAMS = {"lap": {"kind": "orbit", "lap_frames": 12, "radius_m": 0.24, "yaw_amp_rad": 0.16,
                  "fps": 30.0},
          "scene_seed": 0, "image_noise_sigma": 2.0}
TUM1 = sc.Camera(fx=517.306408, fy=516.469215, cx=318.64304, cy=255.313989, width=640,
                 height=480, k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314)


def lap(seed):
    return tr.make_lap(PARAMS, CAM, 5000.0, seed, torch.device("cpu"))


def test_same_seed_same_frames_other_seed_other_noise(one_thread):
    a, b, c = lap(3_000_000_017), lap(3_000_000_017), lap(11)
    for x, y in zip(a.images + a.depths, b.images + b.depths):
        assert np.array_equal(x, y)
    assert np.array_equal(a.poses, c.poses) and np.array_equal(a.depths[3], c.depths[3])
    assert not np.array_equal(a.images[3], c.images[3])
    diff = a.images[3].astype(int) - c.images[3].astype(int)
    assert 1.5 < diff.std() < 4.0  # two draws of sigma-2 noise
    assert a.images[0].dtype == np.uint8 and a.depths[0].dtype == np.uint16
    assert a.images[0].std() > 10 and (a.depths[0] > 0).mean() > 0.95


def test_lap_is_periodic_and_starts_at_identity():
    P = tr.lap_poses(PARAMS)
    assert np.allclose(P[0], np.eye(4))
    step = [np.linalg.norm(sc.so3_exp(np.zeros(3)) @ P[i][:3, 3] - P[i - 1][:3, 3])
            for i in range(len(P))]
    assert max(step) < 3 * min(step) + 1e-9  # the wrap is one more ordinary step


def test_schedule_cycles_the_lap():
    s = tr.Schedule(PARAMS, 12)
    got = [s.next() for _ in range(14)]
    assert [k for k, _ in got] == list(range(12)) + [0, 1]
    assert got[13][1] == 13 / 30.0


def test_rays_invert_the_published_lens():
    """Every pixel of the full TUM fr1 image: distorting its ray lands on
    the pixel to 1e-6 px (float64), though the lens moves the corners by
    tens of pixels."""
    H, W = TUM1.height, TUM1.width
    u = torch.arange(W, dtype=torch.float64)[None, :].expand(H, W)
    v = torch.arange(H, dtype=torch.float64)[:, None].expand(H, W)
    xn, yn = sc.undistort_normalized(TUM1, (u - TUM1.cx) / TUM1.fx, (v - TUM1.cy) / TUM1.fy)
    xd, yd = sc.distort_normalized(TUM1, xn, yn)
    res = torch.hypot((xd * TUM1.fx + TUM1.cx) - u, (yd * TUM1.fy + TUM1.cy) - v)
    assert float(res.max()) < sc.UNDISTORT_TOL_PX
    moved = torch.hypot(xn * TUM1.fx + TUM1.cx - u, yn * TUM1.fy + TUM1.cy - v)
    assert float(moved.max()) > 10.0
    rays = sc.pixel_rays(TUM1, "cpu")
    assert torch.allclose(rays[..., 0].double(), xn, atol=1e-6)
    assert torch.allclose(rays[..., 1].double(), yn, atol=1e-6)


def test_an_uninvertible_lens_is_refused():
    bad = TUM1._replace(k1=-5.0)  # folds the image: no inverse reaches the corners
    with pytest.raises(ValueError):
        sc.pixel_rays(bad, "cpu")


def test_render_hits_the_room_and_rays_follow_the_lens():
    scene = sc.make_room_scene(0)
    rays = sc.pixel_rays(CAM, "cpu")
    img, depth = sc.render(scene, rays, torch.eye(4))
    assert float(depth.min()) > 0.3 and float(depth.max()) < 3.5
    # undistorting the centre pixel's neighbourhood is nearly the identity,
    # the corner is pulled by the lens
    uv = torch.tensor([[CAM.cx, CAM.cy], [0.0, 0.0]], dtype=torch.float64)
    und = sc.undistort_pixels(CAM, uv)
    assert torch.allclose(und[0], uv[0], atol=1e-4) and (und[1] - uv[1]).norm() > 1.0
    X = np.array([[0.0, 0.0, 2.5], [0.0, 0.0, 2.4]])
    assert np.allclose(sc.surface_distance(scene, X)[0], 0.0, atol=1e-6)
