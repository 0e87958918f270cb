"""The plain ORB reference reproduces the port's extraction (features,
undistorted coordinates, the RGB-D keypoint depth) on a rendered frame,
and its comparison sees a distortion left out and half the keypoints
dropped."""

import numpy as np
import torch

from perf_bench import harness, orb_ref
from perf_bench import scene as sc
from perf_bench import traffic as tr

SETTINGS = {"Camera.fx": 258.653204, "Camera.fy": 258.2346075, "Camera.cx": 159.32152,
            "Camera.cy": 127.6569945, "Camera.k1": 0.262383, "Camera.k2": -0.953104,
            "Camera.p1": -0.005358, "Camera.p2": 0.002628, "Camera.k3": 1.163314,
            "Camera.Width": 320, "Camera.Height": 240, "Camera.fps": 30.0, "Camera.bf": 20.0,
            "ThDepth": 40.0, "DepthMapFactor": 5000.0, "ORBextractor.nFeatures": 500,
            "ORBextractor.scaleFactor": 2.0, "ORBextractor.nLevels": 4,
            "ORBextractor.thresholdFAST": 20, "Map.MaxKeyframes": 16, "Map.MaxPoints": 1024}
PARAMS = {"lap": {"kind": "orbit", "lap_frames": 4, "radius_m": 0.24, "yaw_amp_rad": 0.16,
                  "fps": 30.0}, "scene_seed": 0, "image_noise_sigma": 2.0}


def _program_frame(settings, img, dep):
    from sdslam_tpu_torch.features.frame import ORBExtractor, make_frame

    cfg = harness.program_config({"settings": settings}, False)
    ext = ORBExtractor(cfg.camera, cfg.orb)
    # the packed transport's depth: every other pixel
    return make_frame(ext, torch.as_tensor(img), torch.as_tensor(dep[::2, ::2].astype(np.int32)),
                      depth_factor=cfg.tracking.depth_map_factor)


def _prog(frame):
    return harness._features(frame.features, frame.depth)


def _reference(cam, img, dep):
    ref = orb_ref.extract(img, cam, 500, 4, 2.0, 20.0, "cpu")
    ref["depth"] = orb_ref.keypoint_depth(dep, ref["uv"], 5000.0)
    return ref


def test_reference_matches_the_port_exactly(one_thread):
    cam = sc.Camera.from_yaml_keys(SETTINGS)
    lap = tr.make_lap(PARAMS, cam, 5000.0, 7, torch.device("cpu"))
    for k in range(2):
        frame = _program_frame(SETTINGS, lap.images[k], lap.depths[k])
        prog = harness._features(frame.features, frame.depth)
        ref = _reference(cam, lap.images[k], lap.depths[k])
        assert len(ref["uv"]) > 300
        assert orb_ref.mismatch(ref, prog, 0.05, 16)[0] == 0
        assert torch.equal(prog["bits"], ref["bits"])  # bit for bit, in the same order


def test_comparison_sees_a_missing_distortion_and_dropped_keypoints(one_thread):
    cam = sc.Camera.from_yaml_keys(SETTINGS)
    lap = tr.make_lap(PARAMS, cam, 5000.0, 7, torch.device("cpu"))
    img, dep = lap.images[0], lap.depths[0]
    ref = _reference(cam, img, dep)
    flat = dict(SETTINGS, **{f"Camera.{k}": 0.0 for k in ("k1", "k2", "p1", "p2", "k3")})
    prog = _prog(_program_frame(flat, img, dep))
    miss, total = orb_ref.mismatch(ref, prog, 0.05, 16)
    assert miss / total > 0.8
    prog = _prog(_program_frame(SETTINGS, img, dep))
    half = {k: v[: len(v) // 2] for k, v in prog.items()}
    miss, total = orb_ref.mismatch(ref, half, 0.05, 16)
    assert 0.25 < miss / total < 0.45
    mm = dict(SETTINGS, DepthMapFactor=1000.0)
    prog = _prog(_program_frame(mm, img, dep))
    assert orb_ref.mismatch(ref, prog, 0.05, 16)[0] / total > 0.8
