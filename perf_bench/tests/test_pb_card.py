"""On the card (skipped without one): the same seed renders the same
frames bit for bit, and the plain ORB reference agrees with the program's
extraction at the configuration's full width.

    python3 -m pytest perf_bench/tests/test_pb_card.py -p no:cacheprovider
"""

import json
from pathlib import Path

import numpy as np
import pytest

from perf_bench import harness, orb_ref
from perf_bench import scene as sc
from perf_bench import traffic as tr

ROOT = Path(__file__).resolve().parents[2]
CONF = json.loads((ROOT / "perf_bench/configs/tum1-rgbd.json").read_text())
PARAMS = {"lap": {"kind": "orbit", "lap_frames": 6, "radius_m": 0.24, "yaw_amp_rad": 0.16,
                  "fps": 30.0}, "scene_seed": 0, "image_noise_sigma": 2.0}


@pytest.mark.card
def test_same_seed_same_frames_on_card(card):
    cam = sc.Camera.from_yaml_keys(CONF["settings"])
    a = tr.make_lap(PARAMS, cam, 5000.0, 3_000_000_123, card)
    b = tr.make_lap(PARAMS, cam, 5000.0, 3_000_000_123, card)
    for x, y in zip(a.images + a.depths, b.images + b.depths):
        assert np.array_equal(x, y)


@pytest.mark.card
def test_reference_matches_the_program_on_card(card):
    import torch

    from sdslam_tpu_torch.features.frame import ORBExtractor, make_frame

    s = CONF["settings"]
    cam = sc.Camera.from_yaml_keys(s)
    lap = tr.make_lap(PARAMS, cam, 5000.0, 5, card)
    cfg = harness.program_config(CONF, False)
    ext = ORBExtractor(cfg.camera, cfg.orb)
    for k in range(3):
        img, dep = lap.images[k], lap.depths[k]
        frame = make_frame(ext, torch.as_tensor(img, device=card),
                           torch.as_tensor(dep[::2, ::2].astype(np.int32), device=card),
                           depth_factor=cfg.tracking.depth_map_factor)
        prog = harness._features(frame.features, frame.depth)
        ref = orb_ref.extract(img, cam, 1000, 5, 2.0, 20.0, card)
        ref["depth"] = orb_ref.keypoint_depth(dep, ref["uv"], 5000.0)
        ref = {key: v.cpu() for key, v in ref.items()}
        miss, total = orb_ref.mismatch(ref, prog, 0.05, 16)
        assert len(ref["uv"]) > 500 and (miss, total) == (0, 2 * len(ref["uv"]))
