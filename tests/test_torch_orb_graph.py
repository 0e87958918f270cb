"""ORB extraction replayed as one CUDA graph per input key
(`features/frame.py`: `ORBExtractor.core`, `extract_channels`,
`graph_key`).

On the CPU: a CPU input runs the eager computation, the same as before the
graph existed, and opens no replay span; the key tells apart every input
that needs its own graph. On the card (marked `card`, skipped without
one): the graph equals the eager computation bit for bit over six frames
of the `tum1-rgbd` configuration, its outputs survive later replays, one
capture serves each key across the first frame, tracked frames and a
relocalization, the pipelined tracker tracks as the unpipelined one does,
and a capture that fails raises. This file imports no JAX; on the card:

    python3 -m pytest tests/test_torch_orb_graph.py --noconftest -p no:cacheprovider
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sdslam_tpu_torch.features import frame as frame_mod
from sdslam_tpu_torch.features.frame import (ORBExtractor, alignment_levels, extract_channels,
                                             graph_key)
from sdslam_tpu_torch.geometry import camera as cam_mod
from sdslam_tpu_torch.geometry import lie
from sdslam_tpu_torch.geometry.camera import CameraModel
from sdslam_tpu_torch.io.synthetic import SyntheticSequence
from sdslam_tpu_torch.ops import sample as smp
from sdslam_tpu_torch.utils import profiling
from sdslam_tpu_torch.utils.config import ORBConfig

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CAM = dict(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320, height=240, bf=32.0,
           k1=0.05, k2=-0.01)
# the lap of the tum1-rgbd mapping cell (perf_bench/traffic/handheld-mapping.json)
LAP = {"lap": {"kind": "orbit", "lap_frames": 240, "radius_m": 0.24, "yaw_amp_rad": 0.16,
               "fps": 30.0}, "scene_seed": 0, "image_noise_sigma": 2.0}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.fixture
def recorder(monkeypatch):
    rec = profiling.SpanRecorder()
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    return rec


def _before_split(ext, img, depth_img, depth_factor):
    """`ORBExtractor.core`'s body as it stood before the graph path."""
    img = img.to(torch.float32)
    feats, pyramid = ext.extract(img)
    n = feats.uv.shape[0]
    if depth_img is None:
        neg = torch.full((n,), -1.0, device=img.device)
        return feats, pyramid, neg, neg.clone()
    dimg = depth_img.to(torch.float32)
    if depth_factor != 1.0:
        dimg = dimg / depth_factor
    if depth_img.shape[0] <= (img.shape[0] + 1) // 2:
        d = smp.sample_nearest(dimg, feats.uv * 0.5)
    else:
        d = smp.sample_nearest(dimg, feats.uv)
    d = torch.where(feats.valid & (d > 0), d, torch.full_like(d, -1.0))
    uright = cam_mod.virtual_right(ext.cam, feats.uv_und[:, 0], d)
    return feats, pyramid, d, uright


def _flat(out):
    """(name, tensor) of every output: the seven feature fields, each
    pyramid level, the keypoint depths and u_r."""
    feats, pyramid, d, uright = out
    return ([(f, getattr(feats, f)) for f in feats._fields]
            + [(f"pyramid{i}", p) for i, p in enumerate(pyramid)] + [("d", d), ("uright", uright)])


def _assert_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (name, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), name


@pytest.fixture(scope="module")
def cpu_frame():
    seq = SyntheticSequence(CameraModel(**CAM), n_frames=8, trajectory="orbit", radius=0.06,
                            yaw_amp=0.04, device="cpu")
    _, img, depth = seq.frame(2)
    img8 = torch.clamp(torch.round(img), 0, 255).to(torch.uint8)
    dep16 = torch.round(depth * 5000.0).to(torch.int32)
    return img8, dep16


@pytest.mark.parametrize("form", ["packed", "full", "mono", "float"])
def test_cpu_input_runs_eagerly(cpu_frame, recorder, form):
    """Each input form the trackers hand over: the packed transport's u8
    image and decimated int32 depth, full-size depth, monocular u8, and a
    float image with float depth in metres."""
    img8, dep = cpu_frame
    ext = ORBExtractor(CameraModel(**CAM), ORBConfig(max_keypoints=512, n_levels=4))
    img, depth, factor = {"packed": (img8, dep[::2, ::2].contiguous(), 5000.0),
                          "full": (img8, dep, 5000.0),
                          "mono": (img8, None, 1.0),
                          "float": (img8.to(torch.float32), dep.to(torch.float32) / 5000.0,
                                    1.0)}[form]
    with profiling.span("sdslam.orb"):
        out = ext.core(img, depth, factor)
    # the body before the graph path, with the camera's lens taken out of
    # the alignment levels (levels >= 2), which the pre-split body read raw
    feats, raw, d, ur = _before_split(ext, img, depth, factor)
    _assert_equal(out, (feats, alignment_levels(ext.cam, raw, ext.cfg.scale_factor), d, ur))
    assert all(torch.equal(a, b) for a, b in zip(out[1][:2], raw[:2]))
    assert not any(torch.equal(a, b) for a, b in zip(out[1][2:], raw[2:]))
    _assert_equal(out, extract_channels(ext, img, depth, factor))
    assert int(out[0].valid.sum()) > 100
    if depth is not None:
        assert int((out[2] > 0).sum()) > 100
    assert [s.name for s in recorder.spans()] == ["sdslam.orb"]
    assert ext._graphs == {}


def _key(img=(torch.uint8, (480, 640)), depth=(torch.int32, (240, 320)), factor=5000.0,
         device="cpu"):
    im = torch.empty(img[1], dtype=img[0], device=device)
    dp = None if depth is None else torch.empty(depth[1], dtype=depth[0], device=device)
    return graph_key(im, dp, factor)


@pytest.mark.parametrize("other", [
    dict(depth=None),  # monocular
    dict(depth=(torch.int32, (480, 640))),  # full-size depth
    dict(depth=(torch.uint16, (480, 640))),  # the first frame's unpacked u16 depth
    dict(depth=(torch.float32, (240, 320))),  # depth dtype
    dict(img=(torch.float32, (480, 640))),  # image dtype
    dict(img=(torch.uint8, (240, 320)), depth=(torch.int32, (120, 160))),  # another camera
    dict(factor=1000.0),  # depth factor
    dict(device="meta"),  # device
], ids=["mono", "full-depth", "u16-depth", "depth-dtype", "image-dtype", "image-shape",
        "depth-factor", "device"])
def test_graph_key_tells_inputs_apart(other):
    assert _key(**other) != _key()
    assert _key(**other) == _key(**other)


def test_graph_key_ignores_values_and_strides():
    """Frames of one stream share a key: values and layout do not enter it."""
    a = torch.zeros((480, 640), dtype=torch.uint8)
    b = torch.full((480, 1280), 7, dtype=torch.uint8)[:, ::2]  # a strided view
    d = torch.ones((240, 320), dtype=torch.int32)
    assert graph_key(a, d, 5000) == graph_key(b, d * 3, 5000.0) == _key()
    assert graph_key(a, None, 1) == graph_key(b, None, 1.0) == _key(depth=None, factor=1.0)


# --- on the card --------------------------------------------------------------


@pytest.fixture(scope="module")
def tum1():
    """(the tum1-rgbd program configuration, its depth factor, the lap's
    first 16 frames as the camera hands them over (u8 image, u16 depth),
    their poses), rendered on the card once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from perf_bench import harness
    from perf_bench import scene as sc
    from perf_bench import traffic as tr

    conf = json.loads((ROOT / "perf_bench/configs/tum1-rgbd.json").read_text())
    cfg = harness.program_config(conf, False)
    factor = cfg.tracking.depth_map_factor
    lap = tr.make_lap(LAP, sc.Camera.from_yaml_keys(conf["settings"]), factor, 2_718_281_831,
                      torch.device("cuda"))
    return cfg, factor, list(zip(lap.images[:16], lap.depths[:16])), lap.poses[:16]


def _on(card, img, dep, packed):
    """A frame's device inputs: the packed transport's u8 image and
    decimated int32 depth, or the unpacked u8 image and u16 depth."""
    if packed:
        return (torch.as_tensor(img, device=card),
                torch.as_tensor(dep[::2, ::2].astype(np.int32), device=card))
    return torch.as_tensor(img).to(card), torch.as_tensor(dep).to(card)


@pytest.mark.card
def test_graph_equals_eager_bit_for_bit(card, tum1, recorder):
    cfg, factor, frames, _ = tum1
    frames = frames[:6]
    ext = ORBExtractor(cfg.camera, cfg.orb)
    for packed in (True, False):
        for img, dep in frames:
            x, d = _on(card, img, dep, packed)
            _assert_equal(ext.core(x, d, factor), extract_channels(ext, x, d, factor))
        x, _ = _on(card, *frames[0], packed)
        _assert_equal(ext.core(x, None, 1.0), extract_channels(ext, x, None, 1.0))
    assert len(ext._graphs) == 3  # packed, unpacked, and the u8 image's monocular key
    assert sum(s.name == "sdslam.orb.replay" for s in recorder.spans()) == 14


@pytest.mark.card
def test_outputs_survive_later_replays(card, tum1):
    cfg, factor, frames, _ = tum1
    ext = ORBExtractor(cfg.camera, cfg.orb)
    kept = ext.core(*_on(card, *frames[0], True), factor)
    snapshot = tuple(t.clone() for _, t in _flat(kept))
    static = {t.data_ptr() for _, t in _flat(ext._graphs[graph_key(
        *_on(card, *frames[0], True), factor)].out)}
    for img, dep in frames[1:5]:
        ext.core(*_on(card, img, dep, True), factor)
    torch.cuda.synchronize()
    for (name, t), s in zip(_flat(kept), snapshot):
        assert torch.equal(t, s), name
        assert t.data_ptr() not in static, name


@pytest.mark.card
def test_one_capture_per_key(card, tum1, monkeypatch, recorder):
    """The first frame and a relocalization hand over the unpacked u16
    depth, tracked frames the packed transport's: two keys, two captures,
    and every extraction replays."""
    from sdslam_tpu_torch.pipeline.tracking import RGBDTracker

    cfg, _, frames, _ = tum1
    captures = []
    capture = frame_mod._capture

    def spy(ext, img, depth_img, depth_factor):
        captures.append(graph_key(img, depth_img, depth_factor))
        return capture(ext, img, depth_img, depth_factor)

    monkeypatch.setattr(frame_mod, "_capture", spy)
    tracker = RGBDTracker(cfg, device=card)
    for i, (img, dep) in enumerate(frames[:5]):
        tracker.track(img, dep, i / 30.0)
    tracker.flush()
    assert tracker.st.status == "OK"
    tracker.st.status = "LOST"
    tracker.track(*frames[5], 5 / 30.0)
    tracker.flush()
    assert len(captures) == len(set(captures)) == 2
    spans = recorder.spans()
    orb = {s.id for s in spans if s.name == "sdslam.orb"}
    assert len(orb) == 6 and any(s.name == "sdslam.reloc" for s in spans)
    assert {s.parent for s in spans if s.name == "sdslam.orb.replay"} == orb


@pytest.mark.card
def test_pipelined_tracks_as_the_unpipelined_tracker(card, tum1):
    """tests/test_torch_pipelined.py's gates (ATE under 2 cm, two keyframes
    or more, every poll blocking) and its pose agreement with the plain
    tracker, on the card with the graphed extraction."""
    from sdslam_tpu_torch.parallel.pipelined import PipelinedRGBDTracker
    from sdslam_tpu_torch.pipeline.tracking import RGBDTracker
    from sdslam_tpu_torch.utils.metrics import ate_rmse

    cfg, _, frames, poses = tum1
    pipelined = PipelinedRGBDTracker(cfg, device=card)
    poll = pipelined._poll_map_job
    pipelined._poll_map_job = lambda block=False: poll(block=True)
    plain = RGBDTracker(cfg, device=card)
    for tr in (pipelined, plain):
        for i, (img, dep) in enumerate(frames):
            tr.track(img, dep, i / 30.0)
        tr.flush()
    assert int(pipelined.ms.kf_valid.sum()) >= 2
    est = np.stack([np.asarray(p) for p in pipelined.trajectory])
    assert ate_rmse(est, poses) < 0.02
    for k, (a, b) in enumerate(zip(plain.trajectory, pipelined.trajectory)):
        d = lie.se3_log(torch.from_numpy(np.asarray(b) @ np.linalg.inv(np.asarray(a)))).numpy()
        assert np.abs(d[:3]).max() < 1e-3 and np.abs(d[3:]).max() < 5e-3, (k, d)


@pytest.mark.card
def test_a_failed_capture_raises(card, tum1, monkeypatch):
    """An extraction that reads the device on the host cannot be captured:
    the call raises, and nothing runs eagerly in its place."""
    cfg, factor, frames, _ = tum1
    ext = ORBExtractor(cfg.camera, cfg.orb)
    eager = frame_mod.extract_channels

    def syncing(*a):
        out = eager(*a)
        float(out[2].sum())
        return out

    monkeypatch.setattr(frame_mod, "extract_channels", syncing)
    with pytest.raises(RuntimeError):
        ext.core(*_on(card, *frames[0], True), factor)
    assert ext._graphs == {}
    torch.cuda.synchronize()
    assert float(torch.ones(4, device=card).sum()) == 4.0


@pytest.mark.card
def test_graph_alignment_levels_equal_eager_through_a_barrel_lens(card):
    """The euroc-mono-imu configuration (EuRoC cam0's lens, 752x480,
    monocular u8 input): the graph's alignment levels, remapped to the
    pinhole camera inside the graph, equal the eager path's bit for bit,
    and are not the raw levels."""
    from perf_bench import harness
    from perf_bench import scene as sc
    from perf_bench import traffic as tr

    conf = json.loads((ROOT / "perf_bench/configs/euroc-mono-imu.json").read_text())
    cfg = harness.program_config(conf, False)
    assert cfg.camera.has_distortion
    lap = tr.make_lap({**LAP, "lap": {**LAP["lap"], "fps": 20.0}},
                      sc.Camera.from_yaml_keys(conf["settings"]), None, 3_141_592_653, card)
    ext = ORBExtractor(cfg.camera, cfg.orb)
    for img in lap.images[:4]:
        x = torch.as_tensor(img, device=card)
        out = ext.core(x, None, 1.0)
        _assert_equal(out, extract_channels(ext, x, None, 1.0))
        raw = ext.extract(x.to(torch.float32))[1]
        assert all(torch.equal(a, b) for a, b in zip(out[1][:2], raw[:2]))
        assert not any(torch.equal(a, b) for a, b in zip(out[1][2:], raw[2:]))
    assert len(ext._graphs) == 1
