"""The monocular slice as a whole: the port's MonoTracker against
sdslam_tpu's on the 16-frame orbit of tests/test_mono.py (320x240, 512
keypoints, 4 levels, 32 keyframe slots, 4096 points), every kernel on its
plain version on the CPU.

The two-view bootstrap's RANSAC draws differ between jax.random and torch,
so the port's `_init_samples` is patched to return the JAX tracker's draws:
jax.random.choice with the key of the same attempt, over the same
distribution (the matched keypoints).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdslam_tpu.io import synthetic as jsyn
from sdslam_tpu.pipeline.tracking import MonoTracker as JMono
from sdslam_tpu.utils.config import MapConfig as JMapCfg
from sdslam_tpu.utils.config import ORBConfig as JORBCfg
from sdslam_tpu.utils.config import SystemConfig as JSysCfg
from sdslam_tpu_torch.geometry.camera import CameraModel as TCam
from sdslam_tpu_torch.pipeline import tracking as tt
from sdslam_tpu_torch.utils import config as tcfg
from sdslam_tpu_torch.utils import metrics
from test_mono import CAM as JCAM

torch.set_num_threads(2)

TCAM = TCam(*JCAM)
ORB = dict(max_keypoints=512, n_levels=4)
MAP = dict(max_keyframes=32, max_points=4096, max_kps_per_frame=512)
N_FRAMES = 16
ORBIT = dict(n_frames=N_FRAMES, trajectory="orbit", radius=0.12, yaw_amp=0.03)


def jax_cfg(orb=ORB, map_=MAP):
    return JSysCfg(camera=JCAM, orb=JORBCfg(**orb), map=JMapCfg(**map_))


def port_cfg(orb=ORB, map_=MAP):
    return tcfg.SystemConfig(camera=TCAM, orb=tcfg.ORBConfig(**orb), map=tcfg.MapConfig(**map_))


@jax.jit
def _jax_draw(key, valid):
    # the draw of sdslam_tpu/solvers/initializer.py::initialize_two_view
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1e-6)
    return jax.random.choice(key, valid.shape[0], shape=(200, 8), p=probs)


def use_jax_draws(tracker):
    """Patch a port MonoTracker to draw its bootstrap samples as the JAX
    tracker does: attempt k uses jax.random.key(k)."""
    def draw(valid):
        idx = _jax_draw(jax.random.key(tracker._init_seed), jnp.asarray(valid.cpu().numpy()))
        return torch.from_numpy(np.asarray(idx).astype(np.int64))
    tracker._init_samples = draw
    return tracker


def trajectory(tracker):
    return np.stack([np.asarray(p) for p in tracker.trajectory])


@pytest.fixture(scope="module")
def runs():
    seq = jsyn.SyntheticSequence(JCAM, **ORBIT)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    tj = JMono(jax_cfg())
    tp = use_jax_draws(tt.MonoTracker(port_cfg(), device="cpu"))
    for ts, img, _ in frames:
        tj.track(img, ts)
        tp.track(np.array(img), ts)
    tj.flush()
    tp.flush()
    return dict(gt=np.asarray(seq.poses), tj=tj, tp=tp)


def test_mono_gates(runs):
    """tests/test_mono.py's gates on the port alone."""
    tp = runs["tp"]
    assert tp.st.status == "OK"
    assert int(tp.ms.pt_valid.sum()) > 100
    assert int(tp.ms.kf_valid.sum()) >= 2
    assert metrics.ate_rmse(trajectory(tp), runs["gt"], align=True, with_scale=True) < 0.05


def test_mono_jax_parity(runs):
    """The same bootstrap attempt succeeds on both sides; trajectories within
    1e-3 m and 5e-3 in rotation entries (the tolerance tests/test_odometry.py
    accepts between tracker variants); equal keyframe and point counts."""
    tj, tp = runs["tj"], runs["tp"]
    assert tp._init_seed == tj._seed
    ej, et = trajectory(tj), trajectory(tp)
    assert ej.shape == et.shape == (N_FRAMES, 4, 4)
    assert np.abs(et[:, :3, 3] - ej[:, :3, 3]).max() < 1e-3
    assert np.abs(et[:, :3, :3] - ej[:, :3, :3]).max() < 5e-3
    assert int(tp.ms.kf_valid.sum()) == int(tj.ms.n_keyframes())
    assert int(tp.ms.pt_valid.sum()) == int(tj.ms.n_points())


def test_mono_pattern_init_not_ported():
    """use_pattern, once refused, now replaces the two-view bootstrap: a
    frame without a board is one attempt (its image read on the host)
    and leaves the tracker uninitialized (tests/test_torch_pattern.py
    holds the initialization against the JAX package)."""
    cfg = port_cfg()
    cfg = tcfg.SystemConfig(camera=cfg.camera, orb=cfg.orb, map=cfg.map,
                            tracking=tcfg.TrackingConfig(use_pattern=True))
    tracker = tt.MonoTracker(cfg, device="cpu")
    seq = jsyn.SyntheticSequence(JCAM, **ORBIT)
    for i in range(2):
        ts, img, _ = seq.frame(i)
        tracker.track(np.array(img), ts)
    assert tracker.st.status == "NOT_INITIALIZED" and tracker._init_frame is None
    assert tracker.host_syncs == 2 and int(tracker.ms.kf_valid.sum()) == 0


def test_nanmedian_matches_numpy():
    """The scale of the initial map: numpy's nanmedian (the mean of the two
    middle values), where torch.nanmedian returns the lower one."""
    rng = np.random.default_rng(4)
    for n in (7, 8):
        x = rng.uniform(0.5, 3.0, size=n + 3).astype(np.float32)
        x[rng.choice(n + 3, size=3, replace=False)] = np.nan
        got = float(tt._nanmedian(torch.from_numpy(x)))
        assert got == pytest.approx(float(jnp.nanmedian(jnp.asarray(x))), rel=1e-7)
        assert got == pytest.approx(float(np.nanmedian(x)), rel=1e-6)


def test_mono_bootstrap_at_chip_smoke_size():
    """chip_smoke.py phase 7's sequence (default camera and ORB: 640x480,
    5 levels, 1024 keypoints; a 32-frame orbit, radius 0.12, yaw_amp 0.03)
    with the pools cut to 32 keyframes / 4096 points: the port and the JAX
    package both bootstrap by frame 3, the phase's gate."""
    from sdslam_tpu.utils.config import SystemConfig as JFull
    from sdslam_tpu_torch.io import synthetic as tsyn

    pools = dict(max_keyframes=32, max_points=4096)
    tcfg_ = tcfg.SystemConfig(map=tcfg.MapConfig(**pools))
    jcfg_ = JFull(map=JMapCfg(**pools))
    assert (tcfg_.camera.width, tcfg_.orb.n_levels, tcfg_.orb.max_keypoints) == (640, 5, 1024)
    seq = tsyn.SyntheticSequence(tcfg_.camera, n_frames=32, trajectory="orbit", radius=0.12,
                                 yaw_amp=0.03, device="cpu")
    first_ok = {}
    for name, tracker in (("port", tt.MonoTracker(tcfg_, device="cpu")), ("jax", JMono(jcfg_))):
        for k in range(4):
            ts, img, _ = seq.frame(k)
            tracker.track(img.numpy().astype(np.uint8), ts)
            tracker.flush()
            if tracker.st.status == "OK":
                first_ok[name] = k
                break
    assert first_ok.get("port", 99) <= 3 and first_ok.get("jax", 99) <= 3, first_ok
