"""Relocalization (the LOST state) of the port against sdslam_tpu's, at test
size: 320x240, 512 keypoints, 4 levels, 32 keyframe slots, 4096 points.

  * `relocalize` on one map built by the JAX tracker over the orbit of
    tests/test_relocalization.py and carried across with interop;
  * `epnp` and `ransac_epnp` with the same RANSAC index sets, drawn here
    with jax.random.choice from the key the JAX solver uses;
  * the kidnap, 35 deg roll and unrelated-scene cases through the port's
    RGBDTracker on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdslam_tpu.features.frame import make_frame as j_make_frame
from sdslam_tpu.geometry import lie as jlie
from sdslam_tpu.geometry.camera import CameraModel as JCam
from sdslam_tpu.io import synthetic as jsyn
from sdslam_tpu.pipeline import relocalization as jreloc
from sdslam_tpu.pipeline.tracking import KF_STORE_MIN_LEVEL, RGBDTracker as JTracker
from sdslam_tpu.solvers import epnp as jepnp
from sdslam_tpu.utils.config import MapConfig as JMapCfg
from sdslam_tpu.utils.config import ORBConfig as JORBCfg
from sdslam_tpu.utils.config import SystemConfig as JSysCfg
from sdslam_tpu_torch import interop
from sdslam_tpu_torch.geometry import lie as tlie
from sdslam_tpu_torch.geometry.camera import CameraModel as TCam
from sdslam_tpu_torch.io import synthetic as tsyn
from sdslam_tpu_torch.pipeline import relocalization as treloc
from sdslam_tpu_torch.pipeline.tracking import RGBDTracker as TTracker
from sdslam_tpu_torch.solvers import epnp as tepnp
from sdslam_tpu_torch.utils import config as tcfg

torch.set_num_threads(2)

CAM_KW = dict(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320, height=240, bf=32.0)
JCAM, TCAM = JCam(**CAM_KW), TCam(**CAM_KW)
ORB = dict(max_keypoints=512, n_levels=4)
MAP = dict(max_keyframes=32, max_points=4096, max_kps_per_frame=512)
ORBIT = dict(n_frames=16, trajectory="orbit", radius=0.06, yaw_amp=0.04)


def jax_cfg():
    return JSysCfg(camera=JCAM, orb=JORBCfg(**ORB), map=JMapCfg(**MAP))


def port_cfg():
    return tcfg.SystemConfig(camera=TCAM, orb=tcfg.ORBConfig(**ORB), map=tcfg.MapConfig(**MAP))


def np_tree(x):
    """numpy copies of a JAX pytree of arrays (the JAX tracker donates its
    state buffers, so views would be invalidated by its next step)."""
    if hasattr(x, "_asdict"):
        return {k: np_tree(v) for k, v in x._asdict().items()}
    if isinstance(x, tuple):
        return tuple(np.array(v) for v in x)
    return np.array(x)


def build_jax_map(n_track: int = 12):
    """The JAX tracker over the first n_track frames of the orbit. Returns
    (JAX tracker, JAX sequence)."""
    seq = jsyn.SyntheticSequence(JCAM, **ORBIT)
    tj = JTracker(jax_cfg())
    for i in range(n_track):
        ts, img, depth = seq.frame(i)
        tj.track(img, depth, ts)
    tj.flush()
    assert tj.st.status == "OK"
    return tj, seq


def carry(ms_jax):
    """The port's MapState holding the JAX map's values."""
    return interop.map_state_from_numpy(np_tree(ms_jax), device="cpu")


def frame_inputs(seq, i):
    """(JAX frame, the same features and pyramid as torch tensors)."""
    _, img, depth = seq.frame(i)
    fr = j_make_frame(JTracker(jax_cfg()).extractor, img, depth_img=depth)
    f = fr.features
    t = {k: torch.from_numpy(np.array(getattr(f, k))) for k in
         ("uv_und", "octave", "valid")}
    t["desc"] = torch.from_numpy(np.array(f.desc).view(np.int32))
    t["uright"] = torch.from_numpy(np.array(fr.uright))
    t["pyramid"] = tuple(torch.from_numpy(np.array(p)) for p in fr.pyramid)
    return fr, t


@pytest.fixture(scope="module")
def jmap():
    tj, seq = build_jax_map()
    return tj.ms, seq


def test_relocalize_parity(jmap):
    """The revisit of frame 5 (the photometric branch wins there): the same
    best keyframe, per-slot errors within 1e-4 relative with the same inf
    pattern, Tcw within 1e-4 (float32 sums over ~8k taps per slot in another
    order, then two pose GN solves)."""
    ms_j, seq = jmap
    fr, t = frame_inputs(seq, 5)
    f = fr.features
    rj = jreloc.relocalize(JCAM, ms_j, f.uv_und, f.desc, f.octave, f.valid, fr.uright,
                           fr.pyramid, key=jax.random.key(1), scale_factor=2.0, n_levels=4,
                           store_min_level=KF_STORE_MIN_LEVEL)
    rt = treloc.relocalize(TCAM, carry(ms_j), t["uv_und"], t["desc"], t["octave"], t["valid"],
                           t["uright"], t["pyramid"], generator=torch.Generator().manual_seed(1),
                           scale_factor=2.0, n_levels=4, store_min_level=KF_STORE_MIN_LEVEL)
    assert bool(rj.success) and bool(rt.success)
    assert int(rj.best_kf) == int(rt.best_kf)
    ej, et = np.asarray(rj.align_errors), rt.align_errors.numpy()
    np.testing.assert_array_equal(np.isinf(ej), np.isinf(et))
    fin = np.isfinite(ej)
    assert fin.sum() >= 3
    np.testing.assert_allclose(et[fin], ej[fin], rtol=1e-4)
    np.testing.assert_allclose(rt.Tcw.numpy(), np.asarray(rj.Tcw), atol=1e-4)
    assert abs(int(rj.n_inliers) - int(rt.n_inliers)) <= 2


def _pnp_problem(seed, n=100, noise=0.5, n_out=30):
    """tests/test_epnp.py's problem: 100 points, 0.5 px noise, 30 outliers."""
    rng = np.random.default_rng(seed)
    Xw = rng.uniform([-1.5, -1.0, -0.5], [1.5, 1.0, 0.5], size=(n, 3)).astype(np.float32)
    T = np.asarray(jlie.se3_exp(jnp.asarray(np.array([0.2, -0.1, 2.2, 0.15, -0.2, 0.1],
                                                     np.float32))))
    Xc = Xw @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([JCAM.fx * Xc[:, 0] / Xc[:, 2] + JCAM.cx,
                   JCAM.fy * Xc[:, 1] / Xc[:, 2] + JCAM.cy], 1).astype(np.float32)
    uv += rng.normal(size=uv.shape).astype(np.float32) * noise
    uv[:n_out] += rng.uniform(20, 60, size=(n_out, 2)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    return Xw, uv, valid


def test_epnp_parity():
    """One EPnP solve over the inliers: R and t within 1e-4 (eigenvector
    signs may differ between the libraries; the pose may not)."""
    Xw, uv, valid = _pnp_problem(0)
    m = valid.copy()
    m[:30] = False
    Rj, tj_, ej = jepnp.epnp(JCAM, jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(m))
    Rt, tt_, et = tepnp.epnp(TCAM, torch.from_numpy(Xw), torch.from_numpy(uv),
                             torch.from_numpy(m))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt_.numpy(), np.asarray(tj_), atol=1e-4)
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_epnp_same_sets(seed):
    """The JAX solver draws jax.random.choice(key, N, (64, 6), p); the port
    takes those sets. Inlier masks equal, R and t within 1e-4."""
    Xw, uv, valid = _pnp_problem(seed)
    key = jax.random.key(seed)
    p = valid.astype(np.float32)
    sets = jax.random.choice(key, len(Xw), shape=(64, 6), p=jnp.asarray(p / p.sum()))
    rj = jepnp.ransac_epnp(JCAM, jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(valid), key)
    rt = tepnp.ransac_epnp(TCAM, torch.from_numpy(Xw), torch.from_numpy(uv),
                           torch.from_numpy(valid), sets=torch.from_numpy(np.array(sets)))
    assert bool(rj.success) and bool(rt.success)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4)


def _err(T, T_gt):
    e = tlie.se3_log(torch.as_tensor(np.asarray(T, np.float32)) @
                     tlie.se3_inv(torch.as_tensor(np.asarray(T_gt, np.float32))))
    return float(e[:3].abs().max()), float(e[3:].abs().max())


@pytest.fixture(scope="module")
def port_tracker_lost():
    """The port's tracker over 12 orbit frames, then a blank frame."""
    seq = tsyn.SyntheticSequence(TCAM, device="cpu", **ORBIT)
    t = TTracker(port_cfg(), device="cpu")
    for i in range(12):
        ts, img, depth = seq.frame(i)
        t.track(img, depth, ts)
    t.flush()
    assert t.st.status == "OK"
    return t, seq


def _blank(t, ts):
    z = np.zeros((TCAM.height, TCAM.width), np.float32)
    t.track(z, z, ts)
    t.flush()
    assert t.st.status == "LOST"


def test_kidnap_roll_and_unrelated_through_tracker(port_tracker_lost):
    """tests/test_relocalization.py's three cases through the port's
    tracker: a revisit recovers photometrically (< 1 cm, 0.01 rad) and
    tracking goes on; a 35 deg in-plane roll recovers through EPnP
    (< 2 cm, 0.02 rad); an unrelated scene stays LOST."""
    t, seq = port_tracker_lost
    _blank(t, 90.0)
    _, img, depth = seq.frame(5)
    T = t.track(img, depth, 91.0)
    assert t.st.status == "OK"
    et, er = _err(T, seq.poses[5])
    assert et < 0.01 and er < 0.01
    _, img, depth = seq.frame(6)
    t.track(img, depth, 91.03)
    t.flush()
    assert t.st.status == "OK"
    assert _err(t.trajectory[-1], seq.poses[6])[0] < 0.01

    _blank(t, 92.0)
    roll = np.deg2rad(35.0)
    Rz = np.eye(4, dtype=np.float32)
    Rz[:2, :2] = [[np.cos(roll), -np.sin(roll)], [np.sin(roll), np.cos(roll)]]
    T_gt = torch.as_tensor(Rz) @ seq.poses[5]
    img, depth = tsyn.render(seq.scene, TCAM, T_gt)
    T = t.track(img.numpy(), depth.numpy(), 93.0)
    assert t.st.status == "OK"
    et, er = _err(T, T_gt)
    assert et < 0.02 and er < 0.02

    _blank(t, 94.0)
    other = tsyn.SyntheticSequence(TCAM, n_frames=2, seed=9, device="cpu")
    _, img, depth = other.frame(0)
    t.track(img, depth, 95.0)
    t.flush()
    assert t.st.status == "LOST"
