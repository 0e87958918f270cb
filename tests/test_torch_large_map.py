"""The large-map regime of tests/test_large_map.py in the port, held against
the JAX package on the same map.

The port builds the map once (chip_smoke.build_large_map: the JAX test's
recipe and size, 320x240, 4 levels, 256 keypoints, 128 keyframe slots,
32768 points, an orbit of radius 0.25 and yaw 0.2, plus associations from
search_by_projection so that points have more than one observer). The map
and frame 77's features and pyramid travel to JAX as numpy; the JAX side
builds nothing of its own. Then the passes whose cost grows with the pool:
relocalization of frame 77 against every slot, the alignment scan over all
slots (the port's world of one outside any process group against JAX's
one-device CPU mesh), and local BA at slot 77.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import chip_smoke as cs
from sdslam_tpu.geometry.camera import CameraModel as JCam
from sdslam_tpu.mapping import map_state as JM
from sdslam_tpu.parallel import dist_align as jdal
from sdslam_tpu.pipeline import relocalization as jreloc
from sdslam_tpu.solvers import ba as jba
from sdslam_tpu_torch import interop
from sdslam_tpu_torch.features.frame import make_frame
from sdslam_tpu_torch.geometry.camera import CameraModel as TCam
from sdslam_tpu_torch.mapping import map_state as TM
from sdslam_tpu_torch.parallel import dist_align as tdal
from sdslam_tpu_torch.pipeline.tracking import KF_STORE_MIN_LEVEL

pytestmark = pytest.mark.heavy

torch.set_num_threads(2)

CAM = dict(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320, height=240, bf=32.0)
JCAM, TCAM = JCam(**CAM), TCam(**CAM)
N_KF, N_PTS, N_KP, N_LEVELS, SF = 128, 32768, 256, 4, 2.0
Q = cs.LARGE_QUERY  # frame 77, the JAX test's query


def _pose_err(T, T_gt):
    return cs._pose_err(np.array(T), np.array(T_gt))


@pytest.fixture(scope="module")
def large():
    cfg = cs.large_map_config(TCAM, N_KP, N_LEVELS, N_KF, N_PTS)
    seq, extractor, ms = cs.build_large_map(cfg, "cpu")
    fr = make_frame(extractor, *seq.frame(Q)[1:])
    d = interop.map_state_to_numpy(ms)
    jms = JM.MapState(**{k: (tuple(jnp.asarray(p) for p in v) if k == "kf_pyramid"
                             else jnp.asarray(v)) for k, v in d.items()})
    f = fr.features
    jf = {k: jnp.asarray(getattr(f, k).numpy()) for k in ("uv_und", "octave", "valid")}
    jf["desc"] = jnp.asarray(f.desc.numpy().view(np.uint32))
    jf["uright"] = jnp.asarray(fr.uright.numpy())
    jf["pyramid"] = tuple(jnp.asarray(p.numpy()) for p in fr.pyramid)
    return dict(ms=ms, jms=jms, fr=fr, jf=jf, T_gt=seq.poses[Q].numpy())


def test_large_map_gates(large):
    """The JAX test's gates on the port's map, and points with several
    observers."""
    ms = large["ms"]
    n_obs = TM.point_obs_count(ms)
    assert int(ms.n_keyframes()) == N_KF and int(ms.n_points()) > 5000
    assert int((n_obs >= 2).sum()) > 1000


def test_relocalize_parity(large):
    """Frame 77 against all 128 slots. Where both packages win
    photometrically the poses agree within 1e-4; an EPnP win draws from
    each package's own random stream, so each side is then gated alone."""
    ms, fr, jf = large["ms"], large["fr"], large["jf"]
    rt, branch = cs.relocalize_branch(TCAM, ms, fr, torch.Generator().manual_seed(0), SF,
                                      N_LEVELS)
    rj = jreloc.relocalize(JCAM, large["jms"], jf["uv_und"], jf["desc"], jf["octave"],
                           jf["valid"], jf["uright"], jf["pyramid"], key=jax.random.key(0),
                           scale_factor=SF, n_levels=N_LEVELS, store_min_level=KF_STORE_MIN_LEVEL)
    assert bool(rt.success) and bool(rj.success)
    for T in (rt.Tcw.numpy(), np.asarray(rj.Tcw)):
        assert _pose_err(T, large["T_gt"])[0] < 0.02
    ej, et = np.asarray(rj.align_errors), rt.align_errors.numpy()
    np.testing.assert_array_equal(np.isinf(ej), np.isinf(et))
    if branch == "photometric":
        np.testing.assert_allclose(rt.Tcw.numpy(), np.asarray(rj.Tcw), atol=1e-4)


def test_align_scan_parity(large):
    """The full-pool scan: world 1 in the port, a one-device mesh in JAX;
    the same argmin near the query, errors within rtol 1e-4 / atol 1e-6."""
    _, et = tdal.distributed_align_scan(TCAM, large["ms"], large["fr"].pyramid, scale_factor=SF,
                                        n_levels=N_LEVELS, store_min_level=KF_STORE_MIN_LEVEL)
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    _, ej = jdal.distributed_align_scan(mesh, JCAM, large["jms"], large["jf"]["pyramid"],
                                        scale_factor=SF, n_levels=N_LEVELS,
                                        store_min_level=KF_STORE_MIN_LEVEL)
    et, ej = et.numpy(), np.asarray(ej)
    assert et.shape == ej.shape == (N_KF,)
    np.testing.assert_array_equal(np.isfinite(et), np.isfinite(ej))
    assert int(np.argmin(et)) == int(np.argmin(ej))
    assert abs(int(np.argmin(et)) - Q) <= 2
    ok = np.isfinite(ej)
    np.testing.assert_allclose(et[ok], ej[ok], rtol=1e-4, atol=1e-6)


def test_local_ba_parity(large):
    """Local BA at slot 77 over a window of several cameras: poses move
    less than 0.05 and agree with JAX within 1e-4, points within 1e-3."""
    ms = large["ms"]
    ms2, window = cs.local_ba_window(TCAM, ms, Q, SF)
    print(f"local BA window at slot {Q}: {window}")
    assert window["cameras"] >= 2 and window["optimized"] >= 1 and window["edges"] > 0
    assert window["centre_moved"]
    assert float((ms2.kf_Tcw - ms.kf_Tcw).abs().max()) < 0.05
    jms2 = jba.local_ba(JCAM, large["jms"], jnp.asarray(Q), scale_factor=SF)
    np.testing.assert_allclose(ms2.kf_Tcw.numpy(), np.asarray(jms2.kf_Tcw), atol=1e-4)
    np.testing.assert_allclose(ms2.pt_pos.numpy(), np.asarray(jms2.pt_pos), atol=1e-3)

