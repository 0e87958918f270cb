"""Loop closing of the port against sdslam_tpu's on the CPU, at test size
(320x240, 512 keypoints, 4 levels, 32 keyframe slots): detection, Sim3
verification with the same RANSAC sets, pose correction, seam fusion, the
Sim3 pose graph, Umeyama, global BA and the consistency chain of the loop
closer. The map is built by the JAX tracker over the orbit of
tests/test_relocalization.py, revisit keyframes are inserted with drifted
poses (as tests/test_loop_closing.py does), and the state is carried
across with interop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdslam_tpu.features import matching as jmatching
from sdslam_tpu.geometry import lie as jlie
from sdslam_tpu.mapping import map_state as JM
from sdslam_tpu.ops import hamming as jham
from sdslam_tpu.pipeline import loop_closing as JLC
from sdslam_tpu.solvers import ba as jba
from sdslam_tpu.solvers import pose_graph as jpg
from sdslam_tpu.solvers import sim3_solver as jsim3
from sdslam_tpu_torch import interop
from sdslam_tpu_torch.mapping import map_state as TM
from sdslam_tpu_torch.pipeline import loop_closing as TLC
from sdslam_tpu_torch.solvers import ba as tba
from sdslam_tpu_torch.solvers import pose_graph as tpg
from sdslam_tpu_torch.solvers import sim3_solver as tsim3
from test_loop_closing import _insert_revisit_kf
from test_sim3_posegraph import _ring_problem
from test_torch_relocalization import JCAM, TCAM, build_jax_map, carry, jax_cfg, np_tree

torch.set_num_threads(2)

DRIFT = np.array([0.05, -0.03, 0.04, 0.01, -0.02, 0.01], np.float32)
GAP = 50  # min_frame_gap: the revisit keyframes carry frame ids >= 500


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def loop_map():
    """The JAX tracker over 12 orbit frames plus a revisit keyframe of
    frame 0 at a drifted pose. Returns (tracker, seq, revisit slot,
    candidate slot, JAX covis)."""
    tj, seq = build_jax_map()
    drift = np.asarray(jlie.se3_exp(jnp.asarray(DRIFT)))
    slot = _insert_revisit_kf(tj, seq, jax_cfg(), 0, drift @ np.asarray(seq.poses[0]), 500)
    covis = JM.covisibility(tj.ms)
    cand = JLC.detect_loop_candidates(JCAM, tj.ms, jnp.asarray(slot), covis, scale_factor=2.0,
                                      n_levels=4, min_frame_gap=GAP)
    assert bool(cand.found)
    return tj, seq, slot, int(cand.cand_kf), covis


def test_detect_loop_candidates_parity(loop_map):
    """The same candidate; per-slot errors with the same inf pattern and
    finite entries within 1e-4 relative (15 GN iterations of float32 sums
    in another order), or 1e-9 absolute: the candidate shows the revisit's
    own image, so its error is float32 noise about zero (~1e-15). The
    covisibility it is gated by is exact."""
    tj, _, slot, cand, covis = loop_map
    ms = carry(tj.ms)
    covis_t = TM.covisibility(ms)
    np.testing.assert_array_equal(covis_t.numpy(), np.asarray(covis))
    cj = JLC.detect_loop_candidates(JCAM, tj.ms, jnp.asarray(slot), covis, scale_factor=2.0,
                                    n_levels=4, min_frame_gap=GAP)
    ct = TLC.detect_loop_candidates(TCAM, ms, slot, covis_t, scale_factor=2.0, n_levels=4,
                                    min_frame_gap=GAP)
    assert bool(ct.found) and int(ct.cand_kf) == cand
    ej, et = np.asarray(cj.errors), ct.errors.numpy()
    np.testing.assert_array_equal(np.isinf(et), np.isinf(ej))
    fin = np.isfinite(ej)
    np.testing.assert_allclose(et[fin], ej[fin], rtol=1e-4, atol=1e-9)


def _jax_ransac_sets(ms, cur, cand, key, n_hyp=128):
    """The index sets verify_loop_sim3's RANSAC draws: jax.random.choice
    over the brute-force pairs with bound points on both sides."""
    v1 = ms.kf_kp_valid[cur] & (ms.kf_mp[cur] >= 0)
    v2 = ms.kf_kp_valid[cand] & (ms.kf_mp[cand] >= 0)
    pair = jmatching.search_brute_force(ms.kf_desc[cur], v1, ms.kf_desc[cand], v2,
                                        th_desc=jham.TH_LOW, ratio=0.75).kp_to_query
    p_cur = ms.kf_mp[cur][jnp.clip(pair, 0, ms.N - 1)]
    ok = (pair >= 0) & (ms.kf_mp[cand] >= 0) & (p_cur >= 0)
    p = ok.astype(jnp.float32)
    return jax.random.choice(key, ms.N, shape=(n_hyp, 3), p=p / jnp.maximum(p.sum(), 1e-6))


@pytest.fixture(scope="module")
def verified(loop_map):
    tj, _, slot, cand, covis = loop_map
    key = jax.random.key(0)
    vj = JLC.verify_loop_sim3(JCAM, tj.ms, jnp.asarray(slot), jnp.asarray(cand), key,
                              covis=covis, scale_factor=2.0, fix_scale=True)
    sets = _t(_jax_ransac_sets(tj.ms, slot, cand, key))
    vt = TLC.verify_loop_sim3(TCAM, carry(tj.ms), slot, cand, covis=_t(covis), sets=sets,
                              scale_factor=2.0, fix_scale=True)
    return vj, vt


def test_verify_loop_sim3_same_sets(verified, loop_map):
    """Accepted on both sides, the same Sim3 GN inlier count (+-2 for
    float32 chi2 at the 10.0 gate), S within 1e-4 (five plus ten GN steps
    after an SVD-based RANSAC fit), and S maps the revisit onto the truth
    (< 2 cm)."""
    vj, vt = verified
    tj, seq, slot, cand, _ = loop_map
    assert bool(vj.accepted) and bool(vt.accepted)
    assert abs(int(vj.n_inliers) - int(vt.n_inliers)) <= 2
    np.testing.assert_allclose(vt.S_cur_cand.numpy(), np.asarray(vj.S_cur_cand), atol=1e-4)
    T_corr = vt.S_cur_cand.numpy() @ np.asarray(tj.ms.kf_Tcw[cand])
    e = np.asarray(jlie.se3_log(jnp.asarray(T_corr @ np.linalg.inv(np.asarray(seq.poses[0])))))
    assert np.abs(e[:3]).max() < 0.02


@pytest.fixture(scope="module")
def corrected(loop_map, verified):
    tj, _, slot, cand, covis = loop_map
    S = verified[0].S_cur_cand
    msj, ndj = JLC.correct_loop_poses(tj.ms, jnp.asarray(slot), jnp.asarray(cand), S, covis)
    mst, ndt = TLC.correct_loop_poses(carry(tj.ms), slot, cand, _t(S), _t(covis))
    return msj, ndj, mst, ndt


def test_correct_loop_poses_parity(corrected, loop_map):
    """The same verified S on both sides: keyframe poses within 1e-4 and
    points within 1e-4 m after the 20-iteration Sim3 pose graph; the loop
    edge table and the dropped-edge count equal."""
    msj, ndj, mst, ndt = corrected
    _, _, slot, cand, _ = loop_map
    np.testing.assert_allclose(mst.kf_Tcw.numpy(), np.asarray(msj.kf_Tcw), atol=1e-4)
    np.testing.assert_allclose(mst.pt_pos.numpy(), np.asarray(msj.pt_pos), atol=1e-4)
    np.testing.assert_array_equal(mst.loop_edges.numpy(), np.asarray(msj.loop_edges))
    assert int(ndt) == int(ndj)
    le = mst.loop_edges.numpy()
    assert ((le[:, 0] == slot) & (le[:, 1] == cand)).any()


def test_fuse_loop_points_parity(corrected, loop_map):
    """Seam fusion on the same corrected map: the keypoint->point table and
    the point validity exact."""
    msj, _, _, _ = corrected
    _, _, slot, cand, _ = loop_map
    covis = JM.covisibility(msj)
    fj = JLC.fuse_loop_points(JCAM, msj, jnp.asarray(slot), jnp.asarray(cand), covis,
                              scale_factor=2.0)
    ft = TLC.fuse_loop_points(TCAM, carry(msj), slot, cand, _t(covis), scale_factor=2.0)
    np.testing.assert_array_equal(ft.kf_mp.numpy(), np.asarray(fj.kf_mp))
    np.testing.assert_array_equal(ft.pt_valid.numpy(), np.asarray(fj.pt_valid))
    assert int(ft.pt_valid.sum()) < int(np.asarray(msj.pt_valid).sum())


def test_global_ba_parity(corrected):
    """Global BA (5 + 10 LM iterations, K3's plain version at 32 slots) on
    the corrected map: poses within 1e-4, points within 1e-3 m (a few
    weakly observed points move by float32 rounding of the Schur solve),
    the outlier erasures of the keypoint->point table exact."""
    msj = corrected[0]
    gj = jba.global_ba(JCAM, msj, scale_factor=2.0)
    gt = tba.global_ba(TCAM, carry(msj), scale_factor=2.0)
    np.testing.assert_allclose(gt.kf_Tcw.numpy(), np.asarray(gj.kf_Tcw), atol=1e-4)
    np.testing.assert_allclose(gt.pt_pos.numpy(), np.asarray(gj.pt_pos), atol=1e-3)
    np.testing.assert_array_equal(gt.kf_mp.numpy(), np.asarray(gj.kf_mp))


def test_pose_graph_ring_parity():
    """tests/test_sim3_posegraph.py's 10-keyframe ring with one loop edge:
    the same edge set and optimized poses within 1e-4."""
    T_gt, _, kf_S, valid, parent, covis, n_kf = _ring_problem(np.random.default_rng(7))
    S_loop = (T_gt[n_kf - 1] @ np.linalg.inv(T_gt[0]))[None].astype(np.float32)
    ej, _ = jpg.make_edges_from_covisibility(
        kf_S, valid, covis, parent, loop_i=jnp.asarray([n_kf - 1]), loop_j=jnp.asarray([0]),
        loop_S=jnp.asarray(S_loop), covis_min=100, max_edges=64)
    et, _ = tpg.make_edges_from_covisibility(
        _t(kf_S), _t(valid), _t(covis), _t(parent), loop_i=torch.tensor([n_kf - 1]),
        loop_j=torch.tensor([0]), loop_S=_t(S_loop), covis_min=100, max_edges=64)
    for a, b in ((et.i, ej.i), (et.j, ej.j), (et.weight, ej.weight)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(et.S_ij.numpy(), np.asarray(ej.S_ij), atol=1e-5)
    fixed = np.arange(kf_S.shape[0]) == 0
    Sj = jpg.optimize_pose_graph(kf_S, valid, jnp.asarray(fixed), ej, iters=30)
    St = tpg.optimize_pose_graph(_t(kf_S), _t(valid), _t(fixed), et, iters=30)
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), atol=1e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_umeyama_parity(fix_scale):
    """Weighted Umeyama on noisy pairs with a mask: R, t, s within 1e-5."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(60, 3)).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(np.array([0.2, -0.1, 0.3], np.float32))))
    Y = (1.3 * X @ R.T + [0.5, -0.2, 1.0] + rng.normal(size=(60, 3)) * 0.01).astype(np.float32)
    m = rng.uniform(size=60) < 0.8
    rj = jsim3.umeyama_sim3(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(m), fix_scale=fix_scale)
    rt = tsim3.umeyama_sim3(_t(X), _t(Y), _t(m), fix_scale=fix_scale)
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_consistency_chain_process_keyframe(loop_map):
    """Three revisit keyframes (frames 0, 1, 0 at drifted poses) through
    LoopCloser.process_keyframe on both sides, the port on the JAX map of
    each step: the consistency state after each detection exact, the same
    detections, and a verified correction at the third with the revisit
    pose pulled to within half the drift of the truth."""
    tj, seq, _, _, _ = loop_map
    ms_before = tj.ms  # restored below: the fixture's map stays as it was
    drift = np.asarray(jlie.se3_exp(jnp.asarray(DRIFT)))
    kw = dict(scale_factor=2.0, n_levels=4, fix_scale=True, run_gba=False, min_frame_gap=GAP)
    cj, ct = JLC.LoopCloser(cam=JCAM, **kw), TLC.LoopCloser(cam=TCAM, **kw)
    try:
        _chain(tj, seq, drift, cj, ct)
    finally:
        tj.ms = ms_before


def _chain(tj, seq, drift, cj, ct):
    for k, fidx in enumerate((0, 1, 0)):
        slot = _insert_revisit_kf(tj, seq, jax_cfg(), fidx, drift @ np.asarray(seq.poses[fidx]),
                                  500 + 10 * k)
        ms_t = carry(tj.ms)
        tj.ms, ij = cj.process_keyframe(tj.ms, slot)
        ms_t, it = ct.process_keyframe(ms_t, slot)
        assert (ct._cons is None) == (cj._cons is None)
        if cj._cons is not None:
            got = interop.consistency_state_to_numpy(ct._cons)
            for f, v in np_tree(cj._cons).items():
                np.testing.assert_array_equal(got[f], v)
        drop = ("sim3_inliers",)
        assert {a: b for a, b in it.items() if a not in drop} == \
            {a: b for a, b in ij.items() if a not in drop}
    assert it.get("corrected")
    err = ms_t.kf_Tcw[slot].numpy() @ np.linalg.inv(np.asarray(seq.poses[0]))
    after = np.abs(np.asarray(jlie.se3_log(jnp.asarray(err)))[:3]).max()
    assert after < 0.5 * np.abs(DRIFT[:3]).max()
