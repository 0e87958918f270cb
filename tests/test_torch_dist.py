"""The port's distributed solvers (sdslam_tpu_torch/parallel: dist_ba,
dist_pose_graph, dist_align, multihost) against the JAX package's on the
8-device virtual CPU mesh of conftest.py.

The port's ranks are gloo processes on the CPU, spawned once for the whole
module by the port's launcher (one group of two ranks runs every solve,
while JAX's solvers run in this process);
its world of one runs in this process, outside any process group. Inputs
come from seeded numpy.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sdslam_tpu.geometry.camera import CameraModel as JCam
from sdslam_tpu.mapping import map_state as JM
from sdslam_tpu.parallel import dist_align as jdal
from sdslam_tpu.parallel import dist_ba as jdba
from sdslam_tpu.parallel import dist_pose_graph as jdpg
from sdslam_tpu_torch.geometry import lie as tlie
from sdslam_tpu_torch.geometry.camera import CameraModel as TCam
from sdslam_tpu_torch.io.synthetic import make_dist_ba_problem
from sdslam_tpu_torch.parallel import dist_align, dist_ba, dist_pose_graph
from sdslam_tpu_torch.parallel import multihost as mh

sys.path.insert(0, os.path.dirname(__file__))
from test_ba import CAM, make_ba_problem  # noqa: E402
from test_dist_pose_graph import _ring_problem  # noqa: E402

torch.set_num_threads(2)

WORLD = 2
TCAM = TCam(**CAM._asdict())
CAM64 = dict(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480, bf=40.0)
SHAPES = ((120, 160), (60, 80), (30, 40))  # stored levels 2..4 of 640x480
QUERY = 5
ALIGN_KW = dict(scale_factor=2.0, n_levels=5, store_min_level=2, iters=8)


def _numpy_map(ms):
    return {k: (tuple(np.asarray(p) for p in v) if k == "kf_pyramid" else np.asarray(v))
            for k, v in ms._asdict().items()}


def _ba_problem():
    ms, T_gt, X_gt, n_kf, n_pt = make_ba_problem(np.random.default_rng(7), noise_px=0.2,
                                                 stereo=True)
    return ms, ms.kf_valid.at[0].set(False)


def _flat_problem():
    """A small make_dist_ba_problem shape whose 1021 points do not divide
    the world (the port pads them)."""
    return make_dist_ba_problem(np.random.default_rng(3), 8, 1021, 4, TCam(**CAM64))


def _pose_graph_problem():
    """The JAX test's ring with 13 keyframes: 13 edges, padded for both
    the mesh and the world."""
    return _ring_problem(K=13, drift=0.05, seed=4)


def _align_problem(K=8, N=256):
    """The multi-chip dry run's pool of textured stored pyramids at K = 8:
    every slot valid, keypoints at depth 2 bound to a point."""
    rng = np.random.default_rng(5)
    freqs = rng.uniform(0.01, 0.12, (K, 6, 2)).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, (K, 6)).astype(np.float32)

    def tex_level(shape, lvl):
        h, w = shape
        s = 2.0 ** (lvl + 2)
        v, u = np.meshgrid(np.arange(h) * s, np.arange(w) * s, indexing="ij")
        ph = (u[None, None] * freqs[:, :, 0, None, None] + v[None, None] * freqs[:, :, 1, None, None]
              + phases[:, :, None, None])
        return (128.0 + 100.0 * np.sin(ph).mean(1)).astype(np.float32)

    pyr = tuple(tex_level(sh, i) for i, sh in enumerate(SHAPES))
    uv = rng.uniform([24, 24], [616, 456], (K, N, 2)).astype(np.float32)
    ms = JM.init_map(K, 512, N, SHAPES)._replace(
        kf_valid=jnp.ones((K,), bool), kf_uv=jnp.asarray(uv), kf_uv_und=jnp.asarray(uv),
        kf_depth=jnp.full((K, N), 2.0, jnp.float32), kf_mp=jnp.zeros((K, N), jnp.int32),
        kf_kp_valid=jnp.ones((K, N), bool), kf_pyramid=tuple(jnp.asarray(p) for p in pyr))
    query = tuple(np.zeros((2, 2), np.float32) for _ in range(2)) + tuple(p[QUERY] for p in pyr)
    return ms, query


@pytest.fixture(scope="module")
def solved():
    """Every solve of this module in both packages: one group of WORLD gloo
    ranks runs the port's, in the background, while JAX's run here on the
    8-device mesh. Returns (the ranks' results, JAX's results)."""
    ms_ba, ca_ba = _ba_problem()
    flat = _flat_problem()
    ca_flat = np.arange(8) > 0
    S, _, edges, valid, fixed = _pose_graph_problem()
    ms_al, query = _align_problem()
    calls = [
        (dist_ba.rank_bundle_adjust, (TCAM, _numpy_map(ms_ba), np.asarray(ca_ba),
                                      np.asarray(ms_ba.pt_valid), 10)),
        (dist_ba.rank_gn_steps, (TCam(**CAM64), flat, ca_flat, 2)),
        (dist_pose_graph.rank_pose_graph, (np.asarray(S), np.asarray(valid), np.asarray(fixed),
                                           tuple(np.asarray(a) for a in edges), 15)),
        (dist_align.rank_align_scan, (TCam(**CAM64), _numpy_map(ms_al), query, ALIGN_KW)),
        (mh.rank_layout, (np.arange(12, dtype=np.float32).reshape(6, 2),)),
    ]
    mesh = _mesh()
    # JAX's three solves are three programs; they compile side by side
    jax_solves = {
        "ba": lambda: jdba.distributed_bundle_adjust(mesh, CAM, ms_ba, ca_ba, ms_ba.pt_valid,
                                                     iters=10),
        "pgo": lambda: np.asarray(jdpg.distributed_pose_graph(mesh, S, valid, fixed, edges,
                                                              iters=15)),
        "align": lambda: np.asarray(jdal.distributed_align_scan(
            mesh, JCam(**CAM64), ms_al, tuple(jnp.asarray(q) for q in query), **ALIGN_KW)[1]),
    }
    with ThreadPoolExecutor(1 + len(jax_solves)) as pool:
        ranks = pool.submit(mh.launch, mh.run_calls, WORLD, args=(calls,), backend="gloo",
                            devices="cpu", threads=2, timeout=300.0)
        ref = {k: pool.submit(f) for k, f in jax_solves.items()}
        return ranks.result(), {k: f.result() for k, f in ref.items()}


def _mesh():
    devices = np.array(jax.devices()[:8])
    assert len(devices) == 8, "conftest must provide 8 virtual devices"
    return Mesh(devices, ("dp",))


def _each_rank(ranks, i):
    """Result i of every rank; the ranks must agree bit for bit."""
    first = ranks[0][i]
    for other in ranks[1:]:
        for k, v in first.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(other[i][k], v)
    return first


def test_dist_ba_matches_jax(solved):
    ranks, jax_out = solved
    ref = jax_out["ba"]
    out = _each_rank(ranks, 0)
    np.testing.assert_allclose(out["kf_Tcw"], np.asarray(ref.kf_Tcw), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["pt_pos"], np.asarray(ref.pt_pos), rtol=0, atol=1e-3)


def test_dist_ba_world_one_matches_world_two(solved):
    """Shard invariance: the same problem on one rank and on WORLD ranks
    (only the order of the float sums differs)."""
    flat = _flat_problem()
    one = dist_ba.rank_gn_steps("cpu", TCam(**CAM64), flat, np.arange(8) > 0, 2)
    two = _each_rank(solved[0], 1)
    assert one["X"].shape == (1021, 3) and two["X"].shape == (1021, 3)
    assert np.abs(one["T"] - two["T"]).max() < 5e-4
    assert np.abs(one["X"] - two["X"]).max() < 5e-3
    T0, T_gt = flat[0], flat[7]
    assert np.abs(two["T"] - T_gt).max() < 0.2 * np.abs(T0 - T_gt).max()


def test_dist_pose_graph_matches_jax(solved):
    ranks, jax_out = solved
    S_gt = _pose_graph_problem()[1]
    ref = jax_out["pgo"]
    out = _each_rank(ranks, 2)["S"]
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    e = tlie.sim3_log(torch.from_numpy(out) @ tlie.sim3_inv(torch.tensor(np.asarray(S_gt))))
    assert e.abs().max() < 0.02  # the loop drift is corrected


def test_dist_align_matches_jax(solved):
    ranks, jax_out = solved
    ref = jax_out["align"]
    err = _each_rank(ranks, 3)["errors"]
    assert err.shape == ref.shape == (8,)
    np.testing.assert_array_equal(np.isfinite(err), np.isfinite(ref))
    assert int(np.argmin(err)) == int(np.argmin(ref)) == QUERY and err[QUERY] < 1e-3
    ok = np.isfinite(ref)
    np.testing.assert_allclose(err[ok], ref[ok], rtol=1e-4, atol=1e-6)


def test_global_put_and_fetch(solved, monkeypatch):
    """global_put's rows per rank, the replicated copy, and the gather
    (fetch_replicated's input) on every rank, as JAX's global arrays; the
    card is the default device, and launch has no default backend."""
    arr = np.arange(12, dtype=np.float32).reshape(6, 2)
    for r, res in enumerate(solved[0]):
        out = res[4]
        assert (out["world"], out["rank"]) == (WORLD, r)
        np.testing.assert_array_equal(out["sharded"], arr[3 * r: 3 * r + 3])
        np.testing.assert_array_equal(out["replicated"], arr)
        np.testing.assert_array_equal(out["gathered"], arr)
    # outside a process group the world is one rank holding everything
    assert mh.world() == (1, 0) and mh.global_mesh() is None
    np.testing.assert_array_equal(
        mh.fetch_replicated(mh.global_put(arr, mh.SHARDED, device="cpu")), arr)
    with pytest.raises(ValueError):
        mh.global_put(arr, "tp", device="cpu")
    with pytest.raises(TypeError, match="backend"):
        mh.launch(mh.rank_layout, 1, args=(arr,), devices="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mh.global_put(arr, mh.SHARDED)
