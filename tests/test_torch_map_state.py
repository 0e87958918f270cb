"""Map-state parity: one scripted sequence of map operations (insert,
create, covisibility, observation lists, statistics, counters, replace,
remove) run on sdslam_tpu and on the port from the same seeded inputs.
Integer and boolean tables must match exactly, floats within 1e-5. The
state travels through interop's numpy converters, which this also tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdslam_tpu.geometry import camera as jcam
from sdslam_tpu.geometry import lie as jlie
from sdslam_tpu.mapping import map_state as JM
from sdslam_tpu_torch import interop
from sdslam_tpu_torch.geometry.camera import CameraModel as TCam
from sdslam_tpu_torch.mapping import map_state as TM

torch.set_num_threads(2)

CAM_ARGS = dict(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320, height=240, bf=32.0)
JC, TC = jcam.CameraModel(**CAM_ARGS), TCam(**CAM_ARGS)
K, P, N = 6, 160, 48
PYR = ((8, 10), (4, 5))
# float fields: positions/normals/distances through f32 means and norms
FTOL = 1e-5


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def assert_same_map(jms, tms):
    a = {k: (v if k == "kf_pyramid" else np.asarray(v)) for k, v in jms._asdict().items()}
    b = interop.map_state_to_numpy(tms)
    for k in a:
        if k == "kf_pyramid":
            for x, y in zip(a[k], b[k]):
                np.testing.assert_allclose(np.asarray(x), y, atol=FTOL, strict=True)
        elif a[k].dtype.kind == "f":
            np.testing.assert_allclose(a[k], b[k], atol=FTOL, err_msg=k, strict=True)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k, strict=True)


def _kf_inputs(rng, k, X, pt_desc):
    """Keyframe k observing a random subset of the points X (world)."""
    xi = np.array([0.05 * k, -0.02 * k, 0.03 * k, 0.01 * k, 0.02 * k, -0.01 * k], np.float32)
    T = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    Xc = np.asarray(jlie.se3_apply(jnp.asarray(T), jnp.asarray(X)))
    uv, z = (np.asarray(a) for a in jcam.project(JC, jnp.asarray(Xc)))
    src = rng.permutation(X.shape[0])[:N]
    desc = pt_desc[src].copy()
    flips = rng.integers(0, 256, size=(N, 6))
    for i in range(N):
        for b in flips[i]:
            desc[i, b // 32] ^= np.uint32(1 << (b % 32))
    return dict(
        Tcw=T, uv=uv[src], uv_und=uv[src], octave=rng.integers(0, 4, N).astype(np.int32),
        angle=rng.uniform(-3, 3, N).astype(np.float32), desc=desc,
        kp_valid=rng.uniform(size=N) < 0.95, depth=z[src].astype(np.float32),
        uright=(uv[src, 0] - 32.0 / z[src]).astype(np.float32),
        pyramid=tuple(rng.uniform(0, 255, s).astype(np.float32) for s in PYR),
    ), src


@pytest.fixture(scope="module")
def scripted():
    """(list of (step name, jax MapState, port MapState), aux outputs)."""
    rng = np.random.default_rng(0)
    X = rng.uniform([-1, -0.8, 1.5], [1, 0.8, 3.5], size=(120, 3)).astype(np.float32)
    pt_desc = rng.integers(0, 2**32, size=(120, 8), dtype=np.uint64).astype(np.uint32)
    jms = JM.init_map(K, P, N, PYR)
    tms = TM.init_map(K, P, N, PYR, device="cpu")
    steps = [("init", jms, tms)]
    ids_of = {}  # scene point index -> map point id
    for k in range(4):
        kw, src = _kf_inputs(rng, k, X, pt_desc)
        assoc = np.array([ids_of.get(int(s), -1) for s in src], np.int32)
        args = [kw[f] for f in ("Tcw", "uv", "uv_und", "octave", "angle", "desc", "kp_valid",
                                "depth", "uright")]
        jms = JM.insert_keyframe(jms, k, *[jnp.asarray(a) for a in args], jnp.asarray(assoc),
                                 tuple(jnp.asarray(p) for p in kw["pyramid"]),
                                 jnp.asarray(10 * k, jnp.int32), jnp.asarray(0.1 * k, jnp.float32),
                                 jnp.asarray(k - 1, jnp.int32))
        tms = TM.insert_keyframe(tms, k, *[_t(a) for a in args], _t(assoc),
                                 tuple(_t(p) for p in kw["pyramid"]),
                                 torch.tensor(10 * k, dtype=torch.int32),
                                 torch.tensor(0.1 * k, dtype=torch.float32),
                                 torch.tensor(k - 1, dtype=torch.int32))
        steps.append((f"insert{k}", jms, tms))
        want = (assoc < 0) & kw["kp_valid"] & (rng.uniform(size=N) < 0.7)
        pos = X[src] + rng.normal(size=(N, 3)).astype(np.float32) * 0.01
        jms, jids = JM.create_points(jms, k, jnp.asarray(want), jnp.asarray(pos))
        tms, tids = TM.create_points(tms, k, _t(want), _t(pos))
        np.testing.assert_array_equal(np.asarray(jids), tids.numpy())
        for s, pid in zip(src, np.asarray(jids)):
            if pid >= 0:
                ids_of[int(s)] = int(pid)
        steps.append((f"create{k}", jms, tms))
    jms = JM.finalize_point_statistics(jms, 2.0, 4)
    tms = TM.finalize_point_statistics(tms, 2.0, 4)
    steps.append(("stats", jms, tms))
    Tq = np.asarray(jlie.se3_exp(jnp.asarray(np.array([0.1, 0, 0.05, 0, 0.03, 0], np.float32))))
    cnt_assoc = np.where(rng.uniform(size=N) < 0.5, rng.integers(0, P, N), -1).astype(np.int32)
    jms = JM.update_tracking_counters(jms, JC, jnp.asarray(Tq), jnp.asarray(cnt_assoc))
    tms = TM.update_tracking_counters(tms, TC, _t(Tq), _t(cnt_assoc))
    steps.append(("counters", jms, tms))
    # merges, including a chain a -> b -> c and a merge into a dead point
    live = np.flatnonzero(np.asarray(jms.pt_valid))
    rep = np.full(P, -1, np.int32)
    rep[live[0]], rep[live[1]] = live[1], live[2]
    rep[live[5]] = live[6]
    rep[live[10]] = P - 1
    jms = JM.replace_points(jms, jnp.asarray(rep))
    tms = TM.replace_points(tms, _t(rep))
    steps.append(("replace", jms, tms))
    kill = np.zeros(P, bool)
    kill[live[20:30]] = True
    jms = JM.remove_points(jms, jnp.asarray(kill))
    tms = TM.remove_points(tms, _t(kill))
    steps.append(("remove_points", jms, tms))
    rows = np.array([False, True, True, False, False, False])
    jms = JM.finalize_point_statistics_local(jms, jnp.asarray(rows), 2.0, 4, max_pts=64)
    tms = TM.finalize_point_statistics_local(tms, _t(rows), 2.0, 4, max_pts=64)
    steps.append(("stats_local", jms, tms))
    kill_kf = np.zeros(K, bool)
    kill_kf[1] = True
    jms = JM.remove_keyframes(jms, jnp.asarray(kill_kf))
    tms = TM.remove_keyframes(tms, _t(kill_kf))
    steps.append(("remove_keyframes", jms, tms))
    return steps


@pytest.mark.parametrize("step", ["init", "insert0", "create0", "insert1", "create1",
                                  "create3", "stats", "counters", "replace", "remove_points",
                                  "stats_local", "remove_keyframes"])
def test_scripted_sequence(scripted, step):
    _, jms, tms = next(s for s in scripted if s[0] == step)
    assert_same_map(jms, tms)


def test_derived_structures(scripted):
    _, jms, tms = next(s for s in scripted if s[0] == "replace")
    inc_j = np.asarray(JM.incidence_matrix(jms)).astype(np.float32)
    inc_t = TM.incidence_matrix(tms).float()  # bfloat16 by default, as JAX's
    np.testing.assert_array_equal(inc_j, inc_t.numpy())
    np.testing.assert_array_equal(np.asarray(JM.covisibility(jms)), TM.covisibility(tms).numpy())
    assert int(TM.covisibility(tms).max()) > 5  # keyframes really share points
    np.testing.assert_array_equal(np.asarray(JM.point_obs_count(jms)),
                                  TM.point_obs_count(tms).numpy())
    for a, b in zip(JM.build_obs_lists(jms, 4), TM.build_obs_lists(tms, 4)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    mask = np.asarray(jms.pt_valid)
    for a, b in zip(JM.compact_indices(jnp.asarray(mask), 40), TM.compact_indices(_t(mask), 40)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    want = np.random.default_rng(4).uniform(size=70) < 0.6
    np.testing.assert_array_equal(
        np.asarray(JM.allocate_slots(jnp.asarray(mask), jnp.asarray(want))),
        TM.allocate_slots(_t(mask), _t(want)).numpy())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_incidence_matrix_dtypes(scripted, dtype):
    """incidence_matrix in either dtype, JAX's default bfloat16 included,
    and covisibility from each (counted in float32 in both packages)."""
    _, jms, tms = next(s for s in scripted if s[0] == "replace")
    inc_j = JM.incidence_matrix(jms, dtype=getattr(jnp, dtype))
    inc_t = TM.incidence_matrix(tms, dtype=getattr(torch, dtype))
    assert inc_t.dtype == getattr(torch, dtype) and str(inc_j.dtype) == dtype
    assert tuple(inc_t.shape) == (K, P) and int(inc_t.float().sum()) > 50
    np.testing.assert_array_equal(np.asarray(inc_j).astype(np.float32), inc_t.float().numpy())
    np.testing.assert_array_equal(np.asarray(JM.covisibility(jms, inc=inc_j)),
                                  TM.covisibility(tms, inc=inc_t).numpy())
    np.testing.assert_array_equal(np.asarray(JM.point_obs_count(jms)),
                                  TM.point_obs_count_from_inc(tms, inc_t).numpy())


def test_interop_round_trip(scripted):
    _, jms, _ = scripted[-1]
    d = {k: (v if k == "kf_pyramid" else np.asarray(v)) for k, v in jms._asdict().items()}
    tms = interop.map_state_from_numpy(d, device="cpu")
    assert_same_map(jms, tms)
    back = interop.map_state_to_numpy(tms)
    assert back["kf_desc"].dtype == np.uint32
    np.testing.assert_array_equal(back["kf_desc"], d["kf_desc"])
