"""Descriptor matching parity: Hamming primitives (kernel K4's plain version
on the CPU) and the projection searches of the tracking path, the port
against sdslam_tpu on seeded descriptors and poses. Every comparison is
exact: distances are integers and associations are indices."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdslam_tpu.features import matching as jm
from sdslam_tpu.geometry import camera as jcam
from sdslam_tpu.geometry import lie as jlie
from sdslam_tpu.ops import hamming as jh
from sdslam_tpu_torch.features import matching as tm
from sdslam_tpu_torch.geometry.camera import CameraModel as TCam
from sdslam_tpu_torch.kernels import hamming_kernel as thk
from sdslam_tpu_torch.ops import hamming as th

torch.set_num_threads(2)

CAM_ARGS = dict(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320, height=240, bf=32.0)
JC, TC = jcam.CameraModel(**CAM_ARGS), TCam(**CAM_ARGS)


def _desc(rng, n):
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)


def _flip(rng, d, n_bits):
    """Flip n_bits random bits of each descriptor row."""
    d = d.copy()
    for i in range(d.shape[0]):
        for b in rng.choice(256, size=n_bits, replace=False):
            d[i, b // 32] ^= np.uint32(1 << (b % 32))
    return d


def _t(a):
    """numpy -> torch; uint32 descriptors travel as int32 bit patterns."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(ja, tt):
    np.testing.assert_array_equal(np.asarray(ja), tt.numpy())


@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (300, 257)])
def test_hamming_matrix_exact(shape):
    rng = np.random.default_rng(shape[0])
    da, db = _desc(rng, shape[0]), _desc(rng, shape[1])
    before = (thk.LAUNCHES, thk.BEST2_LAUNCHES)
    out = th.hamming_matrix(_t(da), _t(db))
    fused = th.masked_best2(_t(da), _t(db), torch.ones(shape, dtype=torch.bool))
    # CPU tensors take the plain versions of both forms
    assert (thk.LAUNCHES, thk.BEST2_LAUNCHES) == before
    _same(jh.hamming_matrix(jnp.asarray(da), jnp.asarray(db)), out)
    for a, b in zip(jh.best2(jh.hamming_matrix(jnp.asarray(da), jnp.asarray(db))), fused):
        _same(a, b)
    n = min(shape)
    _same(jh.hamming_vec(jnp.asarray(da[:n]), jnp.asarray(db[:n])), th.hamming_vec(_t(da[:n]),
                                                                                 _t(db[:n])))


@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (300, 257)])
def test_masked_best2_exact(shape):
    """K4's fused form (plain on the CPU) against JAX's best2(masked_dist):
    duplicated targets make first-minimum ties, and every pair of some rows
    is masked (d1 = BIG at index 0)."""
    na, nb = shape
    rng = np.random.default_rng(100 + na)
    db = _desc(rng, nb)
    db[nb // 2:] = db[:nb - nb // 2]
    da = _flip(rng, db[rng.integers(0, nb, size=na)], 12)
    mask = rng.uniform(size=shape) < 0.5
    mask[::3] = False
    mask[1::3, : (nb + 1) // 2] = True  # both copies of a target: ties
    mask[1::3, nb // 2:] = True
    ja, jb, jm_ = jnp.asarray(da), jnp.asarray(db), jnp.asarray(mask)
    out = th.masked_best2(_t(da), _t(db), torch.from_numpy(mask))
    ref = jh.best2(jh.masked_dist(ja, jb, jm_))
    for a, b in zip(ref, out):
        _same(a, b)
    assert [t.dtype for t in out] == [torch.int32, torch.int64, torch.int32]
    d1, _, d2 = (np.asarray(r) for r in ref)
    assert (d1 == th.BIG).any()
    if nb > 1:
        assert ((d1 == d2) & (d1 < th.BIG)).any()


def test_best2_resolve_rotation_exact():
    rng = np.random.default_rng(7)
    da, db = _desc(rng, 120), _desc(rng, 90)
    db[:60] = _flip(rng, da[:60], 20)  # close pairs, some queries collide below
    mask = rng.uniform(size=(120, 90)) < 0.6
    jd = jh.masked_dist(jnp.asarray(da), jnp.asarray(db), jnp.asarray(mask))
    td = th.masked_dist(_t(da), _t(db), torch.from_numpy(mask))
    _same(jd, td)
    for a, b in zip(jh.best2(jd), th.best2(td)):
        _same(a, b)
    d1, j1, _ = jh.best2(jd)
    q_valid = np.asarray(d1) <= 100
    _same(jh.resolve_to_targets(j1, d1, jnp.asarray(q_valid), 90)[0],
          th.resolve_to_targets(_t(j1).long(), _t(d1), torch.from_numpy(q_valid), 90)[0])
    dtheta = rng.uniform(-np.pi, np.pi, size=200).astype(np.float32)
    dtheta[:120] = rng.normal(size=120).astype(np.float32) * 0.05 + 0.3
    valid = rng.uniform(size=200) < 0.8
    _same(jh.rotation_consistency(jnp.asarray(dtheta), jnp.asarray(valid)),
          th.rotation_consistency(torch.from_numpy(dtheta), torch.from_numpy(valid)))


def _scene(seed, n_pts=400, n_kp=512):
    """World points seen from a pose; keypoints at their noisy projections
    with perturbed descriptors, plus distractor keypoints."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1.5, -1.0, 1.2], [1.5, 1.0, 4.0], size=(n_pts, 3)).astype(np.float32)
    xi = np.array([0.03, -0.02, 0.05, 0.02, -0.03, 0.01], np.float32)
    T = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    uv, _ = jcam.project(JC, jlie.se3_apply(jnp.asarray(T), jnp.asarray(X)))
    uv = np.asarray(uv)
    p_desc = _desc(rng, n_pts)
    p_oct = rng.integers(0, 3, size=n_pts).astype(np.int32)
    n_seen = n_kp * 3 // 4
    src = rng.permutation(n_pts)[:n_seen]
    kp_uv = np.concatenate([uv[src] + rng.normal(size=(n_seen, 2)) * 1.5,
                            rng.uniform([0, 0], [320, 240], size=(n_kp - n_seen, 2))])
    kp_desc = np.concatenate([_flip(rng, p_desc[src], int(rng.integers(5, 60))),
                              _desc(rng, n_kp - n_seen)])
    kp_oct = np.concatenate([np.clip(p_oct[src] + rng.integers(-1, 2, size=n_seen), 0, 3),
                             rng.integers(0, 4, size=n_kp - n_seen)]).astype(np.int32)
    kp_valid = rng.uniform(size=n_kp) < 0.95
    p_valid = rng.uniform(size=n_pts) < 0.9
    return (rng, X, T, p_desc, p_oct, p_valid, kp_uv.astype(np.float32), kp_desc, kp_oct,
            kp_valid)


@pytest.mark.parametrize("radius,rotation", [(8.0, False), (16.0, False), (3.0, True)],
                         ids=["r8", "r16_fallback", "r3_rotation"])
def test_search_by_projection_exact(radius, rotation):
    rng, X, T, p_desc, p_oct, p_valid, kp_uv, kp_desc, kp_oct, kp_valid = _scene(1)
    q_ang = rng.uniform(-np.pi, np.pi, size=X.shape[0]).astype(np.float32)
    kp_ang = rng.uniform(-np.pi, np.pi, size=kp_uv.shape[0]).astype(np.float32)
    a = jm.search_by_projection(
        JC, jnp.asarray(T), jnp.asarray(X), jnp.asarray(p_desc), jnp.asarray(p_valid),
        jnp.asarray(p_oct), jnp.asarray(kp_uv), jnp.asarray(kp_desc), jnp.asarray(kp_valid),
        jnp.asarray(kp_oct), radius_px=radius, q_angle=jnp.asarray(q_ang),
        kp_angle=jnp.asarray(kp_ang), use_rotation=rotation)
    b = tm.search_by_projection(
        TC, torch.from_numpy(T), torch.from_numpy(X), _t(p_desc), torch.from_numpy(p_valid),
        torch.from_numpy(p_oct), torch.from_numpy(kp_uv), _t(kp_desc),
        torch.from_numpy(kp_valid), torch.from_numpy(kp_oct), radius_px=radius,
        q_angle=torch.from_numpy(q_ang), kp_angle=torch.from_numpy(kp_ang),
        use_rotation=rotation)
    _same(a.kp_to_query, b.kp_to_query)
    _same(a.kp_dist, b.kp_dist)
    # random angles: the rotation filter keeps only its 3 dominant bins
    assert int(b.count()) > (20 if rotation else 50)


def test_search_local_points_exact():
    rng, X, T, p_desc, p_oct, p_valid, kp_uv, kp_desc, kp_oct, kp_valid = _scene(2)
    center = np.asarray(jlie.se3_t(jlie.se3_inv(jnp.asarray(T))))
    view = X - center
    dist = np.linalg.norm(view, axis=1)
    normal = view / dist[:, None] + rng.normal(size=X.shape).astype(np.float32) * 0.05
    normal = (normal / np.linalg.norm(normal, axis=1, keepdims=True)).astype(np.float32)
    max_d = (dist * rng.uniform(1.0, 4.0, size=dist.shape)).astype(np.float32)
    min_d = (max_d / 16.0).astype(np.float32)
    a = jm.search_local_points(
        JC, jnp.asarray(T), jnp.asarray(X), jnp.asarray(p_desc), jnp.asarray(p_valid),
        jnp.asarray(normal), jnp.asarray(min_d), jnp.asarray(max_d), jnp.asarray(kp_uv),
        jnp.asarray(kp_desc), jnp.asarray(kp_valid), jnp.asarray(kp_oct), th_radius=3.0,
        scale_factor=2.0, n_levels=4)
    b = tm.search_local_points(
        TC, torch.from_numpy(T), torch.from_numpy(X), _t(p_desc), torch.from_numpy(p_valid),
        torch.from_numpy(normal), torch.from_numpy(min_d), torch.from_numpy(max_d),
        torch.from_numpy(kp_uv), _t(kp_desc), torch.from_numpy(kp_valid),
        torch.from_numpy(kp_oct), th_radius=3.0, scale_factor=2.0, n_levels=4)
    _same(a.kp_to_query, b.kp_to_query)
    _same(a.kp_dist, b.kp_dist)
    assert int(b.count()) > 50
    # the predicted octave (scale band) on its own
    _same(jm.predict_octave(jnp.asarray(dist), jnp.asarray(max_d), 2.0, 4),
          tm.predict_octave(torch.from_numpy(dist.astype(np.float32)),
                            torch.from_numpy(max_d), 2.0, 4))
