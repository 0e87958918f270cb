"""Kernel K5 (the batched photometric GN pass) and the batched aligner that
runs it, against sdslam_tpu on the CPU: the one-evaluation plain version
against the XLA branch of image_align._align_level's gn_terms, vmapped over
the keyframe slots; the batched level's plain loop against JAX's
_align_level lane by lane (GN iterations included); `align_batched`
against jax.vmap(image_align.align) on a map built by the JAX tracker and
carried across with interop; the one-evaluation form as the level at zero
iterations; and the wrappers' output views.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdslam_tpu.geometry import camera as jcam_mod
from sdslam_tpu.geometry import lie as jlie
from sdslam_tpu.ops import sample as jsample
from sdslam_tpu.solvers import image_align as jia
from sdslam_tpu_torch.geometry import lie as tlie
from sdslam_tpu_torch.kernels import accumulate_gn_kernel as gk
from sdslam_tpu_torch.pipeline import relocalization as treloc
from sdslam_tpu_torch.solvers import image_align as tia
from test_torch_relocalization import JCAM, TCAM, build_jax_map, carry, frame_inputs

torch.set_num_threads(2)

STORE = 2  # keyframes store pyramid levels >= 2


@pytest.fixture(scope="module")
def maps():
    tj, seq = build_jax_map()
    fr, t = frame_inputs(seq, 5)
    return tj.ms, carry(tj.ms), fr, t


def _xla_gn_terms(cur_img, Xc, ref_patch, J, ok, fx, fy, cx, cy):
    """sdslam_tpu/solvers/image_align.py:153-167, the XLA branch of
    _align_level's gn_terms, returning the unnormalized chi2 sum and n."""
    z_ok = Xc[:, 2] > 0.01
    u = fx * Xc[:, 0] / jnp.maximum(Xc[:, 2], 1e-6) + cx
    v = fy * Xc[:, 1] / jnp.maximum(Xc[:, 2], 1e-6) + cy
    cur, cur_ok = jsample.sample_bilinear_patch(cur_img, jnp.stack([u, v], -1), jia.PATCH_HALF)
    m = ok & cur_ok & z_ok[:, None]
    r = jnp.where(m, (cur - ref_patch) / 255.0, 0.0)
    b = jnp.einsum("npi,np->i", jnp.where(m[..., None], J, 0.0), r)
    return b, jnp.sum(r * r), jnp.sum(m)


@pytest.mark.parametrize("level", [3, 2])
def test_plain_k5_matches_xla_gn_terms(maps, level):
    """Every keyframe slot as a lane (invalid slots give all-masked lanes),
    at an iterate perturbed from identity: n exact; chi2_sum and b within
    rtol 1e-5 (float32 sums over ~8k taps in another order), b with an
    absolute floor of 1e-6 of its largest entry for components that cancel
    to about zero."""
    _, ms, _, t = maps
    K = ms.K
    s = 0.5**level
    uv, X_ref, valid = treloc.pool_alignment_inputs(TCAM, ms)
    patch, J, ok = tia._precompute_level(ms.kf_pyramid[level - STORE], uv * s, X_ref, valid,
                                         TCAM.fx * s, TCAM.fy * s)
    rng = np.random.default_rng(level)
    xi = (rng.normal(size=(K, 6)) * [0.01, 0.01, 0.01, 0.005, 0.005, 0.005]).astype(np.float32)
    Xc = tlie.se3_apply(tlie.se3_exp(torch.from_numpy(xi))[:, None], X_ref)
    img = t["pyramid"][level]
    intr = (TCAM.fx * s, TCAM.fy * s, TCAM.cx * s, TCAM.cy * s)
    b, chi2, n = gk.accumulate_gn(img, Xc, patch, J, ok, *intr)
    bj, chi2j, nj = jax.vmap(_xla_gn_terms, in_axes=(None, 0, 0, 0, 0) + (None,) * 4)(
        jnp.asarray(img.numpy()), *(jnp.asarray(a.numpy()) for a in (Xc, patch, J, ok)), *intr)
    np.testing.assert_array_equal(n.numpy(), np.asarray(nj))
    assert (n.numpy() > 0).sum() >= 3
    np.testing.assert_allclose(chi2.numpy(), np.asarray(chi2j), rtol=1e-5, atol=1e-12)
    bj = np.asarray(bj)
    np.testing.assert_allclose(b.numpy(), bj, rtol=1e-5, atol=1e-6 * np.abs(bj).max())


@pytest.mark.parametrize("levels", [(3, 2), (3, 3)], ids=["reloc", "loop_detect"])
def test_align_batched_matches_vmapped_align(maps, levels):
    """The batched aligner over every slot against jax.vmap of the JAX
    aligner as relocalization (levels 3 -> 2 at test size) and loop
    detection (coarsest only) run it: the same inf pattern (n_meas < 50),
    finite errors within 1e-4 relative, T within 1e-4 (15 GN iterations of
    float32 sums in another order)."""
    ms_j, ms, fr, t = maps
    max_level, min_level = levels
    cur_j = tuple(fr.pyramid[STORE:])

    def align_one(slot):
        depth = ms_j.kf_depth[slot]
        valid = ms_j.kf_kp_valid[slot] & (depth > 0) & (ms_j.kf_mp[slot] >= 0)
        X_ref = jcam_mod.backproject(JCAM, ms_j.kf_uv_und[slot], jnp.maximum(depth, 1e-3))
        return jia.align(tuple(p[slot] for p in ms_j.kf_pyramid), cur_j, ms_j.kf_uv[slot], X_ref,
                         valid, jnp.eye(4), JCAM.fx, JCAM.fy, JCAM.cx, JCAM.cy,
                         scale_factor=2.0, max_level=max_level, min_level=min_level, iters=15,
                         start_level=STORE)

    rj = jax.vmap(align_one)(jnp.arange(ms_j.K))
    err_j = np.where(np.asarray(rj.n_meas) >= 50, np.asarray(rj.error), np.inf)
    T_rel, err_t = treloc.align_pool(TCAM, ms, tuple(t["pyramid"][STORE:]), max_level=max_level,
                                     min_level=min_level, scale_factor=2.0, store_min_level=STORE)
    err_t = err_t.numpy()
    np.testing.assert_array_equal(np.isinf(err_t), np.isinf(err_j))
    fin = np.isfinite(err_j)
    assert fin.sum() >= 3
    np.testing.assert_allclose(err_t[fin], err_j[fin], rtol=1e-4)
    np.testing.assert_allclose(T_rel.numpy()[fin], np.asarray(rj.T_cur_ref)[fin], atol=1e-4)


def _level_inputs(maps, level=3):
    """One level of the pool alignment (every slot a lane, seeded at the
    identity as align_pool seeds it): lane 0.. as the port precomputes them,
    with the first valid lane's J zeroed (no step: it stops at iteration 1)
    beside the empty slots (no valid tap)."""
    _, ms, _, t = maps
    s = 0.5**level
    uv, X_ref, valid = treloc.pool_alignment_inputs(TCAM, ms)
    patch, J, ok = tia._precompute_level(ms.kf_pyramid[level - STORE], uv * s, X_ref, valid,
                                         TCAM.fx * s, TCAM.fy * s)
    lanes = ok.any(-1).any(-1)
    flat = int(lanes.nonzero()[0])
    J = J.clone()
    J[flat] = 0.0
    T0 = torch.eye(4).expand(ms.K, 4, 4).contiguous()
    intr = (TCAM.fx * s, TCAM.fy * s, TCAM.cx * s, TCAM.cy * s)
    return t["pyramid"][level], X_ref, patch, J, ok, T0, intr, flat


def _jax_level_iterations(cur, T0, X, patch, J, ok, intr, iters):
    """The GN iterations jia._align_level's while_loop runs on one lane: its
    body (the XLA gn_terms, _solve6, the warp update and the stop test),
    counted."""
    H = jnp.einsum("npi,npj->ij", jnp.where(ok[..., None], J, 0.0), J)
    T, best, it = T0, jnp.inf, 0
    while it < iters:
        b, chi_sum, n = _xla_gn_terms(cur, jlie.se3_apply(T, X), patch, J, ok, *intr)
        chi2 = chi_sum / jnp.maximum(n, 1)
        improved = bool(chi2 < best)
        best = jnp.minimum(chi2, best)
        delta = jia._solve6(H, b)
        T = T @ jlie.se3_exp(-delta)
        stop = bool(jnp.max(jnp.abs(delta)) < 1e-7) or (it > 0 and not improved)
        it += 1
        if stop:
            break
    return it


# jia._align_level jitted once for every lane (eagerly it re-traces and
# compiles its while_loop on each call); fused and the intrinsics static, as
# the eager call's Python constants
_jax_align_level = jax.jit(jia._align_level, static_argnums=(6, 7, 8, 9, 10),
                           static_argnames=("fused",))


def test_batched_level_plain_matches_jax_lane_by_lane(maps):
    """K5's batched level (plain on the CPU) against JAX's _align_level
    (fused=False), lane by lane over every slot: T within 1e-4, chi2 within
    1e-4 relative, n_px equal, and each lane's GN iterations equal to the
    JAX loop's, including the empty slots and a lane with J = 0 (no step:
    both stop at iteration 1)."""
    img, X_ref, patch, J, ok, T0, intr, flat = _level_inputs(maps)
    L = tia._damped_cholesky(J, ok)
    T, chi2, n, steps = gk.align_level_batched_steps(img, X_ref, patch, J, ok, L, T0, *intr, 15)
    empty = ~ok.any(-1).any(-1)
    assert bool(empty.any()) and int(steps[flat]) == 1 and bool((steps[empty] == 1).all())
    assert int(steps.max()) > 2
    cur = jnp.asarray(img.numpy())
    for b in range(X_ref.shape[0]):
        args = [jnp.asarray(a[b].numpy()) for a in (T0, X_ref, patch, J, ok)]
        Tj, chi2j, nj = _jax_align_level(cur, *args, *intr, 15, fused=False)
        np.testing.assert_allclose(T[b].numpy(), np.asarray(Tj), atol=1e-4, err_msg=f"lane {b}")
        np.testing.assert_allclose(float(chi2[b]), float(chi2j), rtol=1e-4, err_msg=f"lane {b}")
        assert int(n[b]) == int(nj), b
        T0j, Xj, pj, Jj, okj = args
        assert int(steps[b]) == _jax_level_iterations(cur, T0j, Xj, pj, Jj, okj, intr, 15), b


def test_batched_level_wrapper_is_plain_on_cpu(maps):
    """On CPU tensors the batched-level wrapper is exactly its plain loop,
    with no kernel launch, and _align_level_batched goes through it."""
    img, X_ref, patch, J, ok, T0, intr, _ = _level_inputs(maps)
    L = tia._damped_cholesky(J, ok)
    before = (gk.LAUNCHES, gk.LEVEL_LAUNCHES)
    a = gk.align_level_batched(img, X_ref, patch, J, ok, L, T0, *intr, 15)
    b = gk.align_level_batched_steps(img, X_ref, patch, J, ok, L, T0, *intr, 15)[:3]
    c = tia._align_level_batched(img, T0, X_ref, patch, J, ok, *intr, 15)
    assert (gk.LAUNCHES, gk.LEVEL_LAUNCHES) == before
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_accumulate_gn_is_level_at_zero_iterations(maps):
    """K5's one-evaluation contract is the batched level at zero iterations
    on X = Xc, T = I (on the plain versions): se3_apply with the identity is
    exact in float32, the level returns T = I, the chi2 sum over the
    clamped count, that count, and no GN iteration."""
    img, X_ref, patch, J, ok, _, intr, _ = _level_inputs(maps)
    B = X_ref.shape[0]
    rng = np.random.default_rng(7)
    xi = (rng.normal(size=(B, 6)) * [0.01, 0.01, 0.01, 0.005, 0.005, 0.005]).astype(np.float32)
    Xc = tlie.se3_apply(tlie.se3_exp(torch.from_numpy(xi))[:, None], X_ref)
    eye = torch.eye(4).expand(B, 4, 4).contiguous()
    assert torch.equal(tlie.se3_apply(eye[:, None], Xc), Xc)
    b, chi_sum, n = gk.accumulate_gn_plain(img, Xc, patch, J, ok, *intr)
    L = tia._damped_cholesky(J, ok)
    T, chi2, n1, steps = gk.align_level_batched_steps(img, Xc, patch, J, ok, L, eye, *intr, 0)
    assert torch.equal(T, eye) and bool((steps == 0).all())
    assert torch.equal(n1, torch.clamp(n, min=1))
    assert torch.equal(chi2, chi_sum / torch.clamp(n, min=1))
    assert bool((n == 0).any()) and bool((n > 0).sum() >= 3)


def test_kernel_output_views_contract():
    """The views the wrappers make of the batched kernel's buffers have the
    plain versions' types and shapes, without a copy: the level's [19B]
    words as T [B,4,4] f32, chi2 [B] f32, n_px [B] int32 and the GN
    iterations [B] int32; accumulate_gn's [8B] words as b [B,6] f32,
    chi2_sum [B] f32 and n [B] int32."""
    B = 5
    rng = np.random.default_rng(0)
    T = torch.from_numpy(rng.normal(size=(B, 4, 4)).astype(np.float32))
    chi2 = torch.from_numpy(rng.uniform(size=B).astype(np.float32))
    n = torch.arange(1, B + 1, dtype=torch.int32)
    it = torch.arange(B, dtype=torch.int32) + 3
    out = torch.zeros(19 * B, dtype=torch.float32)
    out[:16 * B] = T.reshape(-1)
    out[16 * B:17 * B] = chi2
    out.view(torch.int32)[17 * B:18 * B] = n
    out.view(torch.int32)[18 * B:19 * B] = it
    views = gk._level_views(out, B)
    for v, p in zip(views, (T, chi2, n, it)):
        assert (v.dtype, v.shape) == (p.dtype, p.shape) and torch.equal(v, p)
        assert v.untyped_storage().data_ptr() == out.untyped_storage().data_ptr()
    b = torch.from_numpy(rng.normal(size=(B, 6)).astype(np.float32))
    out = torch.zeros(8 * B, dtype=torch.float32)
    out[:6 * B] = b.reshape(-1)
    out[6 * B:7 * B] = chi2
    out.view(torch.int32)[7 * B:8 * B] = n
    views = gk._views(out, B)
    for v, p in zip(views, (b, chi2, n)):
        assert (v.dtype, v.shape) == (p.dtype, p.shape) and torch.equal(v, p)
        assert v.untyped_storage().data_ptr() == out.untyped_storage().data_ptr()
