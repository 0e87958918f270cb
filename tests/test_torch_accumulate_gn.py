"""Kernel K5 (the batched photometric GN right-hand side) and the batched
aligner that runs it, against sdslam_tpu on the CPU: the plain version
against the XLA branch of image_align._align_level's gn_terms, vmapped over
the keyframe slots, and `align_batched` against jax.vmap(image_align.align)
on a map built by the JAX tracker and carried across with interop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdslam_tpu.geometry import camera as jcam_mod
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
