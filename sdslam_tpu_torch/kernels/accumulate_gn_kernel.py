"""K5: the photometric GN pass of B alignment lanes against one level image
(csrc/accumulate_gn.cu, the AL_CHOL and AL_TERMS modes of the level kernel
in csrc/sd_align.cuh that K1 shares).

Port of sdslam_tpu/ops/pallas/align_kernel.py::accumulate_gn, batched over
a leading lane axis: relocalization aligns every keyframe against the
current frame and loop detection every keyframe against the new keyframe,
so all lanes share one current image.

- `align_level_batched`: a whole GN level for every lane in one launch,
  the non-fused loop of sdslam_tpu/solvers/image_align.py:_align_level
  that the JAX package vmaps (per lane its own T, best T, best chi2 and
  stop flag; the step solved with the lane's damped Cholesky factor; the
  final evaluation and rollback). Its plain version is that loop over the
  lane axis, with a per-lane active mask (`align_level_batched_steps` also
  returns each lane's GN iterations).
- `accumulate_gn`: the TPU kernel's own contract, one evaluation at points
  already in the current camera: the level kernel at zero iterations with
  T = I. Its plain version is the XLA branch of _align_level's gn_terms
  over the lane axis.
"""

from __future__ import annotations

import ctypes

import torch

from sdslam_tpu_torch import _device
from sdslam_tpu_torch.geometry import lie
from sdslam_tpu_torch.kernels import _build, count_launch
from sdslam_tpu_torch.kernels import align_kernel as ak
from sdslam_tpu_torch.ops import sample

LAUNCHES = 0  # accumulate_gn launches
LEVEL_LAUNCHES = 0  # align_level_batched launches
PATCH_HALF = 2
PATCH = (2 * PATCH_HALF) ** 2


def accumulate_gn_plain(img, Xc, ref_patch, J, okpx, fx: float, fy: float, cx: float, cy: float):
    """img [H,W], Xc [B,N,3], ref_patch [B,N,16], J [B,N,16,6], okpx
    [B,N,16] -> (b [B,6], chi2_sum [B], n [B] int32)."""
    B, N = Xc.shape[:2]
    z = Xc[..., 2]
    zs = torch.clamp(z, min=1e-6)
    u = fx * Xc[..., 0] / zs + cx
    v = fy * Xc[..., 1] / zs + cy
    cur, cur_ok = sample.sample_bilinear_patch(img, torch.stack([u, v], -1).reshape(B * N, 2),
                                               PATCH_HALF)
    cur, cur_ok = cur.reshape(B, N, PATCH), cur_ok.reshape(B, N, PATCH)
    m = okpx & cur_ok & (z > 0.01)[..., None]
    r = torch.where(m, (cur - ref_patch) / 255.0, torch.zeros_like(cur))
    b = torch.einsum("bnpi,bnp->bi", torch.where(m[..., None], J, torch.zeros_like(J)), r)
    return b, (r * r).sum((1, 2)), m.sum((1, 2)).to(torch.int32)


def accumulate_gn(img, Xc, ref_patch, J, okpx, fx: float, fy: float, cx: float, cy: float):
    """One launch for all B lanes on the card; the plain version for CPU
    tensors. Returns (b [B,6], chi2_sum [B], n [B] int32)."""
    if not _device.use_kernel(img, Xc, ref_patch, J, okpx):
        return accumulate_gn_plain(img, Xc, ref_patch, J, okpx, fx, fy, cx, cy)
    B = Xc.shape[0]
    N, H, W = ak.check_level_inputs("accumulate_gn", img, Xc, ref_patch, J, okpx, (B,))
    out = torch.empty(8 * B, dtype=torch.float32, device=img.device)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.bind("accumulate_gn", "sd_accumulate_gn",
                     [vp, ci, ci, vp, vp, vp, vp, ci, ci, cf, cf, cf, cf, vp, vp])
    rc = fn(img.data_ptr(), H, W, Xc.data_ptr(), ref_patch.data_ptr(), J.data_ptr(),
            okpx.data_ptr(), B, N, float(fx), float(fy), float(cx), float(cy), out.data_ptr(),
            _device.stream_ptr(img))
    _build.check(rc, "sd_accumulate_gn")
    count_launch(__name__)
    return _views(out, B)


def _views(out: torch.Tensor, B: int):
    """accumulate_gn's output [8B] as (b [B,6] f32, chi2_sum [B] f32, n [B]
    int32): views, no copy."""
    return out[:6 * B].view(B, 6), out[6 * B:7 * B], out.view(torch.int32)[7 * B:8 * B]


def align_level_batched_steps(img, X_ref, ref_patch, J, okpx, L, T_init,
                              fx: float, fy: float, cx: float, cy: float, iters: int):
    """The plain batched level: (T [B,4,4], chi2 [B], n_px [B] int32, GN
    iterations [B] int32). A vmapped lax.while_loop runs until every lane
    stops and freezes the lanes that did; here the fixed `iters` run with a
    per-lane `active` mask (no host sync per iteration)."""
    B = X_ref.shape[0]
    dev = X_ref.device

    def terms(T):
        Xc = lie.se3_apply(T[:, None], X_ref)
        b, chi_sum, n = accumulate_gn_plain(img, Xc, ref_patch, J, okpx, fx, fy, cx, cy)
        n = torch.clamp(n, min=1)
        return b, chi_sum / n, n

    T = T_init
    best_T = T
    best = torch.full((B,), float("inf"), device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    steps = torch.zeros((B,), dtype=torch.int32, device=dev)
    for it in range(iters):
        b, chi2, _ = terms(T)
        improved = chi2 < best
        best_T = torch.where((active & improved)[:, None, None], T, best_T)
        best = torch.where(active, torch.minimum(chi2, best), best)
        delta = torch.cholesky_solve(b[..., None], L)[..., 0]
        T_next = T @ lie.se3_exp(-delta)
        stop = (delta.abs().amax(-1) < 1e-7) | ((it > 0) & ~improved)
        T = torch.where(active[:, None, None], T_next, T)
        steps = steps + active.to(torch.int32)
        active = active & ~stop
    # the last iterate was never chi2-evaluated inside the loop
    _, chi2_T, n_T = terms(T)
    T_out = torch.where((chi2_T <= best)[:, None, None], T, best_T)
    return T_out, torch.minimum(chi2_T, best), n_T, steps


def align_level_batched_plain(img, X_ref, ref_patch, J, okpx, L, T_init,
                              fx: float, fy: float, cx: float, cy: float, iters: int):
    """Returns (T [B,4,4], chi2 [B], n_px [B] int32)."""
    return align_level_batched_steps(img, X_ref, ref_patch, J, okpx, L, T_init,
                                     fx, fy, cx, cy, iters)[:3]


def align_level_batched(img, X_ref, ref_patch, J, okpx, L, T_init,
                        fx: float, fy: float, cx: float, cy: float, iters: int):
    """One GN level for B lanes: one launch on the card, the plain loop for
    CPU tensors. img [H,W], X_ref [B,N,3], ref_patch [B,N,16], J
    [B,N,16,6], okpx [B,N,16], L [B,6,6] (the damped Cholesky factors),
    T_init [B,4,4]. Returns (T [B,4,4], chi2 [B], n_px [B] int32)."""
    if not _device.use_kernel(img, X_ref, ref_patch, J, okpx, L, T_init):
        return align_level_batched_plain(img, X_ref, ref_patch, J, okpx, L, T_init,
                                         fx, fy, cx, cy, iters)
    B = X_ref.shape[0]
    return _level_views(_launch_level(img, X_ref, ref_patch, J, okpx, L, T_init,
                                      fx, fy, cx, cy, iters), B)[:3]


def _level_views(out: torch.Tensor, B: int):
    """The batched level's output [19B] as (T [B,4,4] f32, chi2 [B] f32,
    n_px [B] int32, GN iterations [B] int32): views, no copy. The kernel
    writes each T whole, bottom row [0, 0, 0, 1] included."""
    iw = out.view(torch.int32)
    return out[:16 * B].view(B, 4, 4), out[16 * B:17 * B], iw[17 * B:18 * B], iw[18 * B:19 * B]


def _launch_level(img, X_ref, ref_patch, J, okpx, L, T_init,
                  fx: float, fy: float, cx: float, cy: float, iters: int) -> torch.Tensor:
    """One launch of the batched level on CUDA tensors; returns its buffer."""
    B = X_ref.shape[0]
    N, H, W = ak.check_level_inputs("align_level_batched", img, X_ref, ref_patch, J, okpx, (B,))
    _device.check_tensor("L", L, torch.float32, (B, 6, 6))
    _device.check_tensor("T_init", T_init, torch.float32, (B, 4, 4))
    out = torch.empty(19 * B, dtype=torch.float32, device=img.device)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.bind("accumulate_gn", "sd_align_batched",
                     [vp, ci, ci, vp, vp, vp, vp, ci, ci, vp, vp, cf, cf, cf, cf, ci, vp, vp])
    rc = fn(img.data_ptr(), H, W, X_ref.data_ptr(), ref_patch.data_ptr(), J.data_ptr(),
            okpx.data_ptr(), B, N, L.data_ptr(), T_init.data_ptr(), float(fx), float(fy),
            float(cx), float(cy), int(iters), out.data_ptr(), _device.stream_ptr(img))
    _build.check(rc, "sd_align_batched")
    count_launch(__name__, "LEVEL_LAUNCHES")
    return out


def max_active_clusters(N: int, H: int, W: int) -> int:
    """Lanes the card runs at once at these sizes (one cluster per lane,
    cudaOccupancyMaxActiveClusters)."""
    n = _build.bind("accumulate_gn", "sd_align_batched_max_clusters", [ctypes.c_int] * 3)(N, H, W)
    if n < 0:
        _build.check(-n, "sd_align_batched_max_clusters")
    return n
