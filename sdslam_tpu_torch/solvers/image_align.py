"""Sparse inverse-compositional Lucas-Kanade image alignment on SE(3)
(port of sdslam_tpu/solvers/image_align.py).

Reference patches (4x4) and their 6-DoF Jacobians are cached at each
pyramid level. `align` (one reference, the tracker) runs a level's whole
Gauss-Newton loop in kernel K1 (kernels/align_kernel.py: one launch per
level on the card, the plain loop on the CPU). `align_batched` (B
references against one current pyramid: relocalization and loop
detection, the JAX package's jax.vmap of the non-fused aligner) runs each
level for all lanes in kernel K5's batched form
(kernels/accumulate_gn_kernel.py: one launch per level on the card, the
plain loop on the CPU). Levels run coarse to fine;
`start_level` says which pyramid level entry 0 of the tuples is
(keyframes store levels >= 2). The warp is a pinhole: on a distorted
camera the callers hand over levels remapped to the pinhole camera and
patches at undistorted keypoints, with `level_valid` marking the patches
that would read a remapped pixel from outside the raw image.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from sdslam_tpu_torch.kernels import accumulate_gn_kernel as gk
from sdslam_tpu_torch.kernels import align_kernel as ak
from sdslam_tpu_torch.ops import interp

PATCH_HALF = ak.PATCH_HALF
PATCH_AREA = ak.PATCH


class AlignResult(NamedTuple):
    T_cur_ref: torch.Tensor  # [4,4]
    error: torch.Tensor  # mean squared normalized residual at the finest level
    n_meas: torch.Tensor  # valid pixels in the final evaluation (int32)


def _patch_offsets(device):
    d = torch.arange(-PATCH_HALF, PATCH_HALF, dtype=torch.float32, device=device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)  # [16,2] (x,y)


def _proj_jac_se3(Xc, fx, fy):
    """d(u,v)/d(xi) [...,2,6] for the right-perturbed warp (SVO
    jacobian_xyz2uv), scaled by the level focal lengths."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zi = 1.0 / torch.clamp(z, min=1e-6)
    zi2 = zi * zi
    xy = x * y
    zero = torch.zeros_like(x)
    row_u = torch.stack([zi, zero, -x * zi2, -xy * zi2, 1.0 + x * x * zi2, -y * zi], -1) * fx
    row_v = torch.stack([zero, zi, -y * zi2, -(1.0 + y * y * zi2), xy * zi2, x * zi], -1) * fy
    return torch.stack([row_u, row_v], dim=-2)


def _precompute_level(ref_img, uv_ref_l, X_ref, valid, fx_l, fy_l):
    """(ref_patch [...,N,16], J [...,N,16,6], valid_px [...,N,16]) at one
    level; ref_img [H,W] with [N] points, or [B,H,W] with [B,N] points."""
    uv = uv_ref_l[..., None, :] + _patch_offsets(ref_img.device)
    val, gx, gy, ok = interp.bilinear_sample_with_grad(ref_img, uv)
    Jproj = _proj_jac_se3(X_ref, fx_l, fy_l)
    J = gx[..., None] * Jproj[..., None, 0, :] + gy[..., None] * Jproj[..., None, 1, :]
    return val, J / 255.0, ok & valid[..., None]


def _level_valid(valid, level_valid, i: int):
    """The points a level aligns: `valid`, and where a per-level mask is
    given (a distorted camera's remapped levels, features/frame.py), its
    entry for pyramid entry i."""
    return valid if level_valid is None else valid & level_valid[i]


def _damped_cholesky(J, ok, lm_lambda: float = 1e-5):
    """Cholesky factor [...,6,6] of the IC-LK Hessian with the JAX loop's
    trace-scaled damping (H is constant over a level's iterations)."""
    Jm = torch.where(ok[..., None], J, torch.zeros_like(J))
    H = torch.einsum("...npi,...npj->...ij", Jm, J)
    eye = torch.eye(6, device=J.device)
    tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
    Hr = H + lm_lambda * eye * torch.clamp(tr / 6.0, min=1e-8)[..., None, None]
    return torch.linalg.cholesky_ex(Hr)[0]


def damped_hessian_inverse(J, ok, lm_lambda: float = 1e-5):
    """Inverse of the damped IC-LK Hessian of one lane (K1 applies it)."""
    return torch.cholesky_solve(torch.eye(6, device=J.device), _damped_cholesky(J, ok, lm_lambda))


def align(
    ref_pyramid: Tuple[torch.Tensor, ...],
    cur_pyramid: Tuple[torch.Tensor, ...],
    uv_ref,  # [N,2] keypoint coords at level-0 scale
    X_ref,  # [N,3] points in the reference camera frame
    valid,  # [N] bool
    T_cur_ref_init,  # [4,4]
    fx: float, fy: float, cx: float, cy: float,
    scale_factor: float = 2.0,
    max_level: int = 4,
    min_level: int = 2,
    iters: int = 30,
    start_level: int = 0,
    level_valid=None,  # [L,N] bool per pyramid entry, ANDed with valid (or None)
) -> AlignResult:
    """Coarse-to-fine sparse LK alignment. Returns T with X_cur = T X_ref."""
    T = T_cur_ref_init
    chi2 = torch.zeros((), device=X_ref.device)
    n = torch.zeros((), dtype=torch.int32, device=X_ref.device)
    max_level = min(max_level, len(ref_pyramid) - 1 + start_level)
    min_level = max(min_level, start_level)
    for lvl in range(max_level, min_level - 1, -1):
        s = 1.0 / (scale_factor**lvl)
        ref_img = ref_pyramid[lvl - start_level]
        cur_img = cur_pyramid[lvl - start_level]
        patch, J, ok = _precompute_level(ref_img, uv_ref * s, X_ref,
                                         _level_valid(valid, level_valid, lvl - start_level),
                                         fx * s, fy * s)
        Hinv = damped_hessian_inverse(J, ok)
        T, chi2, n = ak.align_level(
            cur_img.contiguous(), X_ref.contiguous(), patch.contiguous(), J.contiguous(),
            ok.contiguous(), Hinv.contiguous(), T.contiguous(),
            fx * s, fy * s, cx * s, cy * s, iters,
        )
    return AlignResult(T, chi2, n)


def _align_level_batched(cur_img, T, X_ref, ref_patch, J, ok, fx, fy, cx, cy, iters: int):
    """The non-fused GN loop of one level for B lanes at once (the JAX
    package's vmapped lax.while_loop): K5's batched level, one launch per
    level on the card, its plain loop on the CPU. Returns (T [B,4,4], chi2
    [B], n_px [B] int32)."""
    L = _damped_cholesky(J, ok)
    return gk.align_level_batched(cur_img, X_ref.contiguous(), ref_patch, J, ok, L.contiguous(),
                                  T.contiguous(), fx, fy, cx, cy, iters)


def align_batched(
    ref_pyramids: Tuple[torch.Tensor, ...],  # per stored level: [B, H_l, W_l]
    cur_pyramid: Tuple[torch.Tensor, ...],  # per stored level: [H_l, W_l]
    uv_ref,  # [B,N,2] keypoint coords at level-0 scale
    X_ref,  # [B,N,3] points in each reference camera frame
    valid,  # [B,N] bool
    T_cur_ref_init,  # [B,4,4] or [4,4]
    fx: float, fy: float, cx: float, cy: float,
    scale_factor: float = 2.0,
    max_level: int = 4,
    min_level: int = 2,
    iters: int = 30,
    start_level: int = 0,
    level_valid=None,  # [L,B,N] bool per pyramid entry, ANDed with valid (or None)
) -> AlignResult:
    """`align` of B references against one current pyramid (the JAX
    package's jax.vmap of the non-fused aligner). Returns an AlignResult of
    [B]-batched fields."""
    B = X_ref.shape[0]
    T = torch.broadcast_to(T_cur_ref_init, (B, 4, 4)).to(torch.float32)
    chi2 = torch.zeros((B,), device=X_ref.device)
    n = torch.zeros((B,), dtype=torch.int32, device=X_ref.device)
    max_level = min(max_level, len(ref_pyramids) - 1 + start_level)
    min_level = max(min_level, start_level)
    for lvl in range(max_level, min_level - 1, -1):
        s = 1.0 / (scale_factor**lvl)
        ref_img = ref_pyramids[lvl - start_level]
        cur_img = cur_pyramid[lvl - start_level]
        patch, J, ok = _precompute_level(ref_img, uv_ref * s, X_ref,
                                         _level_valid(valid, level_valid, lvl - start_level),
                                         fx * s, fy * s)
        T, chi2, n = _align_level_batched(
            cur_img.contiguous(), T, X_ref, patch.contiguous(), J.contiguous(),
            ok.contiguous(), fx * s, fy * s, cx * s, cy * s, iters,
        )
    return AlignResult(T, chi2, n)
