"""K1: one whole IC-LK Gauss-Newton alignment level (csrc/align_level.cu).

Port of sdslam_tpu/ops/pallas/align_kernel.py::align_level. The plain
version is the per-iteration XLA loop of
sdslam_tpu/solvers/image_align.py:_align_level (fused=False), with the
damped Hessian inverse Hinv precomputed by the caller as the fused path
does. The kernel (the one-lane case of the level kernel that K5's batched
form shares, csrc/sd_align.cuh) runs a level on a cluster of 8 CTAs and
writes its outputs finished (`_views` of the buffer `_launch` returns;
`_iterations` reads the number of GN iterations it ran). It takes any N:
each CTA stages up to STAGE_MAX points of its share in shared memory and
reads the rest from global memory.
"""

from __future__ import annotations

import ctypes

import torch

from sdslam_tpu_torch import _device
from sdslam_tpu_torch.geometry import lie
from sdslam_tpu_torch.kernels import _build, count_launch
from sdslam_tpu_torch.ops import sample

LAUNCHES = 0
PATCH_HALF = 2
PATCH = (2 * PATCH_HALF) ** 2
# the kernel's output, 20 words: T [4,4], chi2, then n_px and the GN
# iterations as int32, one word unused
OUT_SHAPE = (5, 4)
# a lane's CTAs (AL_CLUSTER in csrc/sd_align.cuh), each taking 1/CLUSTER of
# the points
CLUSTER = 8
# the most points of a CTA's share whose J, patch, mask and X are staged in
# shared memory (AL_STAGE_MAX); the rest of the share is read from global
# memory
STAGE_MAX = 484


def staged_points(N: int) -> int:
    """Points of each CTA's share that a launch stages in shared memory."""
    return min(-(-N // CLUSTER), STAGE_MAX)


def gn_terms(img, X_ref, ref_patch, J, okpx, T, fx, fy, cx, cy):
    """(b [6], chi2, n_px) of the photometric residual at iterate T."""
    Xc = lie.se3_apply(T, X_ref)
    z = Xc[:, 2]
    zs = torch.clamp(z, min=1e-6)
    u = fx * Xc[:, 0] / zs + cx
    v = fy * Xc[:, 1] / zs + cy
    cur, cur_ok = sample.sample_bilinear_patch(img, torch.stack([u, v], -1), PATCH_HALF)
    m = okpx & cur_ok & (z > 0.01)[:, None]
    r = torch.where(m, (cur - ref_patch) / 255.0, torch.zeros_like(cur))
    n = torch.clamp(m.sum(), min=1).to(torch.int32)
    chi2 = (r * r).sum() / n
    b = torch.einsum("npi,np->i", torch.where(m[..., None], J, torch.zeros_like(J)), r)
    return b, chi2, n


def align_level_plain(img, X_ref, ref_patch, J, okpx, Hinv, T_init,
                      fx: float, fy: float, cx: float, cy: float, iters: int = 30):
    """Returns (T [4,4], chi2 f32, n_px i32): GN iterations with chi2
    rollback, stopping on |delta| < 1e-7 or a chi2 rise."""
    return align_level_steps(img, X_ref, ref_patch, J, okpx, Hinv, T_init,
                             fx, fy, cx, cy, iters)[:3]


def align_level_steps(img, X_ref, ref_patch, J, okpx, Hinv, T_init,
                      fx: float, fy: float, cx: float, cy: float, iters: int = 30):
    """align_level_plain and the number of GN iterations it ran (the kernel
    runs the same ones; chip_smoke.py counts its work by them)."""
    T = T_init
    best_T = T
    best = torch.full((), float("inf"), device=img.device)
    it, stop = 0, False
    while it < iters and not stop:
        b, chi2, _ = gn_terms(img, X_ref, ref_patch, J, okpx, T, fx, fy, cx, cy)
        improved = bool(chi2 < best)
        if improved:
            best_T = T
        best = torch.minimum(chi2, best)
        delta = Hinv @ b
        T_next = T @ lie.se3_exp(-delta)
        stop = bool(delta.abs().max() < 1e-7) or (it > 0 and not improved)
        T = T_next
        it += 1
    _, chi2_T, n_T = gn_terms(img, X_ref, ref_patch, J, okpx, T, fx, fy, cx, cy)
    T_out = torch.where(chi2_T <= best, T, best_T)
    return T_out, torch.minimum(chi2_T, best), n_T, it


def align_level(img, X_ref, ref_patch, J, okpx, Hinv, T_init,
                fx: float, fy: float, cx: float, cy: float, iters: int = 30):
    """One launch per level on the card; the plain loop for CPU tensors."""
    if not _device.use_kernel(img, X_ref, ref_patch, J, okpx, Hinv, T_init):
        return align_level_plain(img, X_ref, ref_patch, J, okpx, Hinv, T_init,
                                 fx, fy, cx, cy, iters)
    return _views(_launch(img, X_ref, ref_patch, J, okpx, Hinv, T_init, fx, fy, cx, cy, iters))


def _views(out: torch.Tensor):
    """The kernel's output [5, 4] as (T [4,4] f32, chi2 0-d f32, n_px 0-d
    int32): views, no copy. The kernel writes T whole, bottom row
    [0, 0, 0, 1] included, then chi2, n_px and the GN iterations, the
    counts as int32."""
    return out[:4], out[4, 0], out.view(torch.int32)[4, 1]


def _iterations(out: torch.Tensor) -> torch.Tensor:
    """The GN iterations (0-d int32) the launch that wrote `out` ran."""
    return out.view(torch.int32)[4, 2]


def _image_staged(N: int, H: int, W: int) -> bool:
    """Whether a launch at these sizes stages the level image in shared
    memory (else the kernel reads it through the read-only cache)."""
    return bool(_build.bind("align_level", "sd_align_level_image_staged",
                            [ctypes.c_int] * 3)(N, H, W))


def check_level_inputs(what: str, img, X_ref, ref_patch, J, okpx, lead=()):
    """What the level kernel takes (K1: lead (); K5: lead (B,)): a float32
    image of at least 2x2, contiguous operands of the right shapes, J and
    ref_patch 16-byte aligned (float4 reads), okpx 4-byte aligned."""
    N = X_ref.shape[len(lead)]
    H, W = img.shape
    if H < 2 or W < 2:
        raise ValueError(f"level image {H}x{W} too small for bilinear sampling")
    _device.check_tensor("img", img, torch.float32, (H, W))
    _device.check_tensor("X_ref", X_ref, torch.float32, (*lead, N, 3))
    _device.check_tensor("ref_patch", ref_patch, torch.float32, (*lead, N, PATCH))
    _device.check_tensor("J", J, torch.float32, (*lead, N, PATCH, 6))
    _device.check_tensor("okpx", okpx, torch.bool, (*lead, N, PATCH))
    if J.data_ptr() % 16 or ref_patch.data_ptr() % 16 or okpx.data_ptr() % 4:
        raise ValueError(f"{what}: the kernel reads J and ref_patch as float4s (16-byte "
                         "aligned) and okpx by words (4-byte aligned)")
    return N, H, W


def _launch(img, X_ref, ref_patch, J, okpx, Hinv, T_init,
            fx: float, fy: float, cx: float, cy: float, iters: int) -> torch.Tensor:
    """One kernel launch on CUDA tensors; returns its output buffer."""
    N, H, W = check_level_inputs("align_level", img, X_ref, ref_patch, J, okpx)
    _device.check_tensor("Hinv", Hinv, torch.float32, (6, 6))
    _device.check_tensor("T_init", T_init, torch.float32, (4, 4))
    out = torch.empty(OUT_SHAPE, dtype=torch.float32, device=img.device)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.bind(
        "align_level", "sd_align_level",
        [vp, ci, ci, vp, vp, vp, vp, ci, vp, vp, cf, cf, cf, cf, ci, vp, vp],
    )
    rc = fn(img.data_ptr(), H, W, X_ref.data_ptr(), ref_patch.data_ptr(), J.data_ptr(),
            okpx.data_ptr(), N, Hinv.data_ptr(), T_init.data_ptr(),
            float(fx), float(fy), float(cx), float(cy), int(iters), out.data_ptr(),
            _device.stream_ptr(img))
    _build.check(rc, "sd_align_level")
    count_launch(__name__)
    return out
