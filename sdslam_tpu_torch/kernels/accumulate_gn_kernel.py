"""K5: the photometric GN right-hand side of B alignment lanes against one
level image (csrc/accumulate_gn.cu).

Port of sdslam_tpu/ops/pallas/align_kernel.py::accumulate_gn, batched over
a leading lane axis: relocalization aligns every keyframe against the
current frame and loop detection every keyframe against the new keyframe,
so all lanes share one current image. The plain version is the XLA branch
of sdslam_tpu/solvers/image_align.py:_align_level's gn_terms (the masked
residual and its einsum) over that axis.
"""

from __future__ import annotations

import ctypes

import torch

from sdslam_tpu_torch import _device
from sdslam_tpu_torch.kernels import _build
from sdslam_tpu_torch.ops import sample

LAUNCHES = 0
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
    B, N = Xc.shape[:2]
    H, W = img.shape
    if H < 2 or W < 2:
        raise ValueError(f"level image {H}x{W} too small for bilinear sampling")
    _device.check_tensor("img", img, torch.float32, (H, W))
    _device.check_tensor("Xc", Xc, torch.float32, (B, N, 3))
    _device.check_tensor("ref_patch", ref_patch, torch.float32, (B, N, PATCH))
    _device.check_tensor("J", J, torch.float32, (B, N, PATCH, 6))
    _device.check_tensor("okpx", okpx, torch.bool, (B, N, PATCH))
    b = torch.empty((B, 6), dtype=torch.float32, device=img.device)
    chi2 = torch.empty((B,), dtype=torch.float32, device=img.device)
    n = torch.empty((B,), dtype=torch.int32, device=img.device)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.bind(
        "accumulate_gn", "sd_accumulate_gn",
        [vp, ci, ci, vp, vp, vp, vp, ci, ci, cf, cf, cf, cf, vp, vp, vp, vp],
    )
    rc = fn(img.data_ptr(), H, W, Xc.data_ptr(), ref_patch.data_ptr(), J.data_ptr(),
            okpx.data_ptr(), B, N, float(fx), float(fy), float(cx), float(cy), b.data_ptr(),
            chi2.data_ptr(), n.data_ptr(), _device.stream_ptr(img))
    _build.check(rc, "sd_accumulate_gn")
    global LAUNCHES
    LAUNCHES += 1
    return b, chi2, n
