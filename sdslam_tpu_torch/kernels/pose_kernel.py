"""K2: the whole pose-only Gauss-Newton solve (csrc/pose_gn.cu).

Port of sdslam_tpu/ops/pallas/pose_kernel.py::pose_optimize. The plain
version is the XLA path of sdslam_tpu/solvers/pose_opt.py (fused=False),
with the full-range SE(3) log in the prior residual. Neither returns a
re-normalized pose: solvers/pose_opt.optimize_pose does that after either.
The kernel writes its outputs finished into one buffer and the wrapper
returns views of it (`_views`): one launch and one allocation per call.
"""

from __future__ import annotations

import ctypes

import torch

from sdslam_tpu_torch import _device
from sdslam_tpu_torch.geometry import lie
from sdslam_tpu_torch.kernels import _build, count_launch
from sdslam_tpu_torch.solvers.ba_const import CHI2_MONO, CHI2_STEREO, HUBER_MONO, HUBER_STEREO

LAUNCHES = 0
COLS = 16
# the kernel's output: T [4,4] f32, chi2 f32 and n_inliers int32 (72
# bytes), then the inlier mask [N] (bytes)
OUT_HEAD = 72


def pack_edges(X, uv_obs, ur_obs, inv_sigma2, valid, stereo):
    """[N,16] edge operand: X(3) uv(2) u_r inv_sigma2 valid stereo, 0 pad."""
    N = X.shape[0]
    cols = [X, uv_obs, ur_obs[:, None], inv_sigma2[:, None],
            valid.to(torch.float32)[:, None], stereo.to(torch.float32)[:, None]]
    e = torch.cat(cols, dim=1)
    return torch.cat([e, torch.zeros((N, COLS - e.shape[1]), device=X.device)], dim=1)


def _residuals_jac(Tcw, X, uv_obs, ur_obs, stereo, fx, fy, cx, cy, bf):
    """Residual [N,3], Jacobian [N,3,6] (left perturbation), behind [N]."""
    Xc = lie.se3_apply(Tcw, X)
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    zi = 1.0 / torch.clamp(z, min=1e-6)
    zi2 = zi * zi
    u = fx * x * zi + cx
    v = fy * y * zi + cy
    ur = u - bf * zi
    zero = torch.zeros_like(x)
    r = torch.stack([u - uv_obs[:, 0], v - uv_obs[:, 1],
                     torch.where(stereo, ur - ur_obs, zero)], dim=-1)
    JX = torch.stack([
        torch.stack([fx * zi, zero, -fx * x * zi2], -1),
        torch.stack([zero, fy * zi, -fy * y * zi2], -1),
        torch.stack([fx * zi, zero, -fx * x * zi2 + bf * zi2], -1),
    ], dim=-2)  # [N,3,3]
    eye = torch.eye(3, device=X.device).expand(Xc.shape[:-1] + (3, 3))
    dX = torch.cat([eye, -lie.hat(Xc)], dim=-1)  # [N,3,6]
    J = torch.einsum("nij,njk->nik", JX, dX)
    row_mask = torch.stack([torch.ones_like(x), torch.ones_like(x), stereo.to(x.dtype)], -1)
    return r, J * row_mask[..., None], z <= 0.05


def pose_optimize_plain(edata, T_init, T_prior_inv, prior_info,
                        fx: float, fy: float, cx: float, cy: float, bf: float,
                        rounds: int = 4, iters: int = 10, has_prior: bool = True):
    """prior_info: [2] (rot_info, trans_info). Returns (T [4,4] (not
    re-normalized), inliers [N] bool, n_inliers i32, chi2 f32)."""
    X, uv_obs, ur_obs = edata[:, 0:3], edata[:, 3:5], edata[:, 5]
    isig = edata[:, 6]
    valid = edata[:, 7] > 0.5
    stereo = edata[:, 8] > 0.5
    cam = (fx, fy, cx, cy, bf)
    if has_prior:
        rot_info, trans_info = prior_info[0], prior_info[1]
        W_prior = torch.diag(torch.cat([trans_info.expand(3), rot_info.expand(3)]))
    eye6 = torch.eye(6, device=edata.device)
    h_delta = torch.where(stereo, torch.full_like(isig, HUBER_STEREO),
                          torch.full_like(isig, HUBER_MONO))
    T = T_init
    inliers = valid
    for rnd in range(rounds):
        for _ in range(iters):
            r, J, behind = _residuals_jac(T, X, uv_obs, ur_obs, stereo, *cam)
            m = inliers & valid & ~behind
            w = isig * m
            if rnd < 2:
                rn = torch.sqrt(torch.sum(r * r, dim=-1) * isig + 1e-12)
                w = w * torch.clamp(h_delta / torch.clamp(rn, min=1e-9), max=1.0)
            H = torch.einsum("nri,n,nrj->ij", J, w, J)
            b = -torch.einsum("nri,n,nr->i", J, w, r)
            if has_prior:
                xi = lie.se3_log(T @ T_prior_inv)
                H = H + W_prior
                b = b - W_prior @ xi
            Hr = H + 1e-6 * torch.clamp(torch.trace(H) / 6.0, min=1e-8) * eye6
            delta = torch.linalg.solve_ex(Hr, b)[0]
            T = lie.se3_exp(delta) @ T
        r, _, behind = _residuals_jac(T, X, uv_obs, ur_obs, stereo, *cam)
        chi2 = torch.sum(r * r, dim=-1) * isig
        th = torch.where(stereo, torch.full_like(chi2, CHI2_STEREO),
                         torch.full_like(chi2, CHI2_MONO))
        inliers = valid & ~behind & (chi2 <= th)
    r, _, _ = _residuals_jac(T, X, uv_obs, ur_obs, stereo, *cam)
    chi2 = torch.sum(r * r, dim=-1) * isig
    total = torch.sum(torch.where(inliers, chi2, torch.zeros_like(chi2)))
    return T, inliers, inliers.sum().to(torch.int32), total


def pose_optimize(edata, T_init, T_prior_inv, prior_info,
                  fx: float, fy: float, cx: float, cy: float, bf: float,
                  rounds: int = 4, iters: int = 10, has_prior: bool = True):
    """One launch for the whole solve on the card; plain GN on the CPU."""
    if not _device.use_kernel(edata, T_init, T_prior_inv, prior_info):
        return pose_optimize_plain(edata, T_init, T_prior_inv, prior_info,
                                   fx, fy, cx, cy, bf, rounds, iters, has_prior)
    return _views(_launch(edata, T_init, T_prior_inv, prior_info, fx, fy, cx, cy, bf,
                          rounds, iters, has_prior), edata.shape[0])


def _views(out: torch.Tensor, N: int):
    """The kernel's output bytes as (T [4,4] f32, inliers [N] bool,
    n_inliers 0-d int32, chi2 0-d f32): views, no copy. The kernel writes T
    whole, bottom row [0, 0, 0, 1] included, then chi2 and n_inliers, then
    the inlier mask."""
    head = out[:OUT_HEAD]
    return (head.view(torch.float32)[:16].view(4, 4), out[OUT_HEAD:OUT_HEAD + N].view(torch.bool),
            head.view(torch.int32)[17], head.view(torch.float32)[16])


def _launch(edata, T_init, T_prior_inv, prior_info, fx: float, fy: float, cx: float, cy: float,
            bf: float, rounds: int, iters: int, has_prior: bool) -> torch.Tensor:
    """One kernel launch on CUDA tensors; returns its output buffer."""
    N = edata.shape[0]
    _device.check_tensor("edata", edata, torch.float32, (N, COLS))
    _device.check_tensor("T_init", T_init, torch.float32, (4, 4))
    _device.check_tensor("T_prior_inv", T_prior_inv, torch.float32, (4, 4))
    _device.check_tensor("prior_info", prior_info, torch.float32, (2,))
    out = torch.empty(OUT_HEAD + N, dtype=torch.uint8, device=edata.device)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.bind(
        "pose_gn", "sd_pose_gn",
        [vp, ci, vp, vp, vp, ci, cf, cf, cf, cf, cf, ci, ci, vp, vp],
    )
    rc = fn(edata.data_ptr(), N, T_init.data_ptr(), T_prior_inv.data_ptr(), prior_info.data_ptr(),
            int(has_prior), float(fx), float(fy), float(cx), float(cy), float(bf), int(rounds),
            int(iters), out.data_ptr(), _device.stream_ptr(edata))
    _build.check(rc, "sd_pose_gn")
    count_launch(__name__)
    return out
