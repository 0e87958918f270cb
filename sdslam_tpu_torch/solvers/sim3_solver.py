"""Sim(3) estimation between matched 3D point sets (port of
sdslam_tpu/solvers/sim3_solver.py): Umeyama/Horn closed form, a batched
3-point RANSAC with symmetric reprojection inliers, and the Gauss-Newton
refinement of Optimizer::OptimizeSim3.

The RANSAC's random index sets are an argument (`sets`) or drawn from a
torch.Generator: the two frameworks draw different numbers from one seed,
so the tests hand both sides the same sets.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sdslam_tpu_torch._util import take
from sdslam_tpu_torch.geometry import camera as cam_mod
from sdslam_tpu_torch.geometry import lie
from sdslam_tpu_torch.geometry.camera import CameraModel


class Sim3Result(NamedTuple):
    R: torch.Tensor  # [3,3]
    t: torch.Tensor  # [3]
    s: torch.Tensor  # scalar
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor


def umeyama_sim3(X, Y, mask, fix_scale: bool = False):
    """Weighted least-squares similarity Y ~ s R X + t. X, Y [...,N,3] and
    mask [...,N] broadcast against each other. Returns (R, t, s)."""
    w = mask.to(torch.float32)
    wsum = torch.clamp(w.sum(-1), min=1e-6)
    mu_x = (X * w[..., None]).sum(-2) / wsum[..., None]
    mu_y = (Y * w[..., None]).sum(-2) / wsum[..., None]
    Xd = X - mu_x[..., None, :]
    Yc = Y - mu_y[..., None, :]
    cov = torch.einsum("...ni,...nj->...ij", Yc * w[..., None], Xd) / wsum[..., None, None]
    U, D, Vt = torch.linalg.svd(cov)
    det = lie._det3(U) * lie._det3(Vt)
    sfix = torch.stack([torch.ones_like(det), torch.ones_like(det), torch.sign(det)], -1)
    R = (U * sfix[..., None, :]) @ Vt
    if fix_scale:
        s = torch.ones_like(wsum)
    else:
        var_x = (torch.sum(Xd**2, -1) * w).sum(-1) / wsum
        s = torch.sum(D * sfix, -1) / torch.clamp(var_x, min=1e-9)
    t = mu_y - s[..., None] * lie._mv(R, mu_x)
    return R, t, s


def _sym_reproj_inliers(cam: CameraModel, R, t, s, X1, X2, th2_1, th2_2, valid):
    """Symmetric reprojection check (Sim3Solver::CheckInliers) of S21 =
    (R, t, s) [...]: X1 (cam-1 frame) into cam 2 and X2 into cam 1."""
    X1_in2 = s[..., None, None] * torch.einsum("...ij,nj->...ni", R, X1) + t[..., None, :]
    sinv = 1.0 / torch.clamp(s, min=1e-9)
    X2_in1 = sinv[..., None, None] * torch.einsum("...ji,...nj->...ni", R, X2 - t[..., None, :])
    uv12, z12 = cam_mod.project(cam, X1_in2)
    uv21, z21 = cam_mod.project(cam, X2_in1)
    uv1, _ = cam_mod.project(cam, X1)
    uv2, _ = cam_mod.project(cam, X2)
    e2 = torch.sum((uv12 - uv2) ** 2, -1)
    e1 = torch.sum((uv21 - uv1) ** 2, -1)
    return valid & (e2 < th2_2) & (e1 < th2_1) & (z12 > 0) & (z21 > 0)


def sample_sets(valid, n_hypotheses: int, set_size: int,
                generator: Optional[torch.Generator] = None):
    """[n_hypotheses, set_size] indices drawn with replacement in proportion
    to `valid` (jax.random.choice with p). With no valid entry the draw is
    uniform (torch.multinomial rejects an all-zero distribution); the
    callers' `valid` masks then reject every hypothesis."""
    p = valid.to(torch.float32)
    p = torch.where(valid.any(), p, torch.ones_like(p))
    idx = torch.multinomial(p, n_hypotheses * set_size, replacement=True, generator=generator)
    return idx.reshape(n_hypotheses, set_size)


def _onehot_sets(sets, N: int):
    """[H, set] indices -> [H, N] bool membership."""
    m = torch.zeros((sets.shape[0], N), dtype=torch.bool, device=sets.device)
    return m.scatter(1, sets.long(), True)


def ransac_sim3(cam: CameraModel, X1, X2, valid, th2_1, th2_2, generator=None, sets=None,
                n_hypotheses: int = 64, fix_scale: bool = False) -> Sim3Result:
    """Batched 3-point RANSAC for S21 (maps cam-1 coords into cam-2), then a
    refit on the best hypothesis' inliers. `sets` [H,3] overrides the draw."""
    N = X1.shape[0]
    if sets is None:
        sets = sample_sets(valid, n_hypotheses, 3, generator)
    m = _onehot_sets(sets, N) & valid
    Rs, ts, ss = umeyama_sim3(X1, X2, m, fix_scale=fix_scale)
    counts = _sym_reproj_inliers(cam, Rs, ts, ss, X1, X2, th2_1, th2_2, valid).sum(-1)
    best = torch.argmax(counts)
    R, t, s = take(Rs, best), take(ts, best), take(ss, best)
    ok = _sym_reproj_inliers(cam, R, t, s, X1, X2, th2_1, th2_2, valid)
    R, t, s = umeyama_sim3(X1, X2, ok, fix_scale=fix_scale)
    ok = _sym_reproj_inliers(cam, R, t, s, X1, X2, th2_1, th2_2, valid)
    return Sim3Result(R, t, s, ok, ok.sum())


class Sim3OptResult(NamedTuple):
    S: torch.Tensor  # [4,4] refined sim3 (maps cam-2 coords into cam-1)
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor


def optimize_sim3(cam: CameraModel, S12, X1, X2, uv1, uv2, info1, info2, valid,
                  th2: float = 10.0, fix_scale: bool = False, iters1: int = 5,
                  iters2: int = 10) -> Sim3OptResult:
    """Gauss-Newton refinement of S12 (X_in1 = S12 X2) with symmetric
    reprojection edges, Huber delta sqrt(th2) and an edge-pair prune between
    the two stages."""
    delta = th2 ** 0.5
    dev = X1.device

    def residuals(S):
        Y = lie.sim3_apply(S, X2)  # X2 in cam 1
        Z = lie.sim3_apply(lie.sim3_inv(S), X1)  # X1 in cam 2
        return Y, Z, cam_mod.project(cam, Y)[0] - uv1, cam_mod.project(cam, Z)[0] - uv2

    def chi2_pair(S):
        _, _, r_fwd, r_inv = residuals(S)
        return torch.sum(r_fwd**2, -1) * info1, torch.sum(r_inv**2, -1) * info2

    def proj_jac(Pc):
        """d project / d point [N,2,3], as differentiating project()."""
        x, y, z = Pc[:, 0], Pc[:, 1], Pc[:, 2]
        zok = torch.abs(z) >= 1e-6
        zs = torch.where(zok, z, torch.full_like(z, 1e-6))
        zero = torch.zeros_like(z)
        gz = zok.to(z.dtype) / (zs * zs)
        return torch.stack([torch.stack([cam.fx / zs, zero, -cam.fx * x * gz], -1),
                            torch.stack([zero, cam.fy / zs, -cam.fy * y * gz], -1)], -2)

    def gen_jac(Pc):
        """d (Exp(xi) P) / d xi at xi = 0: [I, -hat(P), P] [N,3,7]."""
        eye = torch.eye(3, device=dev).expand(Pc.shape[0], 3, 3)
        return torch.cat([eye, -lie.hat(Pc), Pc[..., None]], -1)

    scale_mask = (torch.arange(7, device=dev) < (6 if fix_scale else 7)).to(torch.float32)
    eye7 = torch.eye(7, device=dev)

    def gn_step(S, active):
        # residuals and their exact Jacobian at the tangent origin of the
        # left update S <- Exp(xi) S (what jax.jacfwd gives the JAX package)
        Y, Z, r_fwd, r_inv = residuals(S)
        A_inv = lie.sim3_inv(S)[:3, :3]
        J_fwd = proj_jac(Y) @ gen_jac(Y)
        J_inv = -(proj_jac(Z) @ A_inv) @ gen_jac(X1)
        r = torch.cat([r_fwd.reshape(-1), r_inv.reshape(-1)])
        J = torch.cat([J_fwd.reshape(-1, 7), J_inv.reshape(-1, 7)])
        c_fwd, c_inv = chi2_pair(S)
        w_fwd = info1 * torch.clamp(delta / torch.sqrt(torch.clamp(c_fwd, min=1e-12)), max=1.0)
        w_inv = info2 * torch.clamp(delta / torch.sqrt(torch.clamp(c_inv, min=1e-12)), max=1.0)
        w = torch.cat([torch.repeat_interleave(w_fwd * active, 2),
                       torch.repeat_interleave(w_inv * active, 2)])
        H = J.T @ (J * w[:, None])
        b = J.T @ (r * w)
        if fix_scale:
            # 6-DoF mode: the scale row/column is replaced by the identity
            H = H * scale_mask[:, None] * scale_mask[None, :] + eye7 * (1.0 - scale_mask)
            b = b * scale_mask
        H = H + 1e-6 * eye7
        dx = -torch.linalg.solve_ex(H, b[:, None])[0][:, 0]
        return lie.sim3_exp(dx) @ S

    S = S12
    active0 = valid.to(torch.float32)
    for _ in range(iters1):
        S = gn_step(S, active0)
    c_fwd, c_inv = chi2_pair(S)
    keep = valid & (c_fwd < th2) & (c_inv < th2)
    active1 = keep.to(torch.float32)
    for _ in range(iters2):
        S = gn_step(S, active1)
    c_fwd, c_inv = chi2_pair(S)
    inl = keep & (c_fwd < th2) & (c_inv < th2)
    # re-orthonormalize the rotation block after the exp compositions
    Rb, tb, sb = lie.sim3_Rts(S)
    U, _, Vt = torch.linalg.svd(Rb)
    S = lie.sim3_from_Rts(U @ Vt, tb, torch.ones_like(sb) if fix_scale else sb)
    return Sim3OptResult(S, inl, inl.sum())
