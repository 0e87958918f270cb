"""Monocular two-view initialization: batched H/F RANSAC + reconstruction
(port of sdslam_tpu/solvers/initializer.py), and the linear DLT the
keyframe triangulation uses.

200 hypotheses over shared 8-point samples score both a homography and a
fundamental matrix as one batch each; each winner is refitted twice on its
inliers; the model is chosen by RH = SH / (SH + SF) > 0.40; then the 4 (F)
or 8 (H) candidate motions vote by cheirality, parallax and reprojection.

The samples are an explicit [n_iters, 8] index tensor in place of the JAX
package's PRNG key (torch draws other numbers from the same seed): the
tracker draws them with torch.multinomial, the tests hand both packages
JAX's draws. The batched SVD / eigh of torch.linalg check their results on
the host (a device->host read each on CUDA); the bootstrap runs once per
initialization attempt, never in the per-frame step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sdslam_tpu_torch.geometry.camera import CameraModel

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991  # both scores use this cap


class InitResult(NamedTuple):
    success: torch.Tensor  # bool
    R21: torch.Tensor  # [3,3]
    t21: torch.Tensor  # [3] (unit-ish scale)
    X1: torch.Tensor  # [N,3] triangulated points in frame-1 camera coords
    inliers: torch.Tensor  # [N] bool (triangulated + checks passed)
    used_homography: torch.Tensor  # bool
    n_good: torch.Tensor


def _mat3(rows):
    """A 3x3 tensor from three rows of three 0-d tensors."""
    return torch.stack([torch.stack(r) for r in rows])


def _normalize(uv, valid):
    """Hartley normalization: (normalized uv, T [3,3])."""
    w = valid.to(torch.float32)
    n = torch.clamp(w.sum(), min=1.0)
    mean = torch.sum(uv * w[:, None], 0) / n
    d = torch.sum(torch.abs(uv - mean) * w[:, None], 0) / n
    s = 1.0 / torch.clamp(d, min=1e-6)
    zero = torch.zeros_like(s[0])
    T = _mat3([[s[0], zero, -mean[0] * s[0]], [zero, s[1], -mean[1] * s[1]],
               [zero, zero, zero + 1.0]])
    return (uv - mean) * s, T


def _f_rows(p1, p2):
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], dim=-1)


def _h_rows(p1, p2):
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    return torch.cat([r1, r2], -2)


def _rank2(F):
    U, D, Vt = torch.linalg.svd(F)
    D = torch.cat([D[..., :2], torch.zeros_like(D[..., 2:])], -1)
    return U @ torch.diag_embed(D) @ Vt


def _fit_F(p1, p2):
    """8-point fundamental matrices from [..., 8, 2] normalized
    correspondences: the null vector of each 8x9 system is the last row of
    the full Vt."""
    _, _, Vt = torch.linalg.svd(_f_rows(p1, p2), full_matrices=True)
    return _rank2(Vt[..., -1, :].reshape(Vt.shape[:-2] + (3, 3)))


def _fit_H(p1, p2):
    """DLT homographies from [..., 8, 2] normalized correspondences."""
    _, _, Vt = torch.linalg.svd(_h_rows(p1, p2), full_matrices=True)
    return Vt[..., -1, :].reshape(Vt.shape[:-2] + (3, 3))


def _fit_F_weighted(p1, p2, w):
    """F from all weighted correspondences via the 9x9 normal matrix."""
    A = _f_rows(p1, p2)
    _, V = torch.linalg.eigh(torch.einsum("ni,n,nj->ij", A, w, A))
    return _rank2(V[:, 0].reshape(3, 3))


def _fit_H_weighted(p1, p2, w):
    A = _h_rows(p1, p2)
    _, V = torch.linalg.eigh(torch.einsum("ni,n,nj->ij", A, torch.cat([w, w], 0), A))
    return V[:, 0].reshape(3, 3)


def _hom(a):
    return torch.cat([a, torch.ones_like(a[..., :1])], -1)


def _score_F(F, uv1, uv2, valid, sigma2):
    """Symmetric epipolar-distance score of F [..., 3, 3]: (score [...],
    inliers [..., N])."""
    p1, p2 = _hom(uv1), _hom(uv2)
    l2 = p1 @ F.transpose(-1, -2)  # lines in image 2
    l1 = p2 @ F
    num2 = torch.sum(l2 * p2, -1) ** 2
    num1 = torch.sum(l1 * p1, -1) ** 2
    d2 = num2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-9) / sigma2
    d1 = num1 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-9) / sigma2
    ok = valid & (d1 < CHI2_F) & (d2 < CHI2_F)
    zero = torch.zeros_like(d1)
    score = torch.sum(torch.where(valid & (d1 < CHI2_F), SCORE_TH - d1, zero)
                      + torch.where(valid & (d2 < CHI2_F), SCORE_TH - d2, zero), -1)
    return score, ok


def _score_H(H, uv1, uv2, valid, sigma2):
    """Symmetric transfer-error score of H [..., 3, 3]."""
    Hinv = torch.linalg.inv_ex(H)[0]

    def transfer(M, a):
        p = _hom(a) @ M.transpose(-1, -2)
        return p[..., :2] / torch.clamp(torch.abs(p[..., 2:]), min=1e-9) * torch.sign(p[..., 2:])

    e12 = torch.sum((transfer(H, uv1) - uv2) ** 2, -1) / sigma2
    e21 = torch.sum((transfer(Hinv, uv2) - uv1) ** 2, -1) / sigma2
    ok = valid & (e12 < CHI2_H) & (e21 < CHI2_H)
    zero = torch.zeros_like(e12)
    score = torch.sum(torch.where(valid & (e12 < CHI2_H), SCORE_TH - e12, zero)
                      + torch.where(valid & (e21 < CHI2_H), SCORE_TH - e21, zero), -1)
    return score, ok


def triangulate(P1, P2, uv1, uv2):
    """Batched homogeneous DLT by SVD. P1, P2 [..., 3, 4]; uv [..., N, 2]
    -> X [..., N, 3]."""
    P1, P2 = P1[..., None, :, :], P2[..., None, :, :]
    rows = torch.stack([
        uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)  # [..., N, 4, 4]
    _, _, Vt = torch.linalg.svd(rows)
    Xh = Vt[..., -1, :]
    w = Xh[..., 3:]
    return Xh[..., :3] / torch.where(torch.abs(w) < 1e-9, torch.full_like(w, 1e-9), w)


def triangulate_linear(P1, P2, uv1, uv2):
    """Inhomogeneous DLT: fix w=1, solve the 4x3 system by its 3x3 normal
    equations in closed form (adjugate). P1, P2 [3,4]; uv [N,2] -> X [N,3]."""
    rows = torch.stack([
        uv1[:, 0, None] * P1[2] - P1[0],
        uv1[:, 1, None] * P1[2] - P1[1],
        uv2[:, 0, None] * P2[2] - P2[0],
        uv2[:, 1, None] * P2[2] - P2[1],
    ], dim=1)  # [N,4,4]
    A = rows[:, :, :3]
    b = -rows[:, :, 3]
    AtA = torch.einsum("nij,nik->njk", A, A) + 1e-9 * torch.eye(3, device=A.device)
    Atb = torch.einsum("nij,ni->nj", A, b)
    a00, a01, a02 = AtA[:, 0, 0], AtA[:, 0, 1], AtA[:, 0, 2]
    a11, a12, a22 = AtA[:, 1, 1], AtA[:, 1, 2], AtA[:, 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    di = 1.0 / torch.where(torch.abs(det) > 1e-18, det, torch.full_like(det, 1e-18))
    b0, b1, b2 = Atb[:, 0], Atb[:, 1], Atb[:, 2]
    return torch.stack([(c00 * b0 + c01 * b1 + c02 * b2) * di,
                        (c01 * b0 + c11 * b1 + c12 * b2) * di,
                        (c02 * b0 + c12 * b1 + c22 * b2) * di], dim=-1)


def _check_RT(cam: CameraModel, R, t, uv1, uv2, valid, sigma2):
    """Cheirality + parallax + reprojection vote of motion hypotheses R
    [..., 3, 3], t [..., 3]: (n_good [...], good [..., N], X1 [..., N, 3],
    max parallax in degrees [...])."""
    K = cam.K(uv1.device)
    P1 = (K @ torch.cat([torch.eye(3, device=K.device), torch.zeros((3, 1), device=K.device)],
                        1)).expand(R.shape[:-2] + (3, 4))
    P2 = K @ torch.cat([R, t[..., None]], -1)
    X1 = triangulate(P1, P2, uv1, uv2)
    z1 = X1[..., 2]
    X2 = X1 @ R.transpose(-1, -2) + t[..., None, :]
    z2 = X2[..., 2]
    O2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    r1 = X1 / torch.clamp(torch.linalg.norm(X1, dim=-1, keepdim=True), min=1e-9)
    d = X1 - O2[..., None, :]
    r2 = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    cos_par = torch.sum(r1 * r2, -1)
    u1 = cam.fx * X1[..., 0] / torch.clamp(z1, min=1e-9) + cam.cx
    v1 = cam.fy * X1[..., 1] / torch.clamp(z1, min=1e-9) + cam.cy
    u2 = cam.fx * X2[..., 0] / torch.clamp(z2, min=1e-9) + cam.cx
    v2 = cam.fy * X2[..., 1] / torch.clamp(z2, min=1e-9) + cam.cy
    e1 = (u1 - uv1[..., 0]) ** 2 + (v1 - uv1[..., 1]) ** 2
    e2 = (u2 - uv2[..., 0]) ** 2 + (v2 - uv2[..., 1]) ** 2
    good = (valid & (z1 > 0) & (z2 > 0) & (cos_par < 0.99998)
            & (e1 < 4.0 * sigma2) & (e2 < 4.0 * sigma2))
    par_deg = torch.rad2deg(torch.arccos(torch.clamp(cos_par, -1, 1)))
    par_ok = torch.where(good, par_deg, torch.zeros_like(par_deg))
    return good.sum(-1), good, X1, par_ok.amax(-1)


def _W(like, transpose: bool = False):
    z, o = torch.zeros((), device=like.device), torch.ones((), device=like.device)
    W = torch.stack([torch.stack([z, -o, z]), torch.stack([o, z, z]), torch.stack([z, z, o])])
    return W.T if transpose else W


def _motions_from_F(cam: CameraModel, F):
    """E = K^T F K -> 4 candidate motions ([4,3,3], [4,3])."""
    K = cam.K(F.device)
    U, _, Vt = torch.linalg.svd(K.T @ F @ K)
    R1 = U @ _W(F) @ Vt
    R2 = U @ _W(F, transpose=True) @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-9)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _motions_from_H(cam: CameraModel, H):
    """Faugeras SVD decomposition of a homography into 8 motions."""
    K = cam.K(H.device)
    Kinv = torch.linalg.inv_ex(K)[0]
    U, D, Vt = torch.linalg.svd(Kinv @ H @ K)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = D[0], D[1], D[2]
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den13, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den13, min=0.0))
    sgn1 = (1.0, 1.0, -1.0, -1.0)
    sgn3 = (1.0, -1.0, 1.0, -1.0)
    sgn_s = (1.0, -1.0, -1.0, 1.0)
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    # case d' > 0
    aux_st = root / torch.clamp((d1 + d3) * d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    # case d' < 0
    aux_sp = root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cp = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    zero, one = torch.zeros_like(ct), torch.ones_like(ct)
    Rs, ts = [], []
    for neg in (False, True):
        for i in range(4):
            x1, x3 = sgn1[i] * aux1, sgn3[i] * aux3
            if not neg:
                st = sgn_s[i] * aux_st
                Rp = _mat3([[ct, zero, -st], [zero, one, zero], [st, zero, ct]])
                tp = torch.stack([x1, zero, -x3]) * (d1 - d3)
            else:
                sp = sgn_s[i] * aux_sp
                Rp = _mat3([[cp, zero, sp], [zero, -one, zero], [sp, zero, -cp]])
                tp = torch.stack([x1, zero, x3]) * (d1 + d3)
            t = U @ tp
            Rs.append(s * U @ Rp @ Vt)
            ts.append(t / torch.clamp(torch.linalg.norm(t), min=1e-9))
    return torch.stack(Rs), torch.stack(ts)


def initialize_two_view(cam: CameraModel, uv1, uv2, valid, samples, sigma: float = 1.0,
                        min_triangulated: int = 50) -> InitResult:
    """uv1, uv2 [N,2] matched undistorted coords, valid [N] bool, samples
    [n_iters, 8] int indices into N (drawn in proportion to valid)."""
    sigma2 = sigma * sigma
    n1, T1 = _normalize(uv1, valid)
    n2, T2 = _normalize(uv2, valid)
    idx = samples.long()
    p1, p2 = n1[idx], n2[idx]  # [S,8,2]
    T2inv = torch.linalg.inv_ex(T2)[0]
    Fs = T2.T @ _fit_F(p1, p2) @ T1
    Hs = T2inv @ _fit_H(p1, p2) @ T1
    sFs, _ = _score_F(Fs, uv1, uv2, valid, sigma2)
    sHs, _ = _score_H(Hs, uv1, uv2, valid, sigma2)
    F = Fs.index_select(0, torch.argmax(sFs).reshape(1))[0]
    H = Hs.index_select(0, torch.argmax(sHs).reshape(1))[0]

    # refit each model on its inlier set, twice
    for _ in range(2):
        _, inlF = _score_F(F, uv1, uv2, valid, sigma2)
        F = T2.T @ _fit_F_weighted(n1, n2, inlF.to(torch.float32)) @ T1
        SF, _ = _score_F(F, uv1, uv2, valid, sigma2)
        _, inlH = _score_H(H, uv1, uv2, valid, sigma2)
        H = T2inv @ _fit_H_weighted(n1, n2, inlH.to(torch.float32)) @ T1
        SH, _ = _score_H(H, uv1, uv2, valid, sigma2)

    use_H = SH / torch.clamp(SH + SF, min=1e-9) > 0.40
    Rf, tf = _motions_from_F(cam, F)
    Rh, th = _motions_from_H(cam, H)
    Rs = torch.cat([Rf, Rh])  # [12,3,3]
    ts = torch.cat([tf, th])
    model_mask = torch.cat([(~use_H).expand(4), use_H.expand(8)])
    inl_model = torch.where(use_H, _score_H(H, uv1, uv2, valid, sigma2)[1],
                            _score_F(F, uv1, uv2, valid, sigma2)[1])

    n_good, goods, X1s, _ = _check_RT(cam, Rs, ts, uv1, uv2, inl_model, sigma2)
    counts = torch.where(model_mask, n_good, torch.full_like(n_good, -1))
    best = torch.argmax(counts).reshape(1)
    n_best = counts.index_select(0, best)[0]
    second = torch.sort(counts).values[-2]
    ok = ((n_best >= min_triangulated)
          & (second.to(torch.float32) < 0.75 * n_best.to(torch.float32))
          & (n_best >= 0.8 * inl_model.sum()))
    pick = lambda x: x.index_select(0, best)[0]  # noqa: E731
    return InitResult(success=ok, R21=pick(Rs), t21=pick(ts), X1=pick(X1s),
                      inliers=pick(goods), used_homography=use_H, n_good=n_best)
