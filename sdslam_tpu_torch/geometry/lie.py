"""SO(3) / SE(3) / Sim(3) Lie-group math in PyTorch (float32, batched).

Port of sdslam_tpu/geometry/lie.py. Same conventions: poses are 4x4 Tcw,
se3 tangent is [rho(3), phi(3)], exp uses the left Jacobian V(phi),
quaternions are [w, x, y, z]; a Sim(3) element stores sR in the rotation
block, its tangent is [rho(3), phi(3), sigma(1)] with s = exp(sigma).
Every function broadcasts over leading batch dimensions and covers the
full angle range (Taylor fallbacks near 0, axis recovery near pi).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _mm(a, b):
    return torch.einsum("...ij,...jk->...ik", a, b)


def _mv(a, v):
    return torch.einsum("...ij,...j->...i", a, v)


def _small(theta2):
    return theta2 < 1e-8


def quat_identity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)


def quat_mul(a, b):
    """Hamilton product, [w, x, y, z] convention."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_rotate(q, v):
    """Rotate vectors v [...,3] by quaternions q [...,4]."""
    qv = q[..., 1:]
    w = q[..., :1]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + w * t + torch.linalg.cross(qv, t)


def quat_to_mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(R):
    """Rotation matrix [...,3,3] -> quaternion [w,x,y,z] (largest-pivot
    trace method, branch-free), canonicalized to w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def piv(v):
        return torch.sqrt(torch.clamp(v, min=0.0)) * 0.5

    qw0 = piv(1.0 + tr)
    s0 = 0.25 / torch.clamp(qw0, min=_EPS)
    c0 = torch.stack([qw0, (m21 - m12) * s0, (m02 - m20) * s0, (m10 - m01) * s0], -1)
    qx1 = piv(1.0 + m00 - m11 - m22)
    s1 = 0.25 / torch.clamp(qx1, min=_EPS)
    c1 = torch.stack([(m21 - m12) * s1, qx1, (m01 + m10) * s1, (m02 + m20) * s1], -1)
    qy2 = piv(1.0 - m00 + m11 - m22)
    s2 = 0.25 / torch.clamp(qy2, min=_EPS)
    c2 = torch.stack([(m02 - m20) * s2, (m01 + m10) * s2, qy2, (m12 + m21) * s2], -1)
    qz3 = piv(1.0 - m00 - m11 + m22)
    s3 = 0.25 / torch.clamp(qz3, min=_EPS)
    c3 = torch.stack([(m10 - m01) * s3, (m02 + m20) * s3, (m12 + m21) * s3, qz3], -1)
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], -1)
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)  # [...,4,4]
    q = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def hat(phi):
    """[...,3] -> skew-symmetric [...,3,3]."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(phi.shape[:-1] + (3, 3))


def vee(M):
    """Skew-symmetric [...,3,3] -> [...,3] (the inverse of hat)."""
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(phi):
    """Rodrigues with Taylor fallback: [...,3] -> [...,3,3]."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    K = hat(phi)
    K2 = _mm(K, K)
    a = torch.where(_small(theta2), 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.clamp(theta, min=_EPS))
    b = torch.where(_small(theta2), 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    return _eye3(K) + a[..., None, None] * K + b[..., None, None] * K2


def so3_log(R):
    """[...,3,3] -> [...,3]; handles theta near 0 and near pi."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    sin_t = torch.sin(theta)
    scale = torch.where(theta < 1e-4, 0.5 + theta * theta / 12.0,
                        theta / torch.clamp(2.0 * sin_t, min=_EPS))
    phi_generic = scale[..., None] * w
    near_pi = theta > (torch.pi - 1e-3)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp(
        (diag - cos_t[..., None]) / torch.clamp(1.0 - cos_t[..., None], min=_EPS), min=0.0
    )
    axis = torch.sqrt(axis2)
    s01 = R[..., 0, 1] + R[..., 1, 0]
    s02 = R[..., 0, 2] + R[..., 2, 0]
    s12 = R[..., 1, 2] + R[..., 2, 1]
    amax = torch.argmax(axis2, dim=-1)
    one = torch.ones_like(s01)
    sg = lambda v: torch.sign(v + _EPS)  # noqa: E731
    sx = torch.where(amax == 0, one, torch.where(amax == 1, sg(s01), sg(s02)))
    sy = torch.where(amax == 1, one, torch.where(amax == 0, sg(s01), sg(s12)))
    sz = torch.where(amax == 2, one, torch.where(amax == 0, sg(s02), sg(s12)))
    phi_pi = theta[..., None] * axis * torch.stack([sx, sy, sz], dim=-1)
    return torch.where(near_pi[..., None], phi_pi, phi_generic)


def so3_left_jacobian(phi):
    """V(phi) such that se3_exp translation = V @ rho."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    K = hat(phi)
    K2 = _mm(K, K)
    b = torch.where(_small(theta2), 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    c = torch.where(_small(theta2), 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=_EPS))
    return _eye3(K) + b[..., None, None] * K + c[..., None, None] * K2


def so3_left_jacobian_inv(phi):
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    K = hat(phi)
    K2 = _mm(K, K)
    half = 0.5 * theta
    cot = half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS)
    c = torch.where(_small(theta2), 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - cot) / torch.clamp(theta2, min=_EPS))
    return _eye3(K) - 0.5 * K + c[..., None, None] * K2


def se3_identity(dtype=torch.float32, device=None):
    return torch.eye(4, dtype=dtype, device=device)


def se3_from_Rt(R, t):
    # no scalar stores into the tensor: on CUDA each is a host->device copy
    # that synchronizes the stream
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)), t.expand(batch + (3,))[..., None]], dim=-1)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_R(T):
    return T[..., :3, :3]


def se3_t(T):
    return T[..., :3, 3]


def se3_exp(xi):
    """[...,6] (rho, phi) -> [...,4,4]."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    return se3_from_Rt(so3_exp(phi), _mv(so3_left_jacobian(phi), rho))


def se3_log(T):
    phi = so3_log(se3_R(T))
    rho = _mv(so3_left_jacobian_inv(phi), se3_t(T))
    return torch.cat([rho, phi], dim=-1)


def se3_inv(T):
    Rt = se3_R(T).transpose(-1, -2)
    return se3_from_Rt(Rt, -_mv(Rt, se3_t(T)))


def se3_apply(T, X):
    """Transform points X [...,3] by T [...,4,4]."""
    return _mv(se3_R(T), X) + se3_t(T)


def se3_normalize(T):
    """Re-orthonormalize the rotation block (drift control in f32)."""
    return se3_from_Rt(quat_to_mat(mat_to_quat(se3_R(T))), se3_t(T))


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

def _det3(A):
    """Determinant of [...,3,3] by cofactors (no LU: exact branch-free f32)."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))


def sim3_from_Rts(R, t, s):
    """Similarity [...,4,4] storing sR in the rotation block."""
    return se3_from_Rt(R * s[..., None, None], t)


def sim3_Rts(S):
    """Decompose a stacked sim3 matrix -> (R, t, s)."""
    A = S[..., :3, :3]
    s = torch.pow(torch.clamp(_det3(A), min=_EPS), 1.0 / 3.0)
    return A / s[..., None, None], S[..., :3, 3], s


def sim3_inv(S):
    R, t, s = sim3_Rts(S)
    Rt = R.transpose(-1, -2)
    sinv = 1.0 / s
    return sim3_from_Rts(Rt, -sinv[..., None] * _mv(Rt, t), sinv)


def sim3_apply(S, X):
    return _mv(S[..., :3, :3], X) + S[..., :3, 3]


def _sim3_W(phi, sigma):
    """The sim3 'V' matrix coupling (rho, phi, sigma) -> translation
    (Strasdat's closed form, with the JAX package's small-angle and
    small-sigma branches)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    s = torch.exp(sigma)
    K = hat(phi)
    K2 = _mm(K, K)
    eps_sig = torch.abs(sigma) < 1e-5
    eps_th = theta < 1e-5
    one = torch.ones_like(sigma)
    A_sig = torch.where(eps_sig, torch.zeros_like(sigma),
                        (s - 1.0) / torch.where(eps_sig, one, sigma))
    C = torch.where(eps_sig, one, A_sig)
    sig2th2 = sigma * sigma + theta2
    a_gen = (s * torch.sin(theta) * sigma + (1.0 - s * torch.cos(theta)) * theta) / torch.clamp(
        theta * sig2th2, min=_EPS)
    b_gen = (C - ((s * torch.cos(theta) - 1.0) * sigma + s * torch.sin(theta) * theta)
             / torch.clamp(sig2th2, min=_EPS)) / torch.clamp(theta2, min=_EPS)
    a_th0 = torch.where(eps_sig, 0.5 * one,
                        ((sigma - 1.0) * s + 1.0) / torch.clamp(sigma * sigma, min=_EPS))
    b_th0 = torch.where(eps_sig, one / 6.0,
                        (s * 0.5 * sigma * sigma + s - 1.0 - sigma * s)
                        / torch.clamp(sigma * sigma * sigma, min=_EPS))
    A = torch.where(eps_th, a_th0, a_gen)
    B = torch.where(eps_th, b_th0, b_gen)
    return C[..., None, None] * _eye3(K) + A[..., None, None] * K + B[..., None, None] * K2


def sim3_exp(xi):
    """[...,7] (rho, phi, sigma) -> [...,4,4] with sR block."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return sim3_from_Rts(so3_exp(phi), _mv(_sim3_W(phi, sigma), rho), torch.exp(sigma))


def sim3_log(S):
    R, t, s = sim3_Rts(S)
    phi = so3_log(R)
    sigma = torch.log(s)
    rho = torch.linalg.solve_ex(_sim3_W(phi, sigma), t[..., None])[0][..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def se3_to_sim3(T):
    return T  # scale 1 embeds directly


def sim3_to_se3(S):
    R, t, _ = sim3_Rts(S)
    return se3_from_Rt(R, t)
