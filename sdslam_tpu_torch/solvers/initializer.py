"""Two-view triangulation (port of the linear DLT of
sdslam_tpu/solvers/initializer.py; the monocular H/F bootstrap around it is
not ported yet)."""

from __future__ import annotations

import torch


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
