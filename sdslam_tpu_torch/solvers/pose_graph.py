"""Sim(3) pose-graph (essential-graph) optimization (port of
sdslam_tpu/solvers/pose_graph.py).

Edges live in fixed-capacity arrays [E] with weights; each GN iteration
evaluates every edge residual r = log(S_ij S_j S_i^-1) at once with
closed-form adjoint Jacobians, assembles the dense [7K,7K] system by
one-hot products (deterministic, no scatter-add) and solves it by a dense
Cholesky (torch.linalg, as the JAX package leaves it to XLA).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sdslam_tpu_torch._util import scatter_set2
from sdslam_tpu_torch.geometry import lie


class PoseGraphEdges(NamedTuple):
    i: torch.Tensor  # [E] int32 source keyframe slot
    j: torch.Tensor  # [E] int32 target keyframe slot
    S_ij: torch.Tensor  # [E,4,4] measured relative sim3: S_i * S_j^-1
    weight: torch.Tensor  # [E] float32 (0 disables an edge)


def make_edges_from_covisibility(kf_Tcw, kf_valid, covis, parent, loop_i=None, loop_j=None,
                                 loop_S=None, stored_loops=None, covis_min: int = 100,
                                 max_edges: int = 2048):
    """Essential-graph edges from the current poses, by priority under the
    `max_edges` cap: stored loop edges (3), spanning tree (2), strong
    covisibility (1); the in-flight loop edge (loop_i/j/S) is prepended
    outside the cap. Returns (edges, n_dropped covisibility edges)."""
    K = kf_Tcw.shape[0]
    dev = kf_Tcw.device
    ar = torch.arange(K, device=dev)
    upper = ar[:, None] < ar[None, :]
    cov_ok = (covis >= covis_min) & upper & kf_valid[:, None] & kf_valid[None, :]
    par_ok = (parent >= 0) & kf_valid
    tree = scatter_set2(torch.zeros((K, K), dtype=torch.bool, device=dev),
                        torch.where(par_ok, torch.minimum(ar, parent.long()), K),
                        torch.where(par_ok, torch.maximum(ar, parent.long()), K), True)
    pri = cov_ok.to(torch.int32) + 2 * tree.to(torch.int32)
    if stored_loops is not None:
        li, lj = stored_loops[:, 0].long(), stored_loops[:, 1].long()
        ok = (li >= 0) & (lj >= 0) & kf_valid[torch.clamp(li, 0, K - 1)] & (
            kf_valid[torch.clamp(lj, 0, K - 1)])
        lin = torch.where(ok, torch.minimum(li, lj) * K + torch.maximum(li, lj), K * K)
        flat = torch.cat([pri.reshape(-1), pri.new_zeros(1)])
        flat = flat.scatter_reduce(0, lin, torch.full_like(lin, 3, dtype=flat.dtype),
                                   reduce="amax", include_self=True)
        pri = flat[: K * K].reshape(K, K)
    flat = pri.reshape(-1)
    order = torch.sort(-flat, stable=True).indices  # highest priority first
    sel = order[:max_edges]
    ei = (sel // K).to(torch.int32)
    ej = (sel % K).to(torch.int32)
    w = (flat[sel] > 0).to(torch.float32)
    n_dropped = (flat > 0).sum() - (w > 0).sum()
    S_ij = kf_Tcw[ei.long()] @ lie.sim3_inv(kf_Tcw[ej.long()])
    if loop_i is not None:
        keep = max_edges - loop_i.shape[0]
        ei = torch.cat([loop_i.to(torch.int32), ei[:keep]])
        ej = torch.cat([loop_j.to(torch.int32), ej[:keep]])
        S_ij = torch.cat([loop_S.to(S_ij.dtype), S_ij[:keep]])
        w = torch.cat([torch.full((loop_i.shape[0],), 5.0, device=dev), w[:keep]])
    return PoseGraphEdges(ei, ej, S_ij, w), n_dropped


def sim3_adjoint(S):
    """7x7 adjoint of a Sim(3) element on the [rho, phi, sigma] tangent:
    phi' = R phi, sigma' = sigma, rho' = sR rho + hat(t) R phi - sigma t."""
    R, t, s = lie.sim3_Rts(S)
    z3 = torch.zeros_like(R)
    z31 = torch.zeros_like(t)[..., None]
    top = torch.cat([s[..., None, None] * R, lie._mm(lie.hat(t), R), -t[..., None]], -1)
    mid = torch.cat([z3, R, z31], -1)
    bot = torch.cat([torch.zeros_like(top[..., :1, :6]), torch.ones_like(top[..., :1, :1])], -1)
    return torch.cat([top, mid, bot], -2)


def sim3_ad(xi):
    """Algebra adjoint ad_xi (7x7) of the [rho, phi, sigma] tangent."""
    rho, phi, sigma = xi[..., 0:3], xi[..., 3:6], xi[..., 6]
    hp = lie.hat(phi)
    z3 = torch.zeros_like(hp)
    z31 = torch.zeros_like(rho)[..., None]
    top = torch.cat([hp + sigma[..., None, None] * lie._eye3(hp), lie.hat(rho), -rho[..., None]], -1)
    mid = torch.cat([z3, hp, z31], -1)
    bot = torch.zeros_like(top[..., :1, :])
    return torch.cat([top, mid, bot], -2)


def _jl_inv(r):
    """Inverse left Jacobian of sim3, BCH series to second order."""
    ad = sim3_ad(r)
    eye = torch.eye(7, dtype=r.dtype, device=r.device).expand(ad.shape)
    return eye - 0.5 * ad + (1.0 / 12.0) * lie._mm(ad, ad)


def edge_system(S_all, edges: PoseGraphEdges, K: int, fix_scale: bool):
    """GN normal equations of an edge set (no damping): (H [7K,7K], b [7K])."""
    D = 7
    dev = S_all.device
    ei, ej = edges.i.long(), edges.j.long()
    A0 = edges.S_ij @ S_all[ej] @ lie.sim3_inv(S_all[ei])
    r = lie.sim3_log(A0)
    Jl = _jl_inv(r)
    Ji = -lie._mm(Jl, sim3_adjoint(A0))
    Jj = lie._mm(Jl, sim3_adjoint(edges.S_ij))
    if fix_scale:
        # 6-DoF mode: zero the scale tangent
        m = (torch.arange(D, device=dev) < 6).to(torch.float32)
        Ji = Ji * m[None, :, None] * m[None, None, :]
        Jj = Jj * m[None, :, None] * m[None, None, :]
        r = r * m[None, :]
    ar = torch.arange(K, device=dev)
    Ui = (ei[:, None] == ar[None, :]).to(torch.float32) * edges.weight[:, None]
    Uj = (ej[:, None] == ar[None, :]).to(torch.float32) * edges.weight[:, None]
    Jall = torch.einsum("ek,erd->kerd", Ui, Ji) + torch.einsum("ek,erd->kerd", Uj, Jj)
    H = torch.einsum("kera,lerb->kalb", Jall, Jall)
    b = -torch.einsum("kera,er->ka", Jall, r)
    return H.reshape(K * D, K * D), b.reshape(K * D)


def solve_and_update(S_all, H, b, kf_valid, fixed_mask, fix_scale: bool, lm_lambda: float):
    """Damp + solve the assembled system and apply the sim3 update."""
    K = S_all.shape[0]
    D = 7
    diag = torch.clamp(torch.diagonal(H).reshape(K, D), min=1e-8)
    foi = fixed_mask | ~kf_valid
    prior = torch.where(foi[:, None], torch.full_like(diag, 1e12), lm_lambda * diag + 1e-6)
    L, _ = torch.linalg.cholesky_ex(H + torch.diag(prior.reshape(-1)))
    delta = torch.cholesky_solve(b[:, None], L).reshape(K, D) * (~foi)[:, None]
    if fix_scale:
        delta = delta * (torch.arange(D, device=H.device) < 6)
    return torch.einsum("kij,kjl->kil", lie.sim3_exp(delta), S_all)


def optimize_pose_graph(kf_Ssw, kf_valid, fixed_mask, edges: PoseGraphEdges, iters: int = 20,
                        fix_scale: bool = False, lm_lambda: float = 1e-6):
    """GN on sim3 vertices; returns corrected [K,4,4] sim3 poses."""
    K = kf_Ssw.shape[0]
    S = kf_Ssw
    for _ in range(iters):
        H, b = edge_system(S, edges, K, fix_scale)
        S = solve_and_update(S, H, b, kf_valid, fixed_mask, fix_scale, lm_lambda)
    return S
