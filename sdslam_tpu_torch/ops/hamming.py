"""Hamming-distance matching primitives for packed 256-bit ORB descriptors
(port of sdslam_tpu/ops/hamming.py).

Descriptors are [N, 8] int32 (uint32 bit patterns). Every distance runs
in kernel K4 (kernels/hamming_kernel.py) on the card: the windowed
searches through its fused form (`masked_best2`), the mutual brute-force
search through the matrix form.
"""

from __future__ import annotations

import torch

from sdslam_tpu_torch._util import scatter_min, topk_stable
from sdslam_tpu_torch.kernels import hamming_kernel
from sdslam_tpu_torch.kernels.hamming_kernel import BIG, best2  # noqa: F401 (re-exported)

TH_LOW = 50
TH_HIGH = 100
HISTO_BINS = 30


def hamming_matrix(da, db):
    """[Qa,8] x [Qb,8] -> [Qa,Qb] int32 Hamming distances."""
    return hamming_kernel.hamming_matrix(da.contiguous(), db.contiguous())


def hamming_vec(da, db):
    """Rowwise distance for aligned pairs: [N,8] x [N,8] -> [N]."""
    return hamming_kernel._popcount32(da ^ db).sum(-1).to(torch.int32)


def masked_dist(da, db, mask):
    """Distance matrix with BIG where mask is False. mask: [Qa,Qb] bool."""
    d = hamming_matrix(da, db)
    return torch.where(mask, d, torch.full_like(d, BIG))


def masked_best2(da, db, mask):
    """best2(masked_dist(da, db, mask)) without the matrix: per row
    (d1, j1, d2). mask: [Qa,Qb] bool."""
    return hamming_kernel.hamming_masked_best2(da.contiguous(), db.contiguous(),
                                               mask.contiguous())


def resolve_to_targets(best_j, best_d, q_valid, n_targets: int):
    """Invert a query->target assignment keeping the lowest-distance (then
    lowest-index) query per target. Returns (target->query [n_targets]
    int32, -1 none; its distance, BIG none)."""
    q = torch.arange(best_j.shape[0], dtype=torch.int32, device=best_j.device)
    d10 = torch.clamp(best_d, 0, 1022).to(torch.int32)
    sentinel = 1023 * (1 << 16)
    key = torch.where(q_valid, d10 * (1 << 16) + q, torch.full_like(q, sentinel))
    tgt_key = torch.full((n_targets,), sentinel, dtype=torch.int32, device=best_j.device)
    tgt_key = scatter_min(tgt_key, torch.clamp(best_j, 0, n_targets - 1), key)
    has = tgt_key < sentinel
    match_q = torch.where(has, tgt_key % (1 << 16), torch.full_like(tgt_key, -1))
    match_d = torch.where(has, tgt_key // (1 << 16), torch.full_like(tgt_key, BIG))
    return match_q, match_d


def rotation_consistency(dtheta, valid, bins: int = HISTO_BINS):
    """Keep matches whose angle difference falls in the 3 dominant histogram
    bins (a bin survives if it reaches the weakest kept top-3 count)."""
    frac = torch.remainder(dtheta / (2.0 * torch.pi), 1.0)
    b = torch.clamp(torch.remainder(torch.round(frac * bins).to(torch.int64), bins), 0, bins - 1)
    hist = torch.zeros(bins, dtype=torch.int32, device=dtheta.device)
    hist = hist.scatter_add(0, b, valid.to(torch.int32))
    top3 = topk_stable(hist, 3)[0]
    big = torch.full_like(top3, torch.iinfo(torch.int32).max)
    kept = torch.where(top3 * 10 >= top3[0], top3, big)
    min_kept = torch.clamp(torch.amin(kept), min=1)
    return valid & (hist[b] >= min_kept)
