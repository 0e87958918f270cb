"""FAST-9 corner detection as dense map ops (port of sdslam_tpu/ops/fast.py).

Dense score map (16 shifted images + circular window minima), 3x3 NMS,
per-cell top-k for spatial stratification, then a global top-k and
quadratic subpixel refinement. Selection uses stable sorts, so among equal
scores the lower index comes first, as jax.lax.top_k orders them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sdslam_tpu_torch._util import topk_stable

# Bresenham circle of radius 3, 16 points, (dy, dx), clockwise from top.
CIRCLE16 = np.array(
    [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
     (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1)],
    dtype=np.int32,
)
ARC = 9


def _circular_window_min(x, win: int):
    """Min over `win` consecutive entries (circular) along axis 0 of [16,...]."""
    acc = x
    size = 1
    while size * 2 <= win:
        acc = torch.minimum(acc, torch.roll(acc, -size, dims=0))
        size *= 2
    if size < win:
        acc = torch.minimum(acc, torch.roll(acc, -(win - size), dims=0))
    return acc


def fast_score_map(img, border: int = 19):
    """Dense FAST-9 score map [H,W] float32; 0 where not a corner."""
    H, W = img.shape
    circle = torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1)) for dy, dx in CIRCLE16]
    )
    diffs = circle - img[None]
    score_bright = torch.amax(_circular_window_min(diffs, ARC), dim=0)
    score_dark = torch.amax(_circular_window_min(-diffs, ARC), dim=0)
    score = torch.clamp(torch.maximum(score_bright, score_dark), min=0.0)
    v = torch.arange(H, device=img.device)[:, None]
    u = torch.arange(W, device=img.device)[None, :]
    inb = (v >= border) & (v < H - border) & (u >= border) & (u < W - border)
    return torch.where(inb, score, torch.zeros_like(score))


def nms3(score):
    """3x3 non-maximum suppression: keep pixels equal to their neighborhood max."""
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= m, score, torch.zeros_like(score))


def subpixel_refine(score, uv):
    """Quadratic subpixel refinement from the 3x3 score neighborhood."""
    H, W = score.shape
    xi = torch.clamp(uv[:, 0].to(torch.int64), 1, W - 2)
    yi = torch.clamp(uv[:, 1].to(torch.int64), 1, H - 2)

    def g(dy, dx):
        return score[yi + dy, xi + dx]

    dx = 0.5 * (g(0, 1) - g(0, -1))
    dy = 0.5 * (g(1, 0) - g(-1, 0))
    dxx = g(0, 1) + g(0, -1) - 2.0 * g(0, 0)
    dyy = g(1, 0) + g(-1, 0) - 2.0 * g(0, 0)
    dxy = 0.25 * (g(1, 1) - g(1, -1) - g(-1, 1) + g(-1, -1))
    det = dxx * dyy - dxy * dxy
    ok = torch.abs(det) > 1e-9
    safe = torch.where(ok, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    ox = torch.clamp(torch.where(ok, -(dyy * dx - dxy * dy) / safe, zero), -0.5, 0.5)
    oy = torch.clamp(torch.where(ok, -(dxx * dy - dxy * dx) / safe, zero), -0.5, 0.5)
    return uv + torch.stack([ox, oy], dim=-1)


def detect_keypoints(
    img, n_keypoints: int, threshold: float = 20.0, cell: int = 16, border: int = 19
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to n_keypoints FAST corners with spatial stratification.
    Returns (uv [N,2] (x,y), score [N], valid [N] bool), fixed N."""
    H, W = img.shape
    raw_score = fast_score_map(img, border=border)
    score = nms3(raw_score)
    score = torch.where(score > threshold, score, torch.zeros_like(score))
    Hp = -(-H // cell) * cell
    Wp = -(-W // cell) * cell
    sp = F.pad(score, (0, Wp - W, 0, Hp - H))
    nCy, nCx = Hp // cell, Wp // cell
    cells = sp.reshape(nCy, cell, nCx, cell).permute(0, 2, 1, 3).reshape(nCy * nCx, cell * cell)
    k_cell = min(max(1, -(-n_keypoints // (nCy * nCx))), cell * cell)
    cs, ci = topk_stable(cells, k_cell)
    cidx = torch.arange(nCy * nCx, device=img.device)
    py = (cidx // nCx)[:, None] * cell + ci // cell
    px = (cidx % nCx)[:, None] * cell + ci % cell
    flat_s = cs.reshape(-1)
    n = min(n_keypoints, flat_s.shape[0])
    top_s, top_i = topk_stable(flat_s, n)
    uv = torch.stack(
        [px.reshape(-1)[top_i].to(torch.float32), py.reshape(-1)[top_i].to(torch.float32)], -1
    )
    uv = subpixel_refine(raw_score, uv)
    valid = top_s > 0.0
    if n < n_keypoints:
        pad = n_keypoints - n
        uv = torch.cat([uv, torch.zeros((pad, 2), device=img.device)])
        top_s = torch.cat([top_s, torch.zeros((pad,), device=img.device)])
        valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool, device=img.device)])
    return uv, top_s, valid
