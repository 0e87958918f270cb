"""Plain reference of ORB extraction, and the comparison that judges the
program's.

Frozen copy, in plain PyTorch, of the extraction semantics of
`sdslam_tpu_torch/ops/pyramid.py`, `ops/fast.py`, `ops/orb.py`,
`ops/sample.py` and `features/frame.py` (dyadic pyramid with an exact
5-tap 2x decimation, FAST-9 with 3x3 non-maximum suppression, per-cell
then global top-k with stable ties, quadratic subpixel refinement,
intensity-centroid orientation, steered BRIEF over 30 angle bins from the
seed-1234 pattern). Keypoints are undistorted by the exact inverse of the
lens model (`scene.undistort_pixels`), not by the program's iteration. It
imports nothing of the program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from perf_bench import scene as sc

CIRCLE16 = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
            (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))
ARC = 9
CELL, BORDER = 16, 19
HALF_PATCH = 15
N_ANGLE_BINS = 30
DEPTH_REL_TOL = 1e-4


def _topk(x, k):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _kernel1d(sigma: float, radius: int):
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _sep_conv(img, k1d):
    r = (len(k1d) - 1) // 2
    H, W = img.shape
    xp = F.pad(img[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
    x = sum(float(k1d[i]) * xp[:, i: i + W] for i in range(2 * r + 1))
    xp = F.pad(x[None, None], (0, 0, r, r), mode="replicate")[0, 0]
    return sum(float(k1d[i]) * xp[i: i + H, :] for i in range(2 * r + 1))


def pyramid(img, n_levels: int):
    levels = [img]
    for _ in range(1, n_levels):
        b = _sep_conv(levels[-1], _kernel1d(1.0, 2))
        H, W = b.shape
        if H % 2 or W % 2:
            b = F.pad(b[None, None], (0, W % 2, 0, H % 2), mode="replicate")[0, 0]
        levels.append(b[::2, ::2].contiguous())
    return levels


def quotas(n_total: int, n_levels: int, scale_factor: float):
    w = np.array([(1.0 / scale_factor) ** i for i in range(n_levels)])
    w /= w.sum()
    q = np.floor(n_total * w).astype(int)
    q[0] += n_total - q.sum()
    return [int(v) for v in q]


def _window_min(x, win: int):
    acc, size = x, 1
    while size * 2 <= win:
        acc = torch.minimum(acc, torch.roll(acc, -size, dims=0))
        size *= 2
    if size < win:
        acc = torch.minimum(acc, torch.roll(acc, -(win - size), dims=0))
    return acc


def fast_scores(img):
    H, W = img.shape
    diffs = torch.stack([torch.roll(img, (-dy, -dx), dims=(0, 1)) for dy, dx in CIRCLE16]) - img
    score = torch.clamp(torch.maximum(torch.amax(_window_min(diffs, ARC), 0),
                                      torch.amax(_window_min(-diffs, ARC), 0)), min=0.0)
    v = torch.arange(H, device=img.device)[:, None]
    u = torch.arange(W, device=img.device)[None, :]
    inb = (v >= BORDER) & (v < H - BORDER) & (u >= BORDER) & (u < W - BORDER)
    return torch.where(inb, score, torch.zeros_like(score))


def _subpixel(score, uv):
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
    return uv + torch.stack([ox, oy], -1)


def detect(img, n: int, threshold: float):
    H, W = img.shape
    raw = fast_scores(img)
    m = F.max_pool2d(raw[None, None], 3, stride=1, padding=1)[0, 0]
    score = torch.where((raw >= m) & (raw > threshold), raw, torch.zeros_like(raw))
    Hp, Wp = -(-H // CELL) * CELL, -(-W // CELL) * CELL
    ny, nx = Hp // CELL, Wp // CELL
    cells = (F.pad(score, (0, Wp - W, 0, Hp - H)).reshape(ny, CELL, nx, CELL)
             .permute(0, 2, 1, 3).reshape(ny * nx, CELL * CELL))
    cs, ci = _topk(cells, min(max(1, -(-n // (ny * nx))), CELL * CELL))
    cidx = torch.arange(ny * nx, device=img.device)
    py = ((cidx // nx)[:, None] * CELL + ci // CELL).reshape(-1)
    px = ((cidx % nx)[:, None] * CELL + ci % CELL).reshape(-1)
    top_s, top_i = _topk(cs.reshape(-1), min(n, cs.numel()))
    uv = _subpixel(raw, torch.stack([px[top_i].float(), py[top_i].float()], -1))
    return uv, top_s > 0.0


def _nearest(img, uv):
    H, W = img.shape
    x = torch.clamp(torch.round(uv[..., 0]).to(torch.int64), 0, W - 1)
    y = torch.clamp(torch.round(uv[..., 1]).to(torch.int64), 0, H - 1)
    return img[y, x]


def orientations(img, uv):
    R = HALF_PATCH
    dev = img.device
    csy = torch.cat([torch.zeros((1, img.shape[1]), device=dev), torch.cumsum(img, 0)])
    m10 = torch.zeros_like(img)
    for dx in range(-R, R + 1):
        if dx:
            h = int(np.floor(np.sqrt(R * R - dx * dx)))
            col = torch.roll(csy[1:], -h, dims=0) - torch.roll(csy[:-1], h, dims=0)
            m10 = m10 + float(dx) * torch.roll(col, -dx, dims=1)
    csx = torch.cat([torch.zeros((img.shape[0], 1), device=dev), torch.cumsum(img, 1)], 1)
    m01 = torch.zeros_like(img)
    for dy in range(-R, R + 1):
        if dy:
            w = int(np.floor(np.sqrt(R * R - dy * dy)))
            row = torch.roll(csx[:, 1:], -w, dims=1) - torch.roll(csx[:, :-1], w, dims=1)
            m01 = m01 + float(dy) * torch.roll(row, -dy, dims=0)
    return torch.atan2(_nearest(m01, uv), _nearest(m10, uv))


@functools.lru_cache()
def _binned_pairs() -> np.ndarray:
    """[30, 256, 2, 2] rotated (dy, dx) offsets of the seed-1234 Gaussian
    pattern's pairs, per angle bin."""
    rng = np.random.default_rng(1234)
    pts = rng.normal(0.0, 27 / 5.0, size=(256, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    pts = np.round(pts * np.minimum(1.0, 13 / np.maximum(norm, 1e-6))).astype(np.int32)
    pts[(pts[:, 0] == pts[:, 1]).all(-1), 1, 0] += 1
    pat = pts.astype(np.float64)
    out = np.zeros((N_ANGLE_BINS, 256, 2, 2), np.int64)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        out[b, :, :, 0] = np.round(sa * pat[:, :, 0] + ca * pat[:, :, 1])
        out[b, :, :, 1] = np.round(ca * pat[:, :, 0] - sa * pat[:, :, 1])
    return out


def descriptors(blurred, uv, angle):
    """[N,256] bool bits of steered BRIEF."""
    H, W = blurred.shape
    two_pi = 2.0 * np.pi
    b = torch.remainder(torch.round(torch.remainder(angle, two_pi) / (two_pi / N_ANGLE_BINS))
                        .to(torch.int64), N_ANGLE_BINS)
    pairs = torch.as_tensor(_binned_pairs(), device=blurred.device)[b]
    x0 = torch.round(uv[:, 0]).to(torch.int64)
    y0 = torch.round(uv[:, 1]).to(torch.int64)
    ys = torch.clamp(y0[:, None, None] + pairs[..., 0], 0, H - 1)
    xs = torch.clamp(x0[:, None, None] + pairs[..., 1], 0, W - 1)
    px = blurred[ys, xs]
    return px[..., 1] > px[..., 0]


def extract(img_u8: np.ndarray, cam: sc.Camera, n_features: int, n_levels: int,
            scale_factor: float, threshold: float, device):
    """The reference's keypoints of one image: dict of uv [M,2], uv_und
    [M,2], octave [M], angle [M], bits [M,256] (valid keypoints only)."""
    if scale_factor != 2.0:
        raise ValueError("the reference pyramid is dyadic (scaleFactor 2)")
    img = torch.as_tensor(img_u8, device=device).to(torch.float32)
    out = {k: [] for k in ("uv", "octave", "angle", "bits")}
    for lvl, (im, q) in enumerate(zip(pyramid(img, n_levels),
                                      quotas(n_features, n_levels, scale_factor))):
        if q <= 0:
            continue
        uv, valid = detect(im, q, threshold)
        uv = uv[valid]
        ang = orientations(im, uv)
        out["bits"].append(descriptors(_sep_conv(im, _kernel1d(2.0, 3)), uv, ang))
        out["uv"].append(uv * scale_factor**lvl)
        out["octave"].append(torch.full((len(uv),), lvl, device=device))
        out["angle"].append(ang)
    res = {k: torch.cat(v) for k, v in out.items()}
    res["uv_und"] = sc.undistort_pixels(cam, res["uv"])
    return res


def keypoint_depth(depth_u16: np.ndarray, uv: torch.Tensor, factor: float) -> torch.Tensor:
    """Metric depth (m) of keypoints uv [M,2] as the RGB-D transport
    delivers it: the u16 depth decimated 2x2 (every other pixel), read at
    the nearest decimated pixel, over DepthMapFactor; -1 without a reading."""
    d = torch.as_tensor(depth_u16[::2, ::2].astype(np.float32), device=uv.device) / factor
    z = _nearest(d, uv * 0.5)
    return torch.where(z > 0, z, torch.full_like(z, -1.0))


def desc_bits(words: torch.Tensor) -> torch.Tensor:
    """[M,8] int32 descriptor words (bit s of word w = pair 32 w + s) ->
    [M,256] bool."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, device=words.device)
    return ((w[:, :, None] >> shifts) & 1).bool().reshape(-1, 256)


def mismatch(ref: dict, prog: dict, px_tol: float, bit_tol: int) -> tuple:
    """(unmatched, total): keypoints of either side with no partner on the
    other at the same octave, within `px_tol` pixels in raw and in
    undistorted coordinates, with descriptors differing in at most
    `bit_tol` of 256 bits. `prog` holds the program's valid keypoints in
    the same form (bits from `desc_bits`)."""
    def unmatched(a, b):
        if len(a["uv"]) == 0:
            return 0
        if len(b["uv"]) == 0:
            return len(a["uv"])
        d_raw = torch.cdist(a["uv"].double(), b["uv"].double())
        d_und = torch.cdist(a["uv_und"].double(), b["uv_und"].double())
        same = a["octave"][:, None].long() == b["octave"][None, :].long()
        near = same & (d_raw <= px_tol) & (d_und <= px_tol)
        if "depth" in a:
            da, db = a["depth"].double()[:, None], b["depth"].double()[None, :]
            near &= (da - db).abs() <= DEPTH_REL_TOL * da.abs()
        hit = torch.zeros(len(a["uv"]), dtype=torch.bool, device=near.device)
        for i, j in near.nonzero().tolist():
            if not hit[i] and int((a["bits"][i] ^ b["bits"][j]).sum()) <= bit_tol:
                hit[i] = True
        return int((~hit).sum())

    return unmatched(ref, prog) + unmatched(prog, ref), len(ref["uv"]) + len(prog["uv"])
