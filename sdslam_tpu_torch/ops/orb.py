"""ORB orientation + steered-BRIEF descriptors (port of sdslam_tpu/ops/orb.py).

The BRIEF pattern is the same seeded Gaussian pattern (numpy, seed 1234),
quantized to 30 angle bins with the same rounding, so descriptors agree bit
for bit. On the TPU each bit is a +-1 difference-matrix matmul over the
29x29 patch; here it is the direct comparison of the two sampled pixels,
which is the same predicate: (p1 - p0 > 0) == (p1 > p0).

Descriptors are [N, 8] int32 holding the uint32 words (bit s of word w is
pattern pair 32*w + s).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

HALF_PATCH = 15  # orientation patch radius (31x31)
PATTERN_BITS = 256
PATTERN_RADIUS = 13
DESC_WORDS = 8
N_ANGLE_BINS = 30
PATCH_R = 14
PATCH_W = 2 * PATCH_R + 1


@functools.lru_cache()
def brief_pattern(seed: int = 1234) -> np.ndarray:
    """[256, 2, 2] int32 point pairs (x, y), Gaussian sigma=patch/5, radius<=13."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, (2 * PATTERN_RADIUS + 1) / 5.0, size=(PATTERN_BITS, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    scale = np.minimum(1.0, PATTERN_RADIUS / np.maximum(norm, 1e-6))
    pts = np.round(pts * scale).astype(np.int32)
    same = (pts[:, 0] == pts[:, 1]).all(axis=-1)
    pts[same, 1, 0] += 1
    return pts


@functools.lru_cache()
def _binned_pairs(seed: int = 1234) -> np.ndarray:
    """[N_ANGLE_BINS, 256, 2, 2] int64 rotated (dy, dx) offsets of each pair's
    (p0, p1) for each angle bin (the offsets the JAX difference matrices
    place their -1 / +1 at)."""
    pat = brief_pattern(seed).astype(np.float64)
    out = np.zeros((N_ANGLE_BINS, PATTERN_BITS, 2, 2), np.int64)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        rx = np.round(ca * pat[:, :, 0] - sa * pat[:, :, 1]).astype(np.int64)
        ry = np.round(sa * pat[:, :, 0] + ca * pat[:, :, 1]).astype(np.int64)
        out[b, :, :, 0] = ry
        out[b, :, :, 1] = rx
    return out


@functools.lru_cache()
def _binned_pairs_on(device: torch.device) -> torch.Tensor:
    """_binned_pairs() on device, uploaded once (each upload would
    synchronize the stream)."""
    return torch.as_tensor(_binned_pairs(), device=device)


def moment_maps(img):
    """Whole-image circular-patch moments (m10, m01) [H,W] via prefix sums
    (border pixels wrap, as in the JAX version)."""
    R = HALF_PATCH
    csy = torch.cat([torch.zeros((1, img.shape[1]), device=img.device), torch.cumsum(img, 0)])
    m10 = torch.zeros_like(img)
    for dx in range(-R, R + 1):
        if dx == 0:
            continue
        h = int(np.floor(np.sqrt(R * R - dx * dx)))
        col = torch.roll(csy[1:], -h, dims=0) - torch.roll(csy[:-1], h, dims=0)
        m10 = m10 + float(dx) * torch.roll(col, -dx, dims=1)
    csx = torch.cat([torch.zeros((img.shape[0], 1), device=img.device), torch.cumsum(img, 1)], 1)
    m01 = torch.zeros_like(img)
    for dy in range(-R, R + 1):
        if dy == 0:
            continue
        w = int(np.floor(np.sqrt(R * R - dy * dy)))
        row = torch.roll(csx[:, 1:], -w, dims=1) - torch.roll(csx[:, :-1], w, dims=1)
        m01 = m01 + float(dy) * torch.roll(row, -dy, dims=0)
    return m10, m01


def orientations(img, uv, valid):
    """Intensity-centroid angles (radians) for keypoints uv [N,2]."""
    from sdslam_tpu_torch.ops import sample as smp

    m10, m01 = moment_maps(img)
    ang = torch.atan2(smp.sample_nearest(m01, uv), smp.sample_nearest(m10, uv))
    return torch.where(valid, ang, torch.zeros_like(ang))


def extract_patches(img, uv, half: int):
    """[N, 2h+1, 2h+1] patches centred on the rounded keypoints uv [N,2],
    clamped at the image border."""
    H, W = img.shape
    d = torch.arange(-half, half + 1, device=img.device)
    x0 = torch.round(uv[:, 0]).to(torch.int64)
    y0 = torch.round(uv[:, 1]).to(torch.int64)
    ry = torch.clamp(y0[:, None] + d, 0, H - 1)  # [N,w]
    rx = torch.clamp(x0[:, None] + d, 0, W - 1)
    return img[ry[:, :, None], rx[:, None, :]]


def descriptors(img_blurred, uv, angle, valid):
    """Steered-BRIEF 256-bit descriptors -> [N, 8] int32 (uint32 words)."""
    H, W = img_blurred.shape
    dev = img_blurred.device
    two_pi = 2.0 * np.pi
    bin_f = torch.round(torch.remainder(angle, two_pi) / (two_pi / N_ANGLE_BINS))
    bin_i = torch.remainder(bin_f.to(torch.int64), N_ANGLE_BINS)
    pairs = _binned_pairs_on(dev)[bin_i]  # [N,256,2(p0,p1),2(dy,dx)]
    x0 = torch.round(uv[:, 0]).to(torch.int64)
    y0 = torch.round(uv[:, 1]).to(torch.int64)
    ys = torch.clamp(y0[:, None, None] + pairs[..., 0], 0, H - 1)
    xs = torch.clamp(x0[:, None, None] + pairs[..., 1], 0, W - 1)
    px = img_blurred[ys, xs]  # [N,256,2]
    bits = (px[..., 1] > px[..., 0]).to(torch.int64).reshape(-1, DESC_WORDS, 32)
    weights = torch.bitwise_left_shift(torch.ones(32, dtype=torch.int64, device=dev),
                                       torch.arange(32, device=dev))
    words = torch.sum(bits * weights, dim=-1)  # [N,8] in [0, 2^32)
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return torch.where(valid[:, None], words, torch.zeros_like(words))
