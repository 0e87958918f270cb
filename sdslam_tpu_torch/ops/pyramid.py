"""Image pyramid ops (port of sdslam_tpu/ops/pyramid.py): separable
Gaussian blur as sliced multiply-adds with edge replication, and an exact
2x decimation (5-tap blur, then stride 2). A non-dyadic scale factor
blurs each level (sigma 0.8) and resizes it linearly with antialiasing,
as jax.image.resize does when it downsamples."""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _sep_conv2d(img, k1d):
    """Separable 2D convolution with edge replication, img [H,W] f32; the
    taps are summed in the same order as the JAX version."""
    r = (len(k1d) - 1) // 2
    H, W = img.shape
    xp = F.pad(img[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
    x = sum(float(k1d[i]) * xp[:, i: i + W] for i in range(2 * r + 1))
    xp = F.pad(x[None, None], (0, 0, r, r), mode="replicate")[0, 0]
    return sum(float(k1d[i]) * xp[i: i + H, :] for i in range(2 * r + 1))


def gaussian_blur(img, sigma: float = 2.0, radius: int = 3):
    """7x7 Gaussian blur (the ORB pre-descriptor blur)."""
    return _sep_conv2d(img, gaussian_kernel1d(sigma, radius))


def downsample2(img):
    """Anti-aliased exact 2x downsample: 5-tap blur then stride 2."""
    blurred = _sep_conv2d(img, gaussian_kernel1d(1.0, 2))
    H, W = blurred.shape
    if H % 2 or W % 2:
        blurred = F.pad(blurred[None, None], (0, W % 2, 0, H % 2), mode="replicate")[0, 0]
    return blurred[::2, ::2].contiguous()


def level_scales(n_levels: int, scale_factor: float) -> List[float]:
    return [scale_factor**i for i in range(n_levels)]


def build_pyramid(img, n_levels: int, scale_factor: float = 2.0):
    """img [H,W] float32 -> list of levels [H/s^i, W/s^i]."""
    levels = [img]
    for i in range(1, n_levels):
        prev = levels[-1]
        if scale_factor == 2.0:
            levels.append(downsample2(prev))
        else:
            h = int(round(img.shape[0] / scale_factor**i))
            w = int(round(img.shape[1] / scale_factor**i))
            levels.append(F.interpolate(gaussian_blur(prev, 0.8)[None, None], size=(h, w),
                                        mode="bilinear", align_corners=False,
                                        antialias=True)[0, 0])
    return levels


def level_quotas(n_total: int, n_levels: int, scale_factor: float) -> List[int]:
    """Geometric per-level feature quotas."""
    inv = 1.0 / scale_factor
    weights = np.array([inv**i for i in range(n_levels)])
    weights /= weights.sum()
    q = np.floor(n_total * weights).astype(int)
    q[0] += n_total - q.sum()
    return [int(v) for v in q]
