"""Bilinear sampling + image gradients (port of sdslam_tpu/ops/interp.py,
a thin layer over ops.sample)."""

from __future__ import annotations

from sdslam_tpu_torch.ops import sample as _s


def bilinear_sample_with_grad(img, uv):
    """Sample value and central-difference gradient at uv [...,2] (img
    [H,W], or [B,H,W] with uv [B,...,2]). Returns (val, gx, gy, valid); the
    gradient support needs a 1px margin."""
    return _s.sample_bilinear_with_grad(img, uv)
