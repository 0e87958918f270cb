"""Bilinear sampling + image gradients (port of sdslam_tpu/ops/interp.py,
a thin layer over ops.sample)."""

from __future__ import annotations

from sdslam_tpu_torch.ops import sample as _s


def bilinear_sample(img, uv):
    """Sample img [H,W] at float coords uv [...,2] (x,y). Returns (values
    [...], valid [...]): valid marks samples whose 2x2 support is fully
    inside the image; out-of-range values are 0."""
    return _s.sample_bilinear(img, uv)


def bilinear_sample_with_grad(img, uv):
    """Sample value and central-difference gradient at uv [...,2] (img
    [H,W], or [B,H,W] with uv [B,...,2]). Returns (val, gx, gy, valid); the
    gradient support needs a 1px margin."""
    return _s.sample_bilinear_with_grad(img, uv)
