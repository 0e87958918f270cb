"""Point sampling from images (port of sdslam_tpu/ops/sample.py).

On the TPU these are one-hot matmuls (scattered gathers serialize there);
on a GPU and on the CPU a plain gather is the natural form. The arithmetic
order of the bilinear blend follows the JAX version: the row (y) blend
first, then the column (x) blend; out-of-range taps are clipped the same
way, so valid samples agree to rounding.
"""

from __future__ import annotations

import torch


def sample_nearest(img, uv):
    """img [H,W], uv [...,2] float (x,y) -> values [...] at round(uv), clamped."""
    H, W = img.shape
    x = torch.clamp(torch.round(uv[..., 0]).to(torch.int64), 0, W - 1)
    y = torch.clamp(torch.round(uv[..., 1]).to(torch.int64), 0, H - 1)
    return img[y, x]


def _floor_split(c):
    c0 = torch.floor(torch.clamp(c, -1e9, 1e9))
    return c0, c - c0, c0.to(torch.int64)


def sample_bilinear(img, uv):
    """Bilinear sample of img [H,W] at uv [...,2]; returns (values [...],
    valid [...]). valid marks samples whose 2x2 support is fully inside;
    out-of-range values are 0."""
    H, W = img.shape
    shp = uv.shape[:-1]
    _, wx, x0i = _floor_split(uv[..., 0].reshape(-1))
    _, wy, y0i = _floor_split(uv[..., 1].reshape(-1))
    valid = (x0i >= 0) & (x0i < W - 1) & (y0i >= 0) & (y0i < H - 1)
    x0c = torch.clamp(x0i, 0, W - 2)
    y0c = torch.clamp(y0i, 0, H - 2)

    def rowval(dx):  # y-blend of rows (y0, y0+1) at column x0+dx
        return (1.0 - wy) * img[y0c, x0c + dx] + wy * img[y0c + 1, x0c + dx]

    out = (1.0 - wx) * rowval(0) + wx * rowval(1)
    out = torch.where(valid, out, torch.zeros_like(out))
    return out.reshape(shp), valid.reshape(shp)


def sample_bilinear_patch(img, uv_center, patch_half: int = 2):
    """Bilinear-sample a (2*patch_half)^2 patch of INTEGER offsets around
    each center (dy-outer/dx-inner order). Returns (values [N, P*P],
    valid [N, P*P]); invalid taps are 0."""
    H, W = img.shape
    P = 2 * patch_half
    _, wx, x0i = _floor_split(uv_center[:, 0])
    _, wy, y0i = _floor_split(uv_center[:, 1])
    x0c = torch.clamp(x0i, 0, W - 2)
    y0c = torch.clamp(y0i, 0, H - 2)
    d = torch.arange(P, device=img.device) - patch_half  # [P]
    ya = torch.clamp(y0c[:, None] + d, 0, H - 1)  # [N,P]
    yb = torch.clamp(y0c[:, None] + 1 + d, 0, H - 1)
    xa = torch.clamp(x0c[:, None] + d, 0, W - 1)
    xb = torch.clamp(x0c[:, None] + 1 + d, 0, W - 1)
    wy_ = wy[:, None, None]
    wx_ = wx[:, None, None]

    def blend_rows(xcol):  # [N,P(y),P(x)] y-blend at columns xcol [N,P]
        top = img[ya[:, :, None], xcol[:, None, :]]
        bot = img[yb[:, :, None], xcol[:, None, :]]
        return (1.0 - wy_) * top + wy_ * bot

    vals = (1.0 - wx_) * blend_rows(xa) + wx_ * blend_rows(xb)
    yok = (y0i[:, None] + d >= 0) & (y0i[:, None] + d < H - 1)
    xok = (x0i[:, None] + d >= 0) & (x0i[:, None] + d < W - 1)
    ok = (yok[:, :, None] & xok[:, None, :]).reshape(-1, P * P)
    vals = vals.reshape(-1, P * P)
    return torch.where(ok, vals, torch.zeros_like(vals)), ok


def sample_bilinear_with_grad(img, uv):
    """Bilinear value + central-difference gradient at uv [...,2].
    Returns (val, gx, gy, valid); the 5-sample cross needs a 1px margin.

    img [H,W], or a batch [B,H,W] with uv [B,...,2]: lane b samples img[b]
    (the gather carries a batch offset, as jax.vmap of the 2-D form)."""
    H, W = img.shape[-2:]
    shp = uv.shape[:-1]
    _, wx, x0i = _floor_split(uv[..., 0].reshape(-1))
    _, wy, y0i = _floor_split(uv[..., 1].reshape(-1))
    valid = (x0i >= 1) & (x0i < W - 2) & (y0i >= 1) & (y0i < H - 2)
    x0c = torch.clamp(x0i, 0, W - 2)
    y0c = torch.clamp(y0i, 0, H - 2)
    flat = img.reshape(-1)
    base = 0
    if img.dim() == 3:
        lane = torch.arange(img.shape[0], device=img.device) * (H * W)
        base = lane.reshape((-1,) + (1,) * (len(shp) - 1)).expand(shp).reshape(-1)

    def at(dy, dx):
        yy = torch.clamp(y0c + dy, 0, H - 1)
        xx = torch.clamp(x0c + dx, 0, W - 1)
        return flat[base + yy * W + xx]

    def rowval(dy, dx):  # y-blend of rows (dy, dy+1) at column offset dx
        return (1.0 - wy) * at(dy, dx) + wy * at(dy + 1, dx)

    def xblend(f):  # x-blend of a column function at offsets (0, 1)
        return (1.0 - wx) * f(0) + wx * f(1)

    val = xblend(lambda dx: rowval(0, dx))
    # gx: row blend at x0, then 0.5 * (f(x+1) - f(x-1)) with the x weights
    gx = 0.5 * (xblend(lambda dx: rowval(0, dx + 1)) - xblend(lambda dx: rowval(0, dx - 1)))
    gy = 0.5 * (xblend(lambda dx: rowval(1, dx)) - xblend(lambda dx: rowval(-1, dx)))
    z = torch.zeros_like(val)
    val = torch.where(valid, val, z)
    gx = torch.where(valid, gx, z)
    gy = torch.where(valid, gy, z)
    return val.reshape(shp), gx.reshape(shp), gy.reshape(shp), valid.reshape(shp)
