"""A plain reference of direct image alignment through a lens: float64
torch, no kernel of the port, no JAX. (The benchmark keeps a frozen copy,
`perf_bench/align_ref.py`, which the card's comparison runs.)

The port's direct aligner warps through a pinhole and reads, on a
distorted camera, pyramid levels remapped to the pinhole camera
(`sdslam_tpu_torch/features/frame.py`). This reference keeps the lens in
the warp instead and reads the raw levels: the 4x4 patch of a point X of
the reference camera is taken at integer offsets o around its pinhole
pixel, each tap at the distorted position of that pinhole pixel,

    r_o(T) = I_cur(D(pi(T X) + o)) - I_ref(D(pi(X) + o)),

with pi the pinhole projection and D the radial-tangential distortion, both
at the level's scale. It minimizes the sum of r^2 over the taps whose
bilinear support lies inside both raw levels by forward-additive
Gauss-Newton on SE(3) (T <- exp(delta) T), Jacobians by autograd, levels
4 -> 2. The objective is the port's: only the interpolation differs (the
port blends twice, once in the remap and once in the aligner).
"""

from __future__ import annotations

import torch

F64 = torch.float64
PATCH_HALF = 2


def hat(w):
    z = torch.zeros((), dtype=w.dtype)
    return torch.stack([torch.stack([z, -w[2], w[1]]), torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def se3_exp(xi):
    """[6] (translation part, rotation part) -> [4,4], float64; smooth at 0."""
    rho, w = xi[:3], xi[3:]
    th2 = (w * w).sum()
    W = hat(w)
    # below a tiny angle, series to fourth order; the other branch is
    # evaluated at 1 there, so that autograd stays finite at 0
    small = th2 < 1e-12
    t2 = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(t2)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / t2)
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (th - torch.sin(th)) / (t2 * th))
    eye = torch.eye(3, dtype=xi.dtype)
    R = eye + a * W + b * (W @ W)
    V = eye + b * W + c * (W @ W)
    top = torch.cat([R, (V @ rho)[:, None]], 1)
    return torch.cat([top, torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=xi.dtype)], 0)


def distort(cam, uv, s: float):
    """Pinhole pixels [...,2] at level scale s -> raw pixels at that level."""
    x = (uv[..., 0] / s - cam.cx) / cam.fx
    y = (uv[..., 1] / s - cam.cy) / cam.fy
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([(cam.fx * xd + cam.cx) * s, (cam.fy * yd + cam.cy) * s], -1)


def pinhole(cam, Xc, s: float):
    z = Xc[..., 2].clamp(min=1e-9)
    return torch.stack([cam.fx * s * Xc[..., 0] / z + cam.cx * s,
                        cam.fy * s * Xc[..., 1] / z + cam.cy * s], -1)


def sample(img, uv):
    """Bilinear values of img [H,W] at uv [...,2] (differentiable in uv)
    and whether the 2x2 support lies inside."""
    H, W = img.shape
    fin = torch.isfinite(uv).all(-1)
    uv = torch.where(fin[..., None], uv, torch.full_like(uv, -1e9))
    x0 = torch.floor(uv[..., 0].detach().clamp(-1e9, 1e9))
    y0 = torch.floor(uv[..., 1].detach().clamp(-1e9, 1e9))
    ok = fin & (x0 >= 0) & (x0 < W - 1) & (y0 >= 0) & (y0 < H - 1)
    wx, wy = uv[..., 0] - x0, uv[..., 1] - y0
    xi = x0.clamp(0, W - 2).long()
    yi = y0.clamp(0, H - 2).long()
    v = ((1 - wx) * (1 - wy) * img[yi, xi] + wx * (1 - wy) * img[yi, xi + 1]
         + (1 - wx) * wy * img[yi + 1, xi] + wx * wy * img[yi + 1, xi + 1])
    return torch.where(ok, v, torch.zeros_like(v)), ok


def _offsets():
    d = torch.arange(-PATCH_HALF, PATCH_HALF, dtype=F64)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], -1)  # [16,2]


def align(ref_levels, cur_levels, X_ref, valid, T_init, cam, scale_factor: float = 2.0,
          start_level: int = 2, max_level: int = 4, min_level: int = 2, iters: int = 30):
    """T [4,4] float64 with X_cur = T X_ref, minimizing the photometric
    residual through the lens; ref_levels / cur_levels are the raw levels
    from `start_level` on ([H,W] each), X_ref [N,3] points of the reference
    camera, valid [N] bool."""
    X = X_ref.to(F64)
    T = T_init.to(F64)
    off = _offsets()
    for lvl in range(max_level, min_level - 1, -1):
        s = 1.0 / scale_factor**lvl
        ref = ref_levels[lvl - start_level].to(F64)
        cur = cur_levels[lvl - start_level].to(F64)
        patch, ok_ref = sample(ref, distort(cam, pinhole(cam, X, s)[:, None] + off, s))
        ok_ref = ok_ref & valid[:, None] & (X[:, 2] > 0.01)[:, None]

        def res(xi, T):
            Tx = se3_exp(xi) @ T
            Xc = X @ Tx[:3, :3].T + Tx[:3, 3]
            v, ok = sample(cur, distort(cam, pinhole(cam, Xc, s)[:, None] + off, s))
            m = ok_ref & ok & (Xc[:, 2] > 0.01)[:, None]
            return torch.where(m, (v - patch) / 255.0, torch.zeros_like(v)).reshape(-1)

        zero = torch.zeros(6, dtype=F64)
        cost = (res(zero, T) ** 2).sum()
        for _ in range(iters):
            r = res(zero, T)
            J = torch.autograd.functional.jacobian(lambda xi: res(xi, T), zero, vectorize=True,
                                                 strategy="forward-mode")
            H = J.T @ J
            delta = -torch.linalg.solve(H + 1e-9 * torch.diag(torch.diagonal(H)) + 1e-15
                                        * torch.eye(6, dtype=F64), J.T @ r)
            if not bool(torch.isfinite(delta).all()):
                break
            T_new = se3_exp(delta) @ T
            new_cost = (res(zero, T_new) ** 2).sum()
            if not bool(new_cost < cost):
                break
            T, cost = T_new, new_cost
            if float(delta.abs().max()) < 1e-10:
                break
    return T
