"""Pinhole camera with radial-tangential distortion (torch, batched).

Port of sdslam_tpu/geometry/camera.py: the same static CameraModel fields
and the same project / backproject / undistort / in-image / virtual-right
conventions (RGB-D virtual right coordinate u_r = u - bf/d).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CameraModel(NamedTuple):
    """Static pinhole intrinsics (python floats/ints, hashable)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0  # baseline * fx, for the RGB-D virtual right coord
    fps: float = 30.0

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))

    def K(self, device=None):
        # built from fills: a host->device copy would synchronize the stream
        vals = (self.fx, 0.0, self.cx, 0.0, self.fy, self.cy, 0.0, 0.0, 1.0)
        return torch.stack([torch.full((), v, device=device) for v in vals]).reshape(3, 3)

    def scaled(self, s: float) -> "CameraModel":
        """Intrinsics for a pyramid level scaled by factor s (<1 shrinks)."""
        return self._replace(
            fx=self.fx * s, fy=self.fy * s, cx=self.cx * s, cy=self.cy * s,
            width=int(round(self.width * s)), height=int(round(self.height * s)),
            bf=self.bf * s,
        )


def _distortion(cam: CameraModel, x, y):
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xy = x * y
    dx = 2.0 * cam.p1 * xy + cam.p2 * (r2 + 2.0 * x * x)
    dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * xy
    return radial, dx, dy


def distort_normalized(cam: CameraModel, xn):
    x, y = xn[..., 0], xn[..., 1]
    radial, dx, dy = _distortion(cam, x, y)
    return torch.stack([x * radial + dx, y * radial + dy], dim=-1)


def undistort_normalized(cam: CameraModel, xd, iters: int = 8):
    """Invert distortion by fixed-point iteration (cv::undistortPoints style)."""
    if not cam.has_distortion:
        return xd
    xn = xd
    for _ in range(iters):
        radial, dx, dy = _distortion(cam, xn[..., 0], xn[..., 1])
        xn = torch.stack([(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial], dim=-1)
    return xn


def project(cam: CameraModel, Xc, distort: bool = False):
    """Camera-frame points [...,3] -> pixel uv [...,2] and depth [...]."""
    z = Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    xn = Xc[..., :2] / zs[..., None]
    if distort and cam.has_distortion:
        xn = distort_normalized(cam, xn)
    uv = torch.stack([cam.fx * xn[..., 0] + cam.cx, cam.fy * xn[..., 1] + cam.cy], dim=-1)
    return uv, z


def backproject(cam: CameraModel, uv, depth, undistort: bool = False):
    """Pixels [...,2] + depth [...] -> camera-frame 3D points [...,3]."""
    xn = torch.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1
    )
    if undistort:
        xn = undistort_normalized(cam, xn)
    return torch.cat([xn * depth[..., None], depth[..., None]], dim=-1)


def undistort_pixels(cam: CameraModel, uv):
    """Distorted pixels -> undistorted pixels (same K re-projection)."""
    if not cam.has_distortion:
        return uv
    xn = torch.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1
    )
    xu = undistort_normalized(cam, xn)
    return torch.stack([cam.fx * xu[..., 0] + cam.cx, cam.fy * xu[..., 1] + cam.cy], dim=-1)


def in_image(cam: CameraModel, uv, border: float = 0.0):
    u, v = uv[..., 0], uv[..., 1]
    return (u >= border) & (u < cam.width - border) & (v >= border) & (v < cam.height - border)


def project_jacobian(cam: CameraModel, Xc):
    """d(uv)/d(Xc) for the undistorted pinhole model: [...,2,3]."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zi = 1.0 / torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    row0 = torch.stack([cam.fx * zi, zero, -cam.fx * x * zi2], dim=-1)
    row1 = torch.stack([zero, cam.fy * zi, -cam.fy * y * zi2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def virtual_right(cam: CameraModel, u, depth):
    """RGB-D virtual right coordinate: u - bf/d; -1 if no depth."""
    ok = depth > 0
    d = torch.where(ok, depth, torch.ones_like(depth))
    return torch.where(ok, u - cam.bf / d, torch.full_like(u, -1.0))
