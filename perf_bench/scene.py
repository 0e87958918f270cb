"""The benchmark's synthetic world: a textured room, a camera that sees it
through its published lens distortion, and the periodic orbit a cell's
camera patrols.

Frozen copy of `sdslam_tpu_torch/io/synthetic.py` (`make_room_scene`,
`scene_intensity`, `render`, `orbit_trajectory`), kept here so that no
change to the program moves the yardstick. One addition: `render` casts
each pixel's ray through the camera's radial-tangential distortion, so the
images are those of the real lens and the program's undistortion does
real work. The ray is the exact inverse of the published distortion model
(Newton's method in float64, held to a residual of `UNDISTORT_TOL_PX`),
not the program's approximation of it.
`surface_distance` gives the truth a map point is judged by.

Plain numpy and torch; imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

UNDISTORT_TOL_PX = 1e-6  # distort(undistort(pixel)) lands this close to the pixel
NEWTON_ITERS = 30
DOWN = (0.0, 1.0, 0.0)  # the room's down axis (make_room_scene: x right, y down, z forward)


class Camera(NamedTuple):
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

    @classmethod
    def from_yaml_keys(cls, keys: dict) -> "Camera":
        """From the reference's `Camera.*` settings."""
        return cls(*(float(keys[f"Camera.{k}"]) for k in ("fx", "fy", "cx", "cy")),
                   int(keys["Camera.Width"]), int(keys["Camera.Height"]),
                   *(float(keys.get(f"Camera.{k}", 0.0)) for k in ("k1", "k2", "p1", "p2", "k3")))


class PlaneScene(NamedTuple):
    normals: torch.Tensor  # [P,3] room planes n.x = d
    offsets: torch.Tensor  # [P]
    rect_origin: torch.Tensor  # [B,3]
    rect_u: torch.Tensor  # [B,3]
    rect_v: torch.Tensor  # [B,3]
    freqs: torch.Tensor  # [K,3]
    phases: torch.Tensor  # [K]
    amps: torch.Tensor  # [K]
    biases: torch.Tensor  # [P+B]

    def to(self, device) -> "PlaneScene":
        return PlaneScene(*(t.to(device) for t in self))


def make_room_scene(seed: int = 0, n_waves: int = 48, size: float = 2.5) -> PlaneScene:
    """Open room around the origin (x right, y down, z forward: `DOWN`):
    five textured walls and eight textured rectangles floating inside."""
    rng = np.random.default_rng(seed)
    normals = np.array(
        [[0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0],
         [0.0, -1.0, 0.0], [0.0, 1.0, 0.0]],
        dtype=np.float32,
    )
    offsets = np.array([-size, -size / 2, -size / 2, -size / 3, -size / 3], np.float32)
    n_waves = max(n_waves, 128)
    dirs = rng.normal(size=(n_waves, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    mags = np.exp(rng.uniform(np.log(1.5), np.log(150.0), size=(n_waves, 1)))
    freqs = (dirs * mags).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, size=n_waves).astype(np.float32)
    amps = (mags[:, 0] ** 0.3).astype(np.float32)
    amps *= np.sqrt(2.0) / np.sqrt((amps**2).sum())
    origins, us, vs = [], [], []
    for _ in range(8):
        c = np.array(
            [rng.uniform(-size / 3, size / 3), rng.uniform(-size / 4, size / 4),
             rng.uniform(0.8, size - 0.4)],
            np.float32,
        )
        a = rng.normal(size=3)
        a /= np.linalg.norm(a)
        b = np.cross(a, rng.normal(size=3))
        b /= np.linalg.norm(b)
        origins.append(c)
        us.append((a * rng.uniform(0.15, 0.45)).astype(np.float32))
        vs.append((b * rng.uniform(0.15, 0.45)).astype(np.float32))
    biases = rng.uniform(0.35, 0.65, size=len(normals) + 8).astype(np.float32)
    t = torch.as_tensor
    return PlaneScene(t(normals), t(offsets), t(np.stack(origins)), t(np.stack(us)),
                      t(np.stack(vs)), t(freqs), t(phases), t(amps), t(biases))


def distort_normalized(cam: Camera, x, y):
    """Undistorted normalized coordinates -> distorted: the published
    radial (k1, k2, k3) and tangential (p1, p2) model."""
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    return (x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x),
            y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y)


def undistort_normalized(cam: Camera, x, y):
    """Distorted normalized coordinates -> undistorted, in float64: Newton's
    method on distort(x) = x_d. Raises where some point's distortion is not
    reproduced to `UNDISTORT_TOL_PX`."""
    xd, yd = x.double(), y.double()
    xn, yn = xd.clone(), yd.clone()
    for _ in range(NEWTON_ITERS):
        fx, fy = distort_normalized(cam, xn, yn)
        ex, ey = fx - xd, fy - yd
        r2 = xn * xn + yn * yn
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dradial = cam.k1 + r2 * (2.0 * cam.k2 + 3.0 * r2 * cam.k3)  # d radial / d r2
        cross = 2.0 * xn * yn * dradial + 2.0 * cam.p1 * xn + 2.0 * cam.p2 * yn
        jxx = radial + 2.0 * xn * xn * dradial + 2.0 * cam.p1 * yn + 6.0 * cam.p2 * xn
        jyy = radial + 2.0 * yn * yn * dradial + 6.0 * cam.p1 * yn + 2.0 * cam.p2 * xn
        det = jxx * jyy - cross * cross
        xn = xn - (jyy * ex - cross * ey) / det
        yn = yn - (jxx * ey - cross * ex) / det
    fx, fy = distort_normalized(cam, xn, yn)
    res = float(torch.sqrt(((fx - xd) * cam.fx) ** 2 + ((fy - yd) * cam.fy) ** 2).max()) \
        if xn.numel() else 0.0
    if not res <= UNDISTORT_TOL_PX:
        raise ValueError(f"the lens is not inverted to {UNDISTORT_TOL_PX} px ({res} px)")
    return xn, yn


def undistort_pixels(cam: Camera, uv):
    """Raw pixels [...,2] -> undistorted pixels (same intrinsics), float64."""
    x = (uv[..., 0].double() - cam.cx) / cam.fx
    y = (uv[..., 1].double() - cam.cy) / cam.fy
    xn, yn = undistort_normalized(cam, x, y)
    return torch.stack([cam.fx * xn + cam.cx, cam.fy * yn + cam.cy], -1)


def pixel_rays(cam: Camera, device) -> torch.Tensor:
    """[H,W,3] camera-frame ray of each pixel's centre, z = 1."""
    H, W = cam.height, cam.width
    u = torch.arange(W, dtype=torch.float64, device=device)[None, :].expand(H, W)
    v = torch.arange(H, dtype=torch.float64, device=device)[:, None].expand(H, W)
    xn, yn = undistort_normalized(cam, (u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy)
    return torch.stack([xn, yn, torch.ones_like(xn)], -1).float()


def _dot(a, b):
    return (a * b).sum(-1)


def render(scene: PlaneScene, rays: torch.Tensor, Tcw: torch.Tensor):
    """Grey image [H,W] in [0,255] and depth [H,W] (m, z along the optical
    axis; 0 where no surface) seen from Tcw [4,4] along `rays` [H,W,3].
    Element-wise float32 only (no matrix products, so no TF32)."""
    Rcw, tcw = Tcw[:3, :3], Tcw[:3, 3]
    Rwc = Rcw.T
    twc = -(Rwc * tcw[None, :]).sum(-1)
    dw = (rays[..., None, :] * Rwc).sum(-1)  # [H,W,3] world ray, camera z = 1
    n_dot_o = _dot(scene.normals, twc)
    n_dot_d = (dw[..., None, :] * scene.normals).sum(-1)  # [H,W,P]
    tiny = torch.full_like(n_dot_d, 1e-6)
    t = (scene.offsets - n_dot_o) / torch.where(torch.abs(n_dot_d) < 1e-6, tiny, n_dot_d)
    t = torch.where(t > 1e-3, t, torch.full_like(t, float("inf")))

    ru, rv = scene.rect_u, scene.rect_v
    rn = torch.linalg.cross(ru, rv)
    rn = rn / torch.linalg.norm(rn, dim=-1, keepdim=True)
    num = _dot(rn, scene.rect_origin - twc[None, :])
    den = (dw[..., None, :] * rn).sum(-1)  # [H,W,B]
    tr_ = num / torch.where(torch.abs(den) < 1e-6, torch.full_like(den, 1e-6), den)
    rel = twc + tr_[..., None] * dw[:, :, None, :] - scene.rect_origin  # [H,W,B,3]
    au = _dot(rel, ru) / torch.clamp(_dot(ru, ru), min=1e-9)
    av = _dot(rel, rv) / torch.clamp(_dot(rv, rv), min=1e-9)
    inside = (torch.abs(au) <= 1.0) & (torch.abs(av) <= 1.0) & (tr_ > 1e-3)
    tr_ = torch.where(inside, tr_, torch.full_like(tr_, float("inf")))

    depth, idx = torch.min(torch.cat([t, tr_], dim=-1), dim=-1)
    Xw = twc + depth[..., None] * dw
    tex = torch.zeros_like(depth)
    for k in range(0, scene.freqs.shape[0], 16):  # 16 waves at a time: [H,W,16,3]
        phase = (Xw[..., None, :] * scene.freqs[k:k + 16]).sum(-1) + scene.phases[k:k + 16]
        tex = tex + (torch.sin(phase) * scene.amps[k:k + 16]).sum(-1)
    img = torch.clamp((scene.biases[idx] + 0.45 * torch.tanh(tex)) * 255.0, 0.0, 255.0)
    depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
    return img, depth


def surface_distance(scene: PlaneScene, X: np.ndarray) -> np.ndarray:
    """Distance (m) of world points X [M,3] to the nearest surface of the
    scene: a wall plane or a rectangle (float64, numpy)."""
    X = np.asarray(X, np.float64)
    n = scene.normals.cpu().numpy().astype(np.float64)
    d = scene.offsets.cpu().numpy().astype(np.float64)
    dist = np.abs(X @ n.T - d).min(1)
    o = scene.rect_origin.cpu().numpy().astype(np.float64)
    u = scene.rect_u.cpu().numpy().astype(np.float64)
    v = scene.rect_v.cpu().numpy().astype(np.float64)
    for b in range(len(o)):
        rel = X - o[b]
        a = np.clip(rel @ u[b] / (u[b] @ u[b]), -1.0, 1.0)
        c = np.clip(rel @ v[b] / (v[b] @ v[b]), -1.0, 1.0)
        closest = o[b] + a[:, None] * u[b] + c[:, None] * v[b]
        dist = np.minimum(dist, np.linalg.norm(X - closest, axis=1))
    return dist


def so3_exp(phi: np.ndarray) -> np.ndarray:
    """Rodrigues' formula, float64."""
    th = float(np.linalg.norm(phi))
    K = np.array([[0.0, -phi[2], phi[1]], [phi[2], 0.0, -phi[0]], [-phi[1], phi[0], 0.0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1.0 - np.cos(th)) / th**2 * (K @ K)


def _pose_from_center(c: np.ndarray, phi: np.ndarray) -> np.ndarray:
    Rcw = so3_exp(phi).T
    T = np.eye(4)
    T[:3, :3] = Rcw
    T[:3, 3] = -Rcw @ c
    return T


def orbit_trajectory(n_frames: int, radius: float, yaw_amp: float) -> np.ndarray:
    """A smooth periodic loop of Tcw poses [n,4,4] (float64): frame n would
    be frame 0 again; frame 0 is the identity."""
    poses = []
    for t in np.linspace(0, 2 * np.pi, n_frames, endpoint=False):
        c = np.array([radius * np.sin(t), 0.25 * radius * np.sin(2 * t),
                      0.3 * radius * (1 - np.cos(t))])
        yaw = yaw_amp * np.sin(t)
        poses.append(_pose_from_center(c, np.array([0.5 * yaw_amp * np.sin(2 * t), yaw, 0.0])))
    return np.stack(poses)
