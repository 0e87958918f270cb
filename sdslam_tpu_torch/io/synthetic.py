"""Synthetic photometric RGB-D scene renderer (torch port of
sdslam_tpu/io/synthetic.py).

The scene is built by the same numpy RNG recipe (bit-identical scene
parameters for a seed); rendering runs in torch on whatever device the
caller names, so the card renders its own frames. `PosterSequence` adds a
planar poster with a chessboard inset for the chessboard initialization,
rendered on the host by its homography.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdslam_tpu_torch import _device
from sdslam_tpu_torch.geometry import lie
from sdslam_tpu_torch.geometry.camera import CameraModel


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


def make_room_scene(
    seed: int = 0, n_waves: int = 48, size: float = 2.5, closed: bool = False
) -> PlaneScene:
    """Room around the origin (x right, y down, z forward); the numpy draws
    follow make_room_scene of sdslam_tpu/io/synthetic.py exactly."""
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
        eu = rng.uniform(0.15, 0.45)
        ev = rng.uniform(0.15, 0.45)
        origins.append(c)
        us.append((a * eu).astype(np.float32))
        vs.append((b * ev).astype(np.float32))
    biases = rng.uniform(0.35, 0.65, size=len(normals) + 8).astype(np.float32)
    if closed:
        normals = np.concatenate([normals, [[0.0, 0.0, 1.0]]]).astype(np.float32)
        offsets = np.concatenate([offsets, [-size]]).astype(np.float32)
        biases = np.concatenate(
            [biases[: len(normals) - 1], rng.uniform(0.35, 0.65, size=1).astype(np.float32),
             biases[len(normals) - 1:]]
        )
    t = torch.as_tensor
    return PlaneScene(
        t(normals), t(offsets), t(np.stack(origins)), t(np.stack(us)), t(np.stack(vs)),
        t(freqs), t(phases), t(amps), t(biases),
    )


def scene_intensity(scene: PlaneScene, X, plane_idx):
    phase = torch.einsum("...i,ki->...k", X, scene.freqs) + scene.phases
    tex = torch.einsum("...k,k->...", torch.sin(phase), scene.amps)
    return scene.biases[plane_idx] + 0.45 * torch.tanh(1.0 * tex)


def render(scene: PlaneScene, cam: CameraModel, Tcw: torch.Tensor):
    """Render grayscale [H,W] float32 in [0,255] and depth [H,W] (m) on
    Tcw's device."""
    dev = Tcw.device
    H, W = cam.height, cam.width
    Twc = lie.se3_inv(Tcw)
    Rwc, twc = lie.se3_R(Twc), lie.se3_t(Twc)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    dc = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, torch.ones_like(u)], -1)
    dw = torch.einsum("ij,hwj->hwi", Rwc, dc)
    n_dot_o = torch.einsum("pi,i->p", scene.normals, twc)
    n_dot_d = torch.einsum("pi,hwi->hwp", scene.normals, dw)
    tiny = torch.full_like(n_dot_d, 1e-6)
    t = (scene.offsets - n_dot_o) / torch.where(torch.abs(n_dot_d) < 1e-6, tiny, n_dot_d)
    t = torch.where(t > 1e-3, t, torch.full_like(t, float("inf")))

    ru, rv = scene.rect_u, scene.rect_v
    rn = torch.linalg.cross(ru, rv)
    rn = rn / torch.linalg.norm(rn, dim=-1, keepdim=True)
    num = torch.einsum("bi,bi->b", rn, scene.rect_origin - twc[None, :])
    den = torch.einsum("bi,hwi->hwb", rn, dw)
    tr_ = num / torch.where(torch.abs(den) < 1e-6, torch.full_like(den, 1e-6), den)
    hit = twc + tr_[..., None] * dw[:, :, None, :]  # [H,W,B,3]
    rel = hit - scene.rect_origin
    au = torch.einsum("hwbi,bi->hwb", rel, ru) / torch.clamp(torch.sum(ru * ru, -1), min=1e-9)
    av = torch.einsum("hwbi,bi->hwb", rel, rv) / torch.clamp(torch.sum(rv * rv, -1), min=1e-9)
    inside = (torch.abs(au) <= 1.0) & (torch.abs(av) <= 1.0) & (tr_ > 1e-3)
    tr_ = torch.where(inside, tr_, torch.full_like(tr_, float("inf")))

    t_all = torch.cat([t, tr_], dim=-1)
    depth, plane_idx = torch.min(t_all, dim=-1)
    Xw = twc + depth[..., None] * dw
    img = torch.clamp(scene_intensity(scene, Xw, plane_idx) * 255.0, 0.0, 255.0)
    depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
    return img, depth


def _pose_from_center(c: np.ndarray, phi: np.ndarray) -> np.ndarray:
    Rwc = lie.so3_exp(torch.as_tensor(phi, dtype=torch.float32)).numpy()
    Rcw = Rwc.T
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rcw
    T[:3, 3] = -Rcw @ c
    return T


def orbit_trajectory(n_frames: int, radius: float = 0.4, yaw_amp: float = 0.12, seed: int = 1):
    """Smooth looping trajectory of Tcw poses [N,4,4]; starts at identity."""
    poses = []
    for t in np.linspace(0, 2 * np.pi, n_frames, endpoint=False):
        c = np.array(
            [radius * np.sin(t), 0.25 * radius * np.sin(2 * t), 0.3 * radius * (1 - np.cos(t))],
            np.float32,
        )
        yaw = yaw_amp * np.sin(t)
        phi = np.array([0.5 * yaw_amp * np.sin(2 * t), yaw, 0.0], np.float32)
        poses.append(_pose_from_center(c, phi))
    return torch.as_tensor(np.stack(poses))


def circuit_trajectory(n_frames: int, radius: float = 0.8):
    """Closed circuit: the camera walks a full circle heading along the
    tangent, so yaw sweeps 360 deg and each segment sees another part of
    the room (use with make_room_scene(closed=True)). Starts at the origin
    looking +z; circle center at (radius, 0, 0)."""
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * i / n_frames
        c = np.array([radius * (1 - np.cos(th)), 0.0, radius * np.sin(th)], np.float32)
        poses.append(_pose_from_center(c, np.array([0.0, th, 0.0], np.float32)))
    return torch.as_tensor(np.stack(poses))


def forward_trajectory(n_frames: int, step: float = 0.02, yaw_rate: float = 0.0):
    """Straight-ish dolly forward, constant velocity."""
    poses = [
        _pose_from_center(
            np.array([0.0, 0.0, step * i], np.float32),
            np.array([0.0, yaw_rate * i, 0.0], np.float32),
        )
        for i in range(n_frames)
    ]
    return torch.as_tensor(np.stack(poses))


def poster_trajectory(n_frames: int, hold: int = 8):
    """A hand-held sweep in front of a poster: the camera holds still for
    `hold` frames, then its centre moves by (5, 1, -3) cm and its rotation
    vector reaches (0.02, -0.04, 0.01) rad on a smooth ease; starts at
    identity."""
    poses = []
    for s in np.concatenate([np.zeros(hold), np.linspace(0.0, 1.0, n_frames - hold)]):
        a = 0.5 - 0.5 * np.cos(np.pi * s)
        c = np.array([0.05 * a, 0.01 * np.sin(np.pi * s), -0.03 * a], np.float32)
        phi = np.array([0.02 * np.sin(np.pi * s), -0.04 * a, 0.01 * a], np.float32)
        poses.append(_pose_from_center(c, phi))
    return torch.as_tensor(np.stack(poses))


class PosterSequence:
    """A 1.0 x 0.75 m poster at depth `z` (m), turned by the rotation vector
    `tilt` about its centre on the optical axis: the room scene's back wall
    as the camera sees it from 2.5 m, scaled onto the poster, with a
    chessboard of 6x4 inner corners and `cell` m squares at its centre,
    inside a half-cell white margin. The board is printed on grained
    paper: its squares keep 0.35 of the texture's contrast. The tilt puts
    each board corner in its own perspective, so no two corners score
    alike. Frames are u8 images rendered on the host by the poster's
    homography (cv2.warpPerspective, mid-grey outside the poster); the
    texture is evaluated once on `device`."""

    SIZE = (1.0, 0.75)
    GRAIN = 0.35

    def __init__(self, cam: CameraModel, poses, z: float = 0.5, tilt=(0.12, -0.08, 0.03),
                 cell: float = 0.0283, device="cuda"):
        self.cam = cam
        self.poses = torch.as_tensor(poses, dtype=torch.float32)
        self.timestamps = np.arange(len(self.poses)) / 30.0
        self.ppm = 1.25 * cam.fx / z  # texture pixels per metre
        # poster frame in the world: x, y along the poster, origin at its centre
        self.T_poster = np.eye(4)
        self.T_poster[:3, :3] = lie.so3_exp(torch.tensor(tilt, dtype=torch.float64)).numpy()
        self.T_poster[:3, 3] = (0.0, 0.0, z)
        cols, rows = 6, 4
        w, h = int(round(self.SIZE[0] * self.ppm)), int(round(self.SIZE[1] * self.ppm))
        self.corner = (-0.5 * self.SIZE[0], -0.5 * self.SIZE[1])  # poster coords of texel (0, 0)
        dev = _device.resolve(device)
        x = self.corner[0] + (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / self.ppm
        y = self.corner[1] + (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / self.ppm
        wall = 2.5 / z  # poster -> back-wall coordinates
        X = torch.stack([wall * x[None, :].expand(h, w), wall * y[:, None].expand(h, w),
                         torch.full((h, w), 2.5, device=dev)], -1)
        scene = make_room_scene().to(dev)
        tex = torch.clamp(scene_intensity(scene, X, torch.zeros((h, w), dtype=torch.int64,
                                                                device=dev)) * 255.0, 0, 255)
        # board coordinates in cells, origin at the first inner corner:
        # squares (i, j) for i in [-1, cols), j in [-1, rows), black where
        # i + j is even
        BX = (x[None, :].expand(h, w) + 0.5 * (cols - 1) * cell) / cell
        BY = (y[:, None].expand(h, w) + 0.5 * (rows - 1) * cell) / cell
        in_board = (BX >= -1) & (BX < cols) & (BY >= -1) & (BY < rows)
        in_margin = (BX >= -1.5) & (BX < cols + 0.5) & (BY >= -1.5) & (BY < rows + 0.5)
        black = (torch.floor(BX) + torch.floor(BY)).remainder(2) == 0
        g = self.GRAIN
        board = torch.where(in_board & black, g * tex, 255.0 - g * (255.0 - tex))
        self.texture = torch.where(in_margin, board, tex).round().to(torch.uint8).cpu().numpy()

    def __len__(self):
        return len(self.timestamps)

    def frame(self, i: int):
        """(timestamp, u8 image [H,W])."""
        import cv2

        cam = self.cam
        T = self.poses[i].numpy().astype(np.float64) @ self.T_poster  # poster -> camera
        K = np.array([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]])
        # texel (u, v) -> poster point (corner + (u + 0.5) / ppm, ..., 0) -> pixel
        origin = np.array([self.corner[0] + 0.5 / self.ppm, self.corner[1] + 0.5 / self.ppm, 0.0])
        Hm = K @ np.stack([T[:3, 0] / self.ppm, T[:3, 1] / self.ppm,
                           T[:3, :3] @ origin + T[:3, 3]], 1)
        img = cv2.warpPerspective(self.texture, Hm, (cam.width, cam.height),
                                  flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
                                  borderValue=128)
        return self.timestamps[i], img


def make_dist_ba_problem(rng, K, P, Mo, cam, noise_px: float = 0.01):
    """Production-shaped synthetic BA problem as flat numpy arrays, for the
    distributed-BA checks: K keyframes, P points, E = P*Mo stereo
    observations with per-camera keypoint tables. The draws from `rng`
    follow make_dist_ba_problem of sdslam_tpu/io/synthetic.py exactly.

    Returns (T0 [K,4,4] perturbed initial poses, X0 [P,3] perturbed points,
    obs_kf [P,Mo] (-1 = dropped), obs_kp [P,Mo], kf_uv [K,N,2],
    kf_ur [K,N], kf_oct [K,N], T_gt, X_gt)."""
    pts = rng.uniform([-3, -2, 1], [3, 2, 8], (P, 3)).astype(np.float32)
    kf_T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    kf_T[:, :3, 3] = rng.uniform(-0.8, 0.8, (K, 3)).astype(np.float32)
    obs_cam = rng.integers(0, K, (P, Mo)).astype(np.int32)
    Tpm = kf_T[obs_cam]
    Xc = np.einsum("pmij,pj->pmi", Tpm[..., :3, :3], pts) + Tpm[..., :3, 3]
    u = cam.fx * Xc[..., 0] / Xc[..., 2] + cam.cx
    v = cam.fy * Xc[..., 1] / Xc[..., 2] + cam.cy
    ur = u - cam.bf / Xc[..., 2]

    # per-camera keypoint slots: the rank of each observation among its
    # camera's observations (a vectorized cumcount by camera)
    N = Mo * (P // K + 2)
    flat_c = obs_cam.ravel()
    order = np.argsort(flat_c, kind="stable")
    sc = flat_c[order]
    first = np.r_[True, sc[1:] != sc[:-1]]
    grp = np.cumsum(first) - 1
    starts = np.flatnonzero(first)
    rank = np.arange(sc.size) - starts[grp]
    kp = np.empty(sc.size, np.int64)
    kp[order] = rank
    keep = kp < N
    obs_kp = np.where(keep, kp, 0).reshape(P, Mo).astype(np.int32)
    obs_kf = np.where(keep.reshape(P, Mo), obs_cam, -1).astype(np.int32)

    kf_uv = np.zeros((K, N, 2), np.float32)
    kf_ur = np.full((K, N), -1.0, np.float32)
    kf_oct = np.zeros((K, N), np.int32)
    uv_flat = np.stack([u.ravel(), v.ravel()], -1).astype(np.float32)
    uv_flat += rng.normal(0, noise_px, uv_flat.shape).astype(np.float32)
    sel = np.flatnonzero(keep)
    kf_uv[flat_c[sel], kp[sel]] = uv_flat[sel]
    kf_ur[flat_c[sel], kp[sel]] = ur.ravel()[sel]

    T0 = kf_T.copy()
    T0[1:, :3, 3] += rng.normal(0, 0.01, (K - 1, 3)).astype(np.float32)
    X0 = pts + rng.normal(0, 0.02, (P, 3)).astype(np.float32)
    return T0, X0, obs_kf, obs_kp, kf_uv, kf_ur, kf_oct, kf_T, pts


class SyntheticSequence:
    """Dataset-like iterable of (timestamp, image, depth) with GT poses;
    frames are rendered on `device`."""

    def __init__(
        self,
        cam: CameraModel,
        n_frames: int = 60,
        trajectory: str = "orbit",
        seed: int = 0,
        fps: float = 30.0,
        scene_kwargs: dict = None,
        device="cuda",
        **traj_kwargs,
    ):
        self.cam = cam
        self.device = _device.resolve(device)
        self.scene = make_room_scene(seed=seed, **(scene_kwargs or {})).to(self.device)
        if trajectory == "orbit":
            self.poses = orbit_trajectory(n_frames, **traj_kwargs)
        elif trajectory == "forward":
            self.poses = forward_trajectory(n_frames, **traj_kwargs)
        elif trajectory == "custom":
            self.poses = torch.as_tensor(traj_kwargs["poses"], dtype=torch.float32)
            n_frames = self.poses.shape[0]
        else:
            raise ValueError(trajectory)
        self.timestamps = np.arange(n_frames) / fps

    def __len__(self):
        return len(self.timestamps)

    def frame(self, i: int):
        img, depth = render(self.scene, self.cam, self.poses[i].to(self.device))
        return self.timestamps[i], img, depth

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)
