"""Frame construction: ORB pyramid extraction + per-keypoint channels
(port of sdslam_tpu/features/frame.py).

A Frame holds fixed-shape tensors: keypoints padded to a static capacity
with a validity mask, descriptors as [N, 8] int32 words, and the image
pyramid the direct alignment needs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from sdslam_tpu_torch.geometry import camera as cam_mod
from sdslam_tpu_torch.geometry.camera import CameraModel
from sdslam_tpu_torch.ops import fast as fast_ops
from sdslam_tpu_torch.ops import orb as orb_ops
from sdslam_tpu_torch.ops import pyramid as pyr_ops
from sdslam_tpu_torch.ops import sample as smp
from sdslam_tpu_torch.utils.config import ORBConfig


class FrameFeatures(NamedTuple):
    uv: torch.Tensor  # [N,2] raw pixel coords at level-0 scale
    uv_und: torch.Tensor  # [N,2] undistorted coords
    octave: torch.Tensor  # [N] int32
    angle: torch.Tensor  # [N] radians
    score: torch.Tensor  # [N] FAST score
    desc: torch.Tensor  # [N,8] int32 descriptor words
    valid: torch.Tensor  # [N] bool

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


class Frame(NamedTuple):
    features: FrameFeatures
    pyramid: Tuple[torch.Tensor, ...]
    depth: torch.Tensor  # [N] per-keypoint depth (>0) or -1
    uright: torch.Tensor  # [N] virtual right coord u - bf/d, or -1
    Tcw: torch.Tensor  # [4,4]


def _extract_static(pyramid, quotas, scale_factor, threshold, cell, border):
    uvs, octs, angs, scores, valids, descs = [], [], [], [], [], []
    for lvl, img in enumerate(pyramid):
        q = quotas[lvl]
        if q <= 0:
            continue
        uv_l, sc, val = fast_ops.detect_keypoints(img, q, threshold=threshold,
                                                  cell=cell, border=border)
        ang = orb_ops.orientations(img, uv_l, val)
        d = orb_ops.descriptors(pyr_ops.gaussian_blur(img), uv_l, ang, val)
        uvs.append(uv_l * scale_factor**lvl)
        octs.append(torch.full((q,), lvl, dtype=torch.int32, device=img.device))
        angs.append(ang)
        scores.append(sc)
        valids.append(val)
        descs.append(d)
    return tuple(torch.cat(x) for x in (uvs, octs, angs, scores, valids, descs))


class ORBExtractor:
    """ORB front-end bound to a camera + config (static shapes)."""

    def __init__(self, cam: CameraModel, cfg: ORBConfig):
        self.cam = cam
        self.cfg = cfg
        n_req = min(cfg.n_features, cfg.max_keypoints)
        self.quotas = tuple(pyr_ops.level_quotas(n_req, cfg.n_levels, cfg.scale_factor))
        self._pad = cfg.max_keypoints - sum(self.quotas)

    def extract(self, img):
        """img [H,W] float32 -> (FrameFeatures, pyramid tuple)."""
        cfg = self.cfg
        pyramid = pyr_ops.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
        uv, octv, ang, score, valid, desc = _extract_static(
            pyramid, self.quotas, cfg.scale_factor, float(cfg.fast_threshold), 16, 19
        )
        if self._pad > 0:
            p = self._pad

            def pad(t):
                return torch.cat([t, torch.zeros((p,) + t.shape[1:], dtype=t.dtype,
                                                 device=t.device)])

            uv, octv, ang, score, valid, desc = map(pad, (uv, octv, ang, score, valid, desc))
        uv_und = cam_mod.undistort_pixels(self.cam, uv)
        return FrameFeatures(uv, uv_und, octv, ang, score, desc, valid), tuple(pyramid)

    def __call__(self, img) -> Tuple[FrameFeatures, Tuple[torch.Tensor, ...]]:
        """img [H,W] (any real dtype) -> (FrameFeatures, pyramid tuple)."""
        feats, pyramid, _, _ = self.core(torch.as_tensor(img), None, 1.0)
        return feats, pyramid

    def core(self, img, depth_img, depth_factor: float):
        """Extraction + RGB-D keypoint channels. depth_img=None -> mono
        (-1 depth / u_r). Depth may arrive decimated 2x (the packed-frame
        transport), detected from its shape."""
        img = img.to(torch.float32)
        feats, pyramid = self.extract(img)
        n = feats.uv.shape[0]
        if depth_img is None:
            neg = torch.full((n,), -1.0, device=img.device)
            return feats, pyramid, neg, neg.clone()
        dimg = depth_img.to(torch.float32)
        if depth_factor != 1.0:
            dimg = dimg / depth_factor
        if depth_img.shape[0] <= (img.shape[0] + 1) // 2:
            d = smp.sample_nearest(dimg, feats.uv * 0.5)
        else:
            d = smp.sample_nearest(dimg, feats.uv)
        d = torch.where(feats.valid & (d > 0), d, torch.full_like(d, -1.0))
        uright = cam_mod.virtual_right(self.cam, feats.uv_und[:, 0], d)
        return feats, pyramid, d, uright


def make_frame(extractor: ORBExtractor, img, depth_img: Optional[torch.Tensor] = None,
               depth_factor: float = 1.0) -> Frame:
    """Build a Frame; with depth_img (RGB-D) fills per-keypoint depth and the
    virtual right coordinate."""
    feats, pyramid, d, uright = extractor.core(img, depth_img, float(depth_factor))
    return Frame(feats, pyramid, d, uright, torch.eye(4, device=img.device))
