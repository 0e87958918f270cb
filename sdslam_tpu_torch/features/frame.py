"""Frame construction: ORB pyramid extraction + per-keypoint channels
(port of sdslam_tpu/features/frame.py).

A Frame holds fixed-shape tensors: keypoints padded to a static capacity
with a validity mask, descriptors as [N, 8] int32 words, and the image
pyramid the direct alignment needs.

The direct aligner reads pyramid levels >= ALIGN_MIN_LEVEL and warps
through a pinhole. On a camera with lens distortion those levels are
remapped to the pinhole camera (the same fx, fy, cx, cy, scaled per
level): each pixel blends the raw level's 2x2 pixels around the distorted
position of its ray (`LensLevels`, fixed per camera), so a patch is
sampled at a keypoint's undistorted position. Levels below stay raw (ORB
and the chessboard read them). A remapped pixel whose source leaves the
raw level reads 0 and is marked invalid; `lens_usable` keeps it out of
the aligner's residuals. Without distortion nothing is remapped.

Extraction is a pure function of the image and depth whose shapes the
camera fixes, a few thousand small kernels a frame. On the card it is
captured once per input key as a CUDA graph and replayed, so the host
enqueues one graph launch in place of those kernels; on the CPU it runs
eagerly.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sdslam_tpu_torch.geometry import camera as cam_mod
from sdslam_tpu_torch.geometry.camera import CameraModel
from sdslam_tpu_torch.ops import fast as fast_ops
from sdslam_tpu_torch.ops import orb as orb_ops
from sdslam_tpu_torch.ops import pyramid as pyr_ops
from sdslam_tpu_torch.ops import sample as smp
from sdslam_tpu_torch.utils.config import ORBConfig
from sdslam_tpu_torch.utils.profiling import span


ALIGN_MIN_LEVEL = 2  # the direct aligner reads pyramid levels >= 2
# pixels, either way of a patch centre's floor at one level, that the
# aligner reads: a 4x4 patch's bilinear values and central differences in
# the reference (3); in the current frame the level kernel reads 2, which
# leaves 1 for the motion of a level's Gauss-Newton loop away from its seed
LENS_SUPPORT = 3


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
    pyramid: Tuple[torch.Tensor, ...]  # levels >= ALIGN_MIN_LEVEL: the alignment levels
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
        self._graphs = {}  # graph_key -> _Graph

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
        """Extraction + RGB-D keypoint channels (`extract_channels`).
        depth_img=None -> mono (-1 depth / u_r). Depth may arrive decimated
        2x (the packed-frame transport), detected from its shape.

        A CUDA input replays the CUDA graph of its `graph_key`, captured on
        the first call with that key, inside a `sdslam.orb.replay` span; the
        outputs are fresh copies of the graph's, which the next replay
        overwrites. A capture that fails raises. A CPU input runs eagerly."""
        if img.device.type != "cuda":
            return extract_channels(self, img, depth_img, depth_factor)
        key = graph_key(img, depth_img, depth_factor)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = _capture(self, img, depth_img, depth_factor)
        with span("sdslam.orb.replay", n=1):
            g.img.copy_(img)
            if depth_img is not None:
                g.depth.copy_(depth_img)
            g.graph.replay()
            feats, pyramid, d, uright = g.out
            return (FrameFeatures(*(t.clone() for t in feats)), tuple(p.clone() for p in pyramid),
                    d.clone(), uright.clone())


def extract_channels(extractor: ORBExtractor, img, depth_img, depth_factor: float):
    """`ORBExtractor.core`'s computation, eagerly: extraction, undistortion,
    the alignment levels, per-keypoint depth and the virtual right
    coordinate."""
    img = img.to(torch.float32)
    feats, pyramid = extractor.extract(img)
    pyramid = alignment_levels(extractor.cam, pyramid, extractor.cfg.scale_factor)
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
    uright = cam_mod.virtual_right(extractor.cam, feats.uv_und[:, 0], d)
    return feats, pyramid, d, uright


class LensLevels(NamedTuple):
    """A distorted camera's alignment levels (ALIGN_MIN_LEVEL on) as
    pinhole images, per level [H, W]: each pinhole pixel's ray, distorted
    through k1, k2, p1, p2, k3, lands at a position in the raw level, and
    the pixel is the bilinear blend of the raw 2x2 pixels there. Built once
    per camera, level shapes and device (`lens_levels`)."""

    index: Tuple[torch.Tensor, ...]  # [4, H*W] int64: the raw pixels each pixel blends
    weight: Tuple[torch.Tensor, ...]  # [4, H*W] float32: their weights (0 where invalid)
    valid: Tuple[torch.Tensor, ...]  # [H, W] bool: the source's 2x2 lies inside the raw level
    usable: torch.Tensor  # [sum H*W] bool: every valid pixel within LENS_SUPPORT valid
    scale: torch.Tensor  # [L] level-0 -> level pixel scale
    size: torch.Tensor  # [L, 2] int64 (W, H)
    offset: torch.Tensor  # [L] int64: a level's first entry in `usable`
    all_usable: bool  # no pixel of any level is unusable (a barrel lens)


_LENS: Dict[tuple, LensLevels] = {}


def lens_levels(cam: CameraModel, scale_factor: float, shapes, device) -> LensLevels:
    """The `LensLevels` of a distorted camera whose alignment levels have
    `shapes` ((H, W) per level, from ALIGN_MIN_LEVEL), on `device`; the
    maps are computed in float64 on the host on first use and kept."""
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    device = torch.device(device)
    key = (cam, float(scale_factor), shapes, device)
    lens = _LENS.get(key)
    if lens is None:
        lens = _LENS[key] = _build_lens_levels(cam, float(scale_factor), shapes, device)
    return lens


def _build_lens_levels(cam: CameraModel, sf: float, shapes, device) -> LensLevels:
    index, weight, valid, usable, scale = [], [], [], [], []
    r = LENS_SUPPORT
    for i, (h, w) in enumerate(shapes):
        s = 1.0 / sf ** (ALIGN_MIN_LEVEL + i)
        y, x = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                           indexing="ij")
        xn, yn = (x / s - cam.cx) / cam.fx, (y / s - cam.cy) / cam.fy
        radial, dx, dy = cam_mod._distortion(cam, xn, yn)
        u = (cam.fx * (xn * radial + dx) + cam.cx) * s
        v = (cam.fy * (yn * radial + dy) + cam.cy) * s
        x0, y0 = np.floor(np.clip(u, -1e9, 1e9)), np.floor(np.clip(v, -1e9, 1e9))
        ok = (x0 >= 0) & (x0 < w - 1) & (y0 >= 0) & (y0 < h - 1)
        wx, wy = u - x0, v - y0
        # an invalid pixel blends pixel 0's neighbours with weight 0
        x0 = np.where(ok, x0, 0).astype(np.int64)
        y0 = np.where(ok, y0, 0).astype(np.int64)
        base = y0 * w + x0
        idx = np.stack([base, base + w, base + 1, base + w + 1]).reshape(4, -1)
        wts = np.stack([(1 - wx) * (1 - wy), (1 - wx) * wy, wx * (1 - wy), wx * wy])
        wts = np.where(ok[None], wts, 0.0).reshape(4, -1)
        # usable: no invalid pixel within r either way (outside the level
        # counts as valid: the aligner's own bounds test covers it)
        pad = np.pad(ok, r, constant_values=True)
        use = np.ones_like(ok)
        for dy in range(2 * r + 1):
            for dx in range(2 * r + 1):
                use &= pad[dy: dy + h, dx: dx + w]
        index.append(torch.from_numpy(idx).to(device))
        weight.append(torch.from_numpy(wts.astype(np.float32)).to(device))
        valid.append(torch.from_numpy(ok).to(device))
        usable.append(use.reshape(-1))
        scale.append(s)
    sizes = np.array([(w, h) for h, w in shapes], np.int64).reshape(-1, 2)
    offset = np.concatenate([[0], np.cumsum(sizes[:, 0] * sizes[:, 1])[:-1]]).astype(np.int64)
    flat = np.concatenate(usable) if usable else np.ones(0, bool)
    return LensLevels(tuple(index), tuple(weight), tuple(valid),
                      torch.from_numpy(flat).to(device),
                      torch.tensor(scale, dtype=torch.float32).to(device),
                      torch.from_numpy(sizes).to(device), torch.from_numpy(offset).to(device),
                      bool(flat.all()))


def alignment_levels(cam: CameraModel, pyramid, scale_factor: float):
    """The pyramid with its alignment levels (ALIGN_MIN_LEVEL on) remapped
    to the pinhole camera where `cam` has distortion; else `pyramid`."""
    pyramid = tuple(pyramid)
    if not cam.has_distortion or len(pyramid) <= ALIGN_MIN_LEVEL:
        return pyramid
    raw = pyramid[ALIGN_MIN_LEVEL:]
    lens = lens_levels(cam, scale_factor, [p.shape for p in raw], raw[0].device)
    return pyramid[:ALIGN_MIN_LEVEL] + tuple(
        (p.reshape(-1)[i] * w).sum(0).reshape(p.shape)
        for p, i, w in zip(raw, lens.index, lens.weight))


def lens_usable(lens: LensLevels, uv) -> torch.Tensor:
    """Per alignment level, whether an aligner patch centred at each
    pinhole position reads only valid remapped pixels: uv [S, ..., 2] at
    level-0 scale (S positions per patch, e.g. where it sits in the
    reference and where the current frame's seed pose puts it) -> [L, ...]
    bool, true where every one of the S is usable. A position outside the
    level takes its nearest border pixel's answer."""
    L = lens.scale.shape[0]
    shp = (L,) + (1,) * (uv.dim() - 1)
    uvl = uv[None] * lens.scale.reshape(shp + (1,))
    xy = torch.floor(torch.clamp(uvl, -1e9, 1e9)).to(torch.int64)
    xy = torch.minimum(torch.clamp(xy, min=0), (lens.size - 1).reshape(shp + (2,)))
    idx = lens.offset.reshape(shp) + xy[..., 1] * lens.size[:, 0].reshape(shp) + xy[..., 0]
    return lens.usable[idx].all(dim=1)


def alignment_mask(cam: CameraModel, scale_factor: float, levels, positions):
    """The aligner's per-level patch mask (`lens_usable`) on a distorted
    camera's alignment levels (`levels`: tensors [..., H, W] from
    ALIGN_MIN_LEVEL on, such as a map's stored keyframe levels) at
    `positions()` ([S, ..., 2] pinhole pixels); None, and `positions` not
    called, where every remapped pixel is usable (no distortion, or a lens
    whose every ray lands inside the raw image)."""
    if not cam.has_distortion:
        return None
    lens = lens_levels(cam, scale_factor, [p.shape[-2:] for p in levels], levels[0].device)
    return None if lens.all_usable else lens_usable(lens, positions())


def graph_key(img, depth_img, depth_factor: float) -> tuple:
    """What picks `ORBExtractor.core`'s graph: the device, the image's dtype
    and shape, the depth's dtype and shape (None for monocular input) and
    the depth factor, which the graph holds as a constant."""
    depth = None if depth_img is None else (depth_img.dtype, tuple(depth_img.shape))
    return (img.device, img.dtype, tuple(img.shape), depth, float(depth_factor))


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    img: torch.Tensor  # static inputs, copied into before each replay
    depth: Optional[torch.Tensor]
    out: tuple  # static outputs (features, pyramid, depth, u_r), overwritten by each replay


def _capture(extractor: ORBExtractor, img, depth_img, depth_factor: float) -> _Graph:
    """Capture `extract_channels` on static copies of the inputs, after one
    eager pass on a side stream (one-time uploads and the allocator's first
    allocations stay out of the graph). Work of other threads, such as a
    mapping pass on its own stream, may run during the capture."""
    dev = img.device
    with torch.cuda.device(dev):
        s_img = torch.empty(img.shape, dtype=img.dtype, device=dev).copy_(img)
        s_depth = (None if depth_img is None else
                   torch.empty(depth_img.shape, dtype=depth_img.dtype, device=dev).copy_(depth_img))
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            extract_channels(extractor, s_img, s_depth, depth_factor)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = extract_channels(extractor, s_img, s_depth, depth_factor)
    return _Graph(graph, s_img, s_depth, out)


def make_frame(extractor: ORBExtractor, img, depth_img: Optional[torch.Tensor] = None,
               depth_factor: float = 1.0) -> Frame:
    """Build a Frame; with depth_img (RGB-D) fills per-keypoint depth and the
    virtual right coordinate."""
    feats, pyramid, d, uright = extractor.core(img, depth_img, float(depth_factor))
    return Frame(feats, pyramid, d, uright, torch.eye(4, device=img.device))
