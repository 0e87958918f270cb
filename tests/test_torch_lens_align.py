"""The direct aligner through a lens, against a plain float64 reference
(`tests/lens_align_ref.py`: the lens in the warp, raw levels, autograd
Gauss-Newton).

On a distorted camera the port reads alignment levels remapped to the
pinhole camera (`features/frame.py`) and takes its patches at undistorted
keypoints: the tracker's seed (`pipeline/tracking.py::_align_seed`, kernel
K1's CPU loop) and the pool alignment of relocalization and loop detection
(`pipeline/relocalization.py::align_pool`, kernel K5's batched CPU loop)
land where the reference does, at EuRoC cam0's barrel lens and at TUM
fr1's. At zero distortion nothing is remapped and the seed is the one the
port had before (bit for bit). Frames: `perf_bench/scene.py`'s room,
rendered through the lens at half EuRoC's and TUM fr1's sizes, from
seeded poses.
"""

import math

import numpy as np
import pytest
import torch

import lens_align_ref as ref
from sdslam_tpu_torch.features import frame as frame_mod
from sdslam_tpu_torch.features.frame import ORBExtractor, alignment_levels, make_frame
from sdslam_tpu_torch.geometry import camera as cam_mod
from sdslam_tpu_torch.geometry.camera import CameraModel
from sdslam_tpu_torch.mapping import map_state as M
from sdslam_tpu_torch.pipeline import tracking
from sdslam_tpu_torch.pipeline.relocalization import align_pool
from sdslam_tpu_torch.solvers import image_align
from sdslam_tpu_torch.utils.config import ORBConfig

torch.set_num_threads(2)

DEPTH_FACTOR = 5000.0
# cam0 of EuRoC MAV (configs/EuRoC.yaml) and TUM fr1 (configs/TUM1.yaml),
# intrinsics halved: the lens acts on normalized coordinates, so the
# coefficients stay
LENSES = {
    "euroc": dict(fx=229.327, fy=228.648, cx=183.6075, cy=124.1875, width=376, height=240,
                  k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05),
    "tum1": dict(fx=258.653204, fy=258.2346075, cx=159.32152, cy=127.6569945, width=320,
                 height=240, k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628,
                 k3=1.163314),
}
# Agreement with the reference (the seeded motions are 1.5-2.5 cm and
# 0.6-1.2 degrees). The port blends each pixel twice (the remap, then the
# aligner's bilinear sample on the pinhole grid) where the reference blends
# once, and runs inverse-compositional float32 Gauss-Newton against the
# reference's forward-additive float64: both minimize the same residual
# and differ by the interpolation. Five seeded cases on both lenses read
# 0.7-2.1 mm and 0.02-0.08 degrees apart, while the reference itself lies
# 1.3-4.1 mm and 0.04-0.19 degrees from the rendered truth (u8 images,
# depth in fifths of a millimetre), so the limits sit at about twice the
# largest gap. The port's convention before the remap (patches at the raw
# keypoints on raw levels) misses by 3.3-15 cm on these cases.
TOL_T_M = 4.0e-3
TOL_R_DEG = 0.2


def _pose(seed):
    """(T_ref, T_cur) [4,4] float64: a reference near the room's centre,
    and the current frame moved 1.5-2.5 cm and turned 0.6-1.2 degrees."""
    from perf_bench import scene as sc

    rng = np.random.default_rng(seed)

    def se3(t, phi):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = sc.so3_exp(phi), t
        return T

    def unit():
        v = rng.normal(size=3)
        return v / np.linalg.norm(v)

    T_ref = se3(0.05 * unit(), 0.03 * unit())
    d = se3(rng.uniform(0.015, 0.025) * unit(), math.radians(rng.uniform(0.6, 1.2)) * unit())
    return T_ref, d @ T_ref


def _case(lens, seed, pinhole=False):
    """The scene seen from both poses through the lens, the reference
    keyframe in a map (its depth from the renderer), the current frame, and
    the raw levels both frames' pyramids start from."""
    from perf_bench import scene as sc

    args = dict(LENSES[lens])
    if pinhole:
        args.update(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    cam = CameraModel(**args)
    scam = sc.Camera(*(args.get(k, 0.0) for k in ("fx", "fy", "cx", "cy")), args["width"],
                     args["height"], *(args.get(k, 0.0) for k in ("k1", "k2", "p1", "p2", "k3")))
    scene = sc.make_room_scene(seed % 5)
    rays = sc.pixel_rays(scam, "cpu")
    T_ref, T_cur = _pose(seed)
    ext = ORBExtractor(cam, ORBConfig(n_features=500, max_keypoints=512))
    frames, raws = [], []
    for T in (T_ref, T_cur):
        img, dep = sc.render(scene, rays, torch.as_tensor(T, dtype=torch.float32))
        img8 = torch.round(img).to(torch.uint8)
        frames.append(make_frame(ext, img8, torch.round(dep * DEPTH_FACTOR).to(torch.int32),
                                 DEPTH_FACTOR))
        raws.append(ext.extract(img8.to(torch.float32))[1][frame_mod.ALIGN_MIN_LEVEL:])
    f = frames[0].features
    ms = M.init_map(2, 1024, f.capacity, tuple(tuple(p.shape) for p in frames[0].pyramid[2:]),
                    device="cpu")
    i32 = torch.int32
    ms = tracking.keyframe_step(
        cam, ms, 0, torch.eye(4), f.uv, f.uv_und, f.octave, f.angle, f.desc, f.valid,
        frames[0].depth, frames[0].uright, torch.full((f.capacity,), -1, dtype=i32),
        tuple(frames[0].pyramid[2:]), torch.tensor(0, dtype=i32), torch.tensor(0.0),
        torch.tensor(-1, dtype=i32))
    ms = tracking.spawn_points(cam, ms, 0, torch.tensor(float("inf")))
    truth = T_cur @ np.linalg.inv(T_ref)
    return cam, ms, frames[1], raws, truth


def _seed(cam, ms, cur):
    """The tracker's seed against keyframe slot 0 from the identity."""
    r = torch.tensor(0)
    assoc = ms.kf_mp[0]
    return tracking._align_seed(cam, ms, r, ms.kf_Tcw[0], assoc,
                                torch.clamp(assoc, 0, ms.P - 1).long(), cur.pyramid,
                                torch.eye(4)).T_cur_ref


def _pool(cam, ms, cur):
    T, _ = align_pool(cam, ms, tuple(cur.pyramid[2:]), max_level=4, min_level=2,
                      scale_factor=2.0, store_min_level=2, iters=30)
    return T[0]


def _reference(cam, ms, raws):
    valid = ms.kf_kp_valid[0] & (ms.kf_depth[0] > 0) & (ms.kf_mp[0] >= 0)
    X = cam_mod.backproject(cam, ms.kf_uv_und[0].double(), ms.kf_depth[0].double().clamp(1e-3))
    return ref.align(raws[0], raws[1], X, valid, torch.eye(4, dtype=torch.float64), cam)


def _gap(A, B):
    """(translation m, rotation degrees) between two poses."""
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    dR = A[:3, :3] @ B[:3, :3].T
    ang = math.degrees(math.acos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)))
    return float(np.linalg.norm(A[:3, 3] - B[:3, 3])), ang


@pytest.fixture(scope="module", params=[("euroc", 11), ("euroc", 23), ("tum1", 11)],
                ids=["euroc-11", "euroc-23", "tum1-11"])
def lens_case(request):
    lens, seed = request.param
    cam, ms, cur, raws, truth = _case(lens, seed)
    return {"cam": cam, "ms": ms, "cur": cur, "truth": truth,
            "ref": _reference(cam, ms, raws).numpy()}


@pytest.mark.parametrize("path", ["align", "align_batched"])
def test_port_lands_where_the_lens_reference_does(lens_case, path):
    c = lens_case
    T = (_seed if path == "align" else _pool)(c["cam"], c["ms"], c["cur"]).numpy()
    dt, dr = _gap(T, c["ref"])
    assert dt < TOL_T_M and dr < TOL_R_DEG, (dt, dr, _gap(T, c["truth"]),
                                             _gap(c["ref"], c["truth"]))


def test_benchmark_copy_of_the_reference_agrees_exactly():
    """`perf_bench/align_ref.py` is a frozen copy of this reference."""
    from perf_bench import align_ref

    cam, ms, _, raws, _ = _case("euroc", 11)
    valid = ms.kf_kp_valid[0] & (ms.kf_depth[0] > 0) & (ms.kf_mp[0] >= 0)
    X = cam_mod.backproject(cam, ms.kf_uv_und[0].double(), ms.kf_depth[0].double().clamp(1e-3))
    T0 = torch.eye(4, dtype=torch.float64)
    assert torch.equal(ref.align(raws[0], raws[1], X, valid, T0, cam),
                       align_ref.align(raws[0], raws[1], X, valid, T0, cam))


# --- zero distortion: the path the port had before the alignment levels ------


def _parent_seed(cam, ms, r, T_ref, ref_assoc, ref_safe, pyr_cur, T_pred, scale_factor=2.0,
                 n_levels=5, align_min_level=2):
    """Step 1 of `_track_core` as the port had it before the alignment
    levels: patches at the raw keypoints (`kf_uv`), no per-level mask."""
    from sdslam_tpu_torch._util import take
    from sdslam_tpu_torch.geometry import lie

    ref_depth = take(ms.kf_depth, r)
    map_z = lie.se3_apply(T_ref, ms.pt_pos[ref_safe])[:, 2]
    has_map = (ref_assoc >= 0) & (map_z > 0.05)
    depth_eff = torch.where(ref_depth > 0, ref_depth,
                            torch.where(has_map, map_z, torch.full_like(map_z, -1.0)))
    align_valid = take(ms.kf_kp_valid, r) & (depth_eff > 0)
    X_ref_cam = cam_mod.backproject(cam, take(ms.kf_uv_und, r), torch.clamp(depth_eff, min=1e-3))
    return image_align.align(
        tuple(take(pl, r) for pl in ms.kf_pyramid), tuple(pyr_cur[2:]),
        take(ms.kf_uv, r), X_ref_cam, align_valid, T_pred @ lie.se3_inv(T_ref),
        cam.fx, cam.fy, cam.cx, cam.cy, scale_factor=scale_factor, max_level=n_levels - 1,
        min_level=align_min_level, start_level=2,
    )


@pytest.fixture(scope="module")
def pinhole_case():
    return _case("euroc", 11, pinhole=True)


def test_zero_distortion_levels_are_the_raw_pyramid(pinhole_case):
    cam, ms, cur, raws, _ = pinhole_case
    assert not cam.has_distortion
    for a, b in zip(cur.pyramid[2:], raws[1]):
        assert torch.equal(a, b)
    assert alignment_levels(cam, cur.pyramid, 2.0) is cur.pyramid
    assert cur.features.uv_und is cur.features.uv  # nothing undistorted
    assert torch.equal(ms.kf_uv, ms.kf_uv_und)
    assert frame_mod.alignment_mask(cam, 2.0, ms.kf_pyramid, None) is None


def test_zero_distortion_seed_and_core_are_the_parent_path(pinhole_case, monkeypatch):
    """`_align_seed`, `_track_core` and `align_pool` give what the port's
    path before the alignment levels gave, bit for bit."""
    cam, ms, cur, _, _ = pinhole_case
    f = cur.features
    assoc = ms.kf_mp[0]
    args = (cam, ms, torch.tensor(0), ms.kf_Tcw[0], assoc, torch.clamp(assoc, 0, ms.P - 1).long(),
            cur.pyramid, torch.eye(4))
    for a, b in zip(tracking._align_seed(*args), _parent_seed(*args)):
        assert torch.equal(a, b)

    def core():
        return tracking._track_core(cam, ms, f.uv_und, f.desc, f.octave, f.valid, cur.uright,
                                    cur.pyramid, 0, torch.eye(4))

    new = core()
    monkeypatch.setattr(tracking, "_align_seed", _parent_seed)
    old = core()
    assert int(new.n_inliers) > 50
    for name, a, b in zip(new._fields, new, old):
        assert torch.equal(a, b), name

    T_new, e_new = align_pool(cam, ms, tuple(cur.pyramid[2:]), 4, 2, 2.0, 2)
    valid = ms.kf_kp_valid & (ms.kf_depth > 0) & (ms.kf_mp >= 0)
    X = cam_mod.backproject(cam, ms.kf_uv_und, torch.clamp(ms.kf_depth, min=1e-3))
    old = image_align.align_batched(ms.kf_pyramid, tuple(cur.pyramid[2:]), ms.kf_uv, X, valid,
                                    torch.eye(4), cam.fx, cam.fy, cam.cx, cam.cy, max_level=4,
                                    min_level=2, iters=15, start_level=2)
    assert torch.equal(T_new, old.T_cur_ref)
    assert torch.equal(e_new, torch.where(old.n_meas >= 50, old.error,
                                          torch.full_like(old.error, float("inf"))))


# --- the remap's validity ------------------------------------------------------


def test_remap_marks_every_pixel_whose_source_leaves_the_raw_level():
    """TUM fr1's lens reaches past the raw image along its edges: every
    remapped pixel whose source's 2x2 leaves the raw level is invalid and
    reads 0, no patch within LENS_SUPPORT of one is usable, and the
    aligner's per-tap mask leaves such a patch out."""
    cam = CameraModel(**LENSES["tum1"])
    shapes = [(60, 80), (30, 40), (15, 20)]
    lens = frame_mod.lens_levels(cam, 2.0, shapes, "cpu")
    gen = torch.Generator().manual_seed(5)
    pyr = [torch.zeros(240, 320), torch.zeros(120, 160)] + [
        1.0 + 254.0 * torch.rand(h, w, generator=gen) for h, w in shapes]
    remapped = alignment_levels(cam, pyr, 2.0)
    R = frame_mod.LENS_SUPPORT
    for i, (h, w) in enumerate(shapes):
        s = 1.0 / 2.0 ** (2 + i)
        y, x = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                              torch.arange(w, dtype=torch.float64), indexing="ij")
        src = torch.floor(ref.distort(cam, torch.stack([x, y], -1), s))
        outside = ~((src[..., 0] >= 0) & (src[..., 0] < w - 1) & (src[..., 1] >= 0)
                    & (src[..., 1] < h - 1))
        assert outside.any() and not outside.all()
        assert torch.equal(lens.valid[i], ~outside)
        assert torch.equal(remapped[2 + i] == 0, outside)
        near = torch.nn.functional.max_pool2d(outside[None, None].double(), 2 * R + 1, stride=1,
                                              padding=R)[0, 0] > 0
        off = int(lens.offset[i])
        assert torch.equal(lens.usable[off: off + h * w].reshape(h, w), ~near)
        # patches centred on the invalid pixels, in pinhole pixels at level 0
        uv = torch.stack([x[outside], y[outside]], -1).float() / s
        mask = frame_mod.lens_usable(lens, uv[None])
        assert not mask[i].any()
        ok = torch.ones(uv.shape[0], dtype=torch.bool)
        X = torch.cat([(uv - torch.tensor([cam.cx, cam.cy])) / torch.tensor([cam.fx, cam.fy]),
                       torch.ones(uv.shape[0], 1)], 1)
        _, _, tap_ok = image_align._precompute_level(
            remapped[2 + i], uv * s, X, image_align._level_valid(ok, mask, i),
            cam.fx * s, cam.fy * s)
        assert not tap_ok.any()
