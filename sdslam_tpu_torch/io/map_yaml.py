"""The reference's trajectory / map YAML, saved and loaded
(sdslam_tpu/io/map_yaml.py; System::SaveTrajectory, System.cc:277-384,
and System::LoadTrajectory, System.cc:387-533):

  %YAML:1.0
  camera:   {fx, fy, cx, cy, k1, k2, p1, p2, k3}
  keyframes: [{id, filename (PNG), pose [qw qx qy qz tx ty tz]}]
  points:   [{id, pose [x y z], observations: [{kf, pixel [x y]}]}]

Poses are world-from-camera (the reference saves GetPoseInverse).

As in the JAX package, keyframes keep pyramid levels >= 2 only, so each
keyframe's PNG is its finest stored level upsampled to the camera's size
(on a distorted camera, whose stored levels are its pinhole camera's,
resampled back through the lens: the port's own deviation),
and RGB-D depth images are not kept (no depth PNG). A loaded map serves
relocalization and localization-only tracking, what the reference's load
path is for; `SDSlamSystem.save_map` keeps the exact arrays.

PIL (the PNGs) and PyYAML (the reader) are imported where they are used.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch


def _fmt(x: float) -> str:
    # std::to_string(double): fixed, 6 decimals
    return f"{float(x):.6f}"


def _through_lens(cam, level, scale_factor: float) -> np.ndarray:
    """A distorted camera's finest stored level, which is its pinhole
    camera's (features/frame.py), drawn back through the lens at the
    camera's size: each raw pixel samples the level at its undistorted
    position, so the PNG is what the camera saw."""
    from sdslam_tpu_torch.features.frame import ALIGN_MIN_LEVEL
    from sdslam_tpu_torch.geometry import camera as cam_mod
    from sdslam_tpu_torch.ops import sample

    v, u = torch.meshgrid(torch.arange(cam.height, dtype=torch.float32, device=level.device),
                          torch.arange(cam.width, dtype=torch.float32, device=level.device),
                          indexing="ij")
    uv = cam_mod.undistort_pixels(cam, torch.stack([u, v], -1))
    return sample.sample_bilinear(level, uv / scale_factor**ALIGN_MIN_LEVEL)[0].cpu().numpy()


def save_trajectory_yaml(system, path: str, folder: str) -> None:
    """Write the reference-schema YAML and one PNG per keyframe."""
    from PIL import Image

    from sdslam_tpu_torch.geometry import lie

    system.tracker.flush()
    ms = system.tracker.ms
    cam = system.config.camera
    os.makedirs(folder, exist_ok=True)

    out = ["%YAML:1.0", "camera:"]
    for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3"):
        out.append(f"  {k}: {_fmt(getattr(cam, k))}")

    kf_valid = ms.kf_valid.cpu().numpy()
    kf_Tcw = ms.kf_Tcw.cpu().numpy()
    kf_ids = ms.kf_frame_id.cpu().numpy()
    slots = sorted((int(s) for s in np.flatnonzero(kf_valid)), key=lambda s: int(kf_ids[s]))

    out.append("keyframes:")
    finest = ms.kf_pyramid[0]
    for s in slots:
        kid = int(kf_ids[s])
        if cam.has_distortion:
            img = _through_lens(cam, finest[s], system.config.orb.scale_factor)
            pil = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
        else:
            pil = Image.fromarray(np.clip(finest[s].cpu().numpy(), 0, 255).astype(np.uint8))
            pil = pil.resize((cam.width, cam.height), Image.BILINEAR)
        imgname = os.path.join(folder, f"{kid}.png")
        pil.save(imgname)
        Twc = np.linalg.inv(kf_Tcw[s])
        q = lie.mat_to_quat(torch.as_tensor(Twc[:3, :3], dtype=torch.float32)).numpy()
        t = Twc[:3, 3]
        out.append(f"  - id: {kid}")
        out.append(f'    filename: "{imgname}"')
        out.append("    pose:")
        for v in (q[0], q[1], q[2], q[3], t[0], t[1], t[2]):
            out.append(f"      - {_fmt(v)}")

    out.append("points:")
    pt_valid = ms.pt_valid.cpu().numpy()
    pt_pos = ms.pt_pos.cpu().numpy()
    kf_mp = ms.kf_mp.cpu().numpy()
    kf_uv = ms.kf_uv.cpu().numpy()
    # each point's observations, from the association table
    obs_by_pt: dict = {}
    for s in slots:
        row = kf_mp[s]
        for n in np.flatnonzero(row >= 0):
            obs_by_pt.setdefault(int(row[n]), []).append((int(kf_ids[s]), kf_uv[s, n]))
    for counter, p in enumerate(np.flatnonzero(pt_valid)):
        out.append(f"  - id: {counter}")
        out.append("    pose:")
        for v in pt_pos[p]:
            out.append(f"      - {_fmt(v)}")
        out.append("    observations:")
        for kid, uv in obs_by_pt.get(int(p), []):
            out.append(f"      - kf: {kid}")
            out.append("        pixel:")
            out.append(f"          - {_fmt(uv[0])}")
            out.append(f"          - {_fmt(uv[1])}")

    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def load_trajectory_yaml(system, path: str, pixel_tol: float = 2.0) -> int:
    """Rebuild the map from a reference-schema YAML: ORB re-extracted on
    each saved image, keyframes re-inserted with their saved poses and ids,
    points relinked to the nearest re-extracted keypoint within pixel_tol
    (KeyFrame::AddMapPoint(pos)), statistics recomputed, and the tracker
    left LOST to relocalize (System.cc:529).

    Returns the number of keyframes restored."""
    import yaml

    from sdslam_tpu_torch.features.frame import make_frame
    from sdslam_tpu_torch.geometry import lie
    from sdslam_tpu_torch.io.datasets import _load_image
    from sdslam_tpu_torch.mapping import map_state as M
    from sdslam_tpu_torch.pipeline.tracking import keyframe_step

    with open(path) as f:
        text = re.sub(r"^%YAML.*$|^---.*$", "", f.read(), flags=re.MULTILINE)
    data = yaml.safe_load(text)

    tracker = system.tracker
    tracker.flush()
    cfg = system.config
    dev = tracker.device
    ms = M.init_map(cfg.map.max_keyframes, cfg.map.max_points, cfg.orb.max_keypoints,
                    tuple(tuple(lvl.shape[1:]) for lvl in tracker.ms.kf_pyramid), device=dev)

    slot_by_id, kp_uv_by_id = {}, {}
    for slot, kf in enumerate((data.get("keyframes") or [])[: ms.K]):
        kid = int(kf["id"])
        img = torch.from_numpy(_load_image(kf["filename"])).to(dev)
        frame = make_frame(tracker.extractor, img)
        q = torch.tensor(kf["pose"][:4], dtype=torch.float32)  # [w,x,y,z]
        Twc = np.eye(4, dtype=np.float32)
        Twc[:3, :3] = lie.quat_to_mat(q).numpy()
        Twc[:3, 3] = np.array(kf["pose"][4:7], np.float64)
        Tcw = torch.from_numpy(np.linalg.inv(Twc).astype(np.float32)).to(dev)
        f = frame.features
        ms = keyframe_step(
            cfg.camera, ms, slot, Tcw, f.uv, f.uv_und, f.octave, f.angle, f.desc, f.valid,
            frame.depth, frame.uright,
            torch.full((f.capacity,), -1, dtype=torch.int32, device=dev),
            tracker._stored_pyr(frame), torch.tensor(kid, dtype=torch.int32, device=dev),
            torch.tensor(0.0, dtype=torch.float32, device=dev),
            torch.tensor(-1, dtype=torch.int32, device=dev),
            scale_factor=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels,
        )
        slot_by_id[kid] = slot
        kp_uv_by_id[kid] = (f.uv.cpu().numpy(), f.valid.cpu().numpy())

    # points, relinked by pixel distance
    kf_mp = ms.kf_mp.cpu().numpy().copy()
    pt_pos = ms.pt_pos.cpu().numpy().copy()
    pt_valid = ms.pt_valid.cpu().numpy().copy()
    n_pts = 0
    for p in (data.get("points") or [])[: ms.P]:
        linked = False
        for ob in p.get("observations") or []:
            kid = int(ob["kf"])
            if kid not in slot_by_id:
                continue
            uv, valid = kp_uv_by_id[kid]
            px = np.array(ob["pixel"][:2], np.float32)
            d2 = np.sum((uv - px) ** 2, axis=1)
            d2[~valid] = np.inf
            j = int(np.argmin(d2))
            if d2[j] <= pixel_tol**2:
                kf_mp[slot_by_id[kid], j] = n_pts
                linked = True
        if linked:
            pt_pos[n_pts] = np.array(p["pose"][:3], np.float32)
            pt_valid[n_pts] = True
            n_pts += 1

    ms = ms._replace(kf_mp=torch.from_numpy(kf_mp).to(dev),
                     pt_pos=torch.from_numpy(pt_pos).to(dev),
                     pt_valid=torch.from_numpy(pt_valid).to(dev),
                     next_pt_id=torch.tensor(n_pts, dtype=torch.int32, device=dev))
    tracker.ms = M.finalize_point_statistics(ms, cfg.orb.scale_factor, cfg.orb.n_levels)
    tracker.st.status = "LOST"
    tracker.st.T_last = np.eye(4, dtype=np.float32)
    if slot_by_id:
        tracker.st.last_kf_slot = max(slot_by_id.values())
    return len(slot_by_id)
