"""Framework configuration (jax-free port of sdslam_tpu/utils/config.py).

The same frozen dataclasses with the same fields and defaults, and the same
OpenCV-YAML loader for the reference's config keys. The YAML is parsed by a
small reader for the flat `key: value` form these files use, so the port
needs no YAML package on the machine with the card.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Optional

from sdslam_tpu_torch.geometry.camera import CameraModel


@dataclass(frozen=True)
class ORBConfig:
    n_features: int = 1000
    scale_factor: float = 2.0
    n_levels: int = 5
    fast_threshold: int = 20
    max_keypoints: int = 1024
    half_patch: int = 15


@dataclass(frozen=True)
class TrackingConfig:
    th_depth: float = 40.0
    depth_map_factor: float = 1.0
    use_pattern: bool = False
    min_frames: int = 0
    max_frames: int = 30
    align_max_points: int = 300
    align_fast_points: int = 100
    align_patch_half: int = 2
    align_max_level: int = 4
    align_min_level: int = 2
    align_min_level_kf: int = 4
    align_iters: int = 30
    pose_gn_schedule: tuple = ((2, 4), (2, 5))
    ba_schedule: tuple = (3, 5)


@dataclass(frozen=True)
class MapConfig:
    max_keyframes: int = 256
    max_points: int = 16384
    max_kps_per_frame: int = 1024
    covis_min_weight: int = 15


@dataclass(frozen=True)
class LocalMappingConfig:
    ba_max_cams: int = 32
    ba_max_points: int = 8192
    ba_iters1: int = 5
    ba_iters2: int = 10
    triangulate_neighbors: int = 10
    culling_min_found_ratio: float = 0.25
    kf_redundancy_ratio: float = 0.9


@dataclass(frozen=True)
class LoopClosingConfig:
    enabled: bool = True
    align_error_factor: float = 1.5
    align_max_error: float = 0.03
    covisibility_consistency_th: int = 3
    min_sim3_matches: int = 20
    min_total_matches: int = 40
    ransac_iters: int = 64


@dataclass(frozen=True)
class SystemConfig:
    camera: CameraModel = CameraModel(
        fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480
    )
    orb: ORBConfig = ORBConfig()
    tracking: TrackingConfig = TrackingConfig()
    map: MapConfig = MapConfig()
    local_mapping: LocalMappingConfig = LocalMappingConfig()
    loop_closing: LoopClosingConfig = LoopClosingConfig()
    camera_topic: str = "/camera/rgb/image_raw"
    depth_topic: str = "/camera/depth_registered/image_raw"
    imu_topic: str = "/imu"


_KEY_VALUE = re.compile(r"^([A-Za-z_][\w.]*)\s*:\s*(.*?)\s*$")


def _scalar(text: str):
    """YAML plain scalar -> int / float / str / None."""
    if text in ("", "~", "null"):
        return None
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    for conv in (int, float):
        try:
            return conv(text)
        except ValueError:
            pass
    return text


def _load_yaml_text(path: str) -> dict:
    """Flat `key: value` OpenCV-FileStorage YAML -> dict (top-level scalar
    keys; `%YAML` directives, comments and nested blocks are skipped)."""
    data = {}
    with open(path) as f:
        for line in f:
            if line.startswith(("%", "---")) or not line.strip():
                continue
            if line[0] in " \t":  # nested block content (opencv-matrix etc.)
                continue
            body = line.split(" #", 1)[0].rstrip()
            if body.lstrip().startswith("#"):
                continue
            m = _KEY_VALUE.match(body)
            if m:
                data[m.group(1)] = _scalar(m.group(2))
    return data


def load_config(path: Optional[str] = None, **overrides) -> SystemConfig:
    """Build a SystemConfig, optionally from a reference-format YAML file
    (the same keys and defaults as load_config in sdslam_tpu/utils/config.py)."""
    cfg = SystemConfig()
    if path is not None:
        d = _load_yaml_text(path)

        def g(key, default):
            v = d.get(key, default)
            return default if v is None else v

        cam = CameraModel(
            fx=float(g("Camera.fx", cfg.camera.fx)),
            fy=float(g("Camera.fy", cfg.camera.fy)),
            cx=float(g("Camera.cx", cfg.camera.cx)),
            cy=float(g("Camera.cy", cfg.camera.cy)),
            width=int(g("Camera.Width", cfg.camera.width)),
            height=int(g("Camera.Height", cfg.camera.height)),
            k1=float(g("Camera.k1", 0.0)),
            k2=float(g("Camera.k2", 0.0)),
            p1=float(g("Camera.p1", 0.0)),
            p2=float(g("Camera.p2", 0.0)),
            k3=float(g("Camera.k3", 0.0)),
            bf=float(g("Camera.bf", 0.0)),
            fps=float(g("Camera.fps", 30.0)),
        )
        n_feat = int(g("ORBextractor.nFeatures", 1000))
        orb = ORBConfig(
            n_features=n_feat,
            scale_factor=float(g("ORBextractor.scaleFactor", 2.0)),
            n_levels=int(g("ORBextractor.nLevels", 5)),
            fast_threshold=int(g("ORBextractor.thresholdFAST", 20)),
            max_keypoints=max(256, 1 << (max(n_feat, 1) - 1).bit_length()),
        )
        tracking = TrackingConfig(
            th_depth=float(g("ThDepth", 40.0)),
            depth_map_factor=float(g("DepthMapFactor", 1.0)),
            use_pattern=bool(g("UsePattern", 0)),
            max_frames=int(round(cam.fps)) if cam.fps > 0 else 30,
        )
        map_cfg = MapConfig(
            max_keyframes=int(g("Map.MaxKeyframes", cfg.map.max_keyframes)),
            max_points=int(g("Map.MaxPoints", cfg.map.max_points)),
            max_kps_per_frame=orb.max_keypoints,
        )
        cfg = dataclasses.replace(
            cfg, camera=cam, orb=orb, tracking=tracking, map=map_cfg,
            camera_topic=str(g("ROS.CameraTopic", cfg.camera_topic)),
            depth_topic=str(g("ROS.DepthTopic", cfg.depth_topic)),
            imu_topic=str(g("ROS.IMUTopic", cfg.imu_topic)),
        )
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
