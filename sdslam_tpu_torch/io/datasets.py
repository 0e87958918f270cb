"""Dataset loaders: TUM RGB-D, TUM monocular and EuRoC MAV, timestamp
association and the writers of both formats (sdslam_tpu/io/datasets.py).

The reference's example front-ends (Examples/Monocular/monocular.cc,
Examples/RGB-D/rgbd.cc, Examples/Fusion/monocular_imu.cc) and its
associate.py tool (nearest-timestamp pairing of rgb / depth / imu streams).
Images are decoded with PIL, imported where it is used.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np
import torch


def _numpy(x) -> np.ndarray:
    """A host numpy array of a numpy array or a (device) tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _decode(path: str) -> np.ndarray:
    """A PNG's pixels in their stored type: u8 for 8-bit gray, u16 for
    16-bit gray; any other mode converted to 8-bit gray (PIL's luma)."""
    from PIL import Image

    with Image.open(path) as img:
        if img.mode not in ("L", "I;16", "I"):
            img = img.convert("L")
        return np.array(img)


def _load_image(path: str) -> np.ndarray:
    """Grayscale float32 image."""
    return _decode(path).astype(np.float32)


def read_tum_list(path: str) -> List[Tuple[float, str]]:
    """Parse a TUM-format list file (rgb.txt / depth.txt): `timestamp path`."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, rel = line.split()[:2]
            out.append((float(ts), rel))
    return out


def associate(a: List[Tuple[float, str]], b: List[Tuple[float, str]],
              max_difference: float = 0.02,
              offset: float = 0.0) -> List[Tuple[float, str, float, str]]:
    """Nearest-timestamp association (the reference's associate.py): every
    pair closer than max_difference, taken greedily from the closest, each
    timestamp used once; returned sorted by time."""
    pairs = []
    for ta, pa in a:
        for tb, pb in b:
            if abs(ta - (tb + offset)) < max_difference:
                pairs.append((abs(ta - (tb + offset)), ta, pa, tb, pb))
    pairs.sort()
    used_a, used_b = set(), set()
    out = []
    for _, ta, pa, tb, pb in pairs:
        if ta in used_a or tb in used_b:
            continue
        used_a.add(ta)
        used_b.add(tb)
        out.append((ta, pa, tb, pb))
    out.sort()
    return out


class TUMRGBDDataset:
    """TUM RGB-D sequence: associated rgb + depth pairs.

    Layout: <root>/rgb.txt, <root>/depth.txt, images relative to root.
    Depth scale: 5000 counts per metre (the TUM convention; the reference
    reads DepthMapFactor from its YAML)."""

    def __init__(self, root: str, depth_factor: float = 5000.0):
        self.root = root
        self.depth_factor = depth_factor
        rgb = read_tum_list(os.path.join(root, "rgb.txt"))
        depth = read_tum_list(os.path.join(root, "depth.txt"))
        self.assoc = associate(rgb, depth)
        if not self.assoc:
            raise RuntimeError(f"no rgb/depth associations under {root}")

    def __len__(self):
        return len(self.assoc)

    def frame(self, i: int):
        """(timestamp, image f32, depth f32 metres)."""
        ts, rgb_rel, _, depth_rel = self.assoc[i]
        img = _load_image(os.path.join(self.root, rgb_rel))
        depth = _load_image(os.path.join(self.root, depth_rel)) / self.depth_factor
        return ts, img, depth

    def raw_frame(self, i: int):
        """(timestamp, image u8, depth u16 counts): the tracker's packed
        ingest types; 16-bit intensity keeps its high byte."""
        ts, rgb_rel, _, depth_rel = self.assoc[i]
        img = _decode(os.path.join(self.root, rgb_rel))
        if img.dtype != np.uint8:
            img = (img >> 8).astype(np.uint8)
        depth = _decode(os.path.join(self.root, depth_rel)).astype(np.uint16)
        return ts, img, depth

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)

    def prefetch_iter(self, n_threads: int = 2, depth: int = 8, raw: bool = False):
        """Iterate the frames in order while up to `depth` of them decode
        ahead on `n_threads` threads, so the tracker does not wait for PNG
        decoding. raw=True yields `raw_frame` items, else `frame` items."""
        load = self.raw_frame if raw else self.frame
        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            ahead = deque(pool.submit(load, i) for i in range(min(depth, len(self))))
            nxt = len(ahead)
            while ahead:
                item = ahead.popleft().result()
                if nxt < len(self):
                    ahead.append(pool.submit(load, nxt))
                    nxt += 1
                yield item


class TUMMonoDataset:
    """Monocular TUM: rgb.txt only (or a folder of images at 30 fps, as the
    reference's monocular example reads, monocular.cc:52-76)."""

    def __init__(self, root: str):
        self.root = root
        lst = os.path.join(root, "rgb.txt")
        if os.path.exists(lst):
            self.items = read_tum_list(lst)
        else:
            files = sorted(os.listdir(root))
            self.items = [(i / 30.0, f) for i, f in enumerate(files)
                          if f.lower().endswith((".png", ".jpg"))]

    def __len__(self):
        return len(self.items)

    def frame(self, i: int):
        ts, rel = self.items[i]
        return ts, _load_image(os.path.join(self.root, rel))

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)


class EuRoCDataset:
    """EuRoC MAV format: mav0/cam0/data.csv + mav0/imu0/data.csv.

    Yields (timestamp, image); `imu_between(t0, t1)` gives the fusion
    front-end its IMU rows (monocular_imu.cc's association)."""

    def __init__(self, root: str):
        self.root = root
        self.items = []
        with open(os.path.join(root, "mav0", "cam0", "data.csv")) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                ts_ns, name = line.strip().split(",")[:2]
                self.items.append((int(ts_ns) * 1e-9, name))
        self.imu = []
        imu_csv = os.path.join(root, "mav0", "imu0", "data.csv")
        if os.path.exists(imu_csv):
            with open(imu_csv) as f:
                for line in f:
                    if line.startswith("#"):
                        continue
                    vals = line.strip().split(",")
                    self.imu.append((int(vals[0]) * 1e-9, [float(v) for v in vals[1:7]]))

    def __len__(self):
        return len(self.items)

    def frame(self, i: int):
        ts, name = self.items[i]
        return ts, _load_image(os.path.join(self.root, "mav0", "cam0", "data", name))

    def imu_between(self, t0: float, t1: float):
        """IMU rows (gx gy gz ax ay az) with t0 < t <= t1."""
        return [m for (t, m) in self.imu if t0 < t <= t1]

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)


def _save_png(arr: np.ndarray, path: str):
    """u8 [H,W] as 8-bit gray, u16 [H,W] as 16-bit gray."""
    from PIL import Image

    Image.fromarray(arr).save(path)


def write_euroc_sequence(root: str, frames, imu_rows=None):
    """Write a EuRoC-MAV-format sequence: mav0/cam0/data.csv and
    mav0/cam0/data/<ns>.png (8-bit gray), and with `imu_rows`
    mav0/imu0/data.csv (timestamp_ns, gx gy gz, ax ay az). The real dataset
    path (CSV, nanosecond stamps, PNG decode, IMU association) then runs
    without a download.

    frames: iterable of (timestamp_s, img float/uint8 [H,W], array or tensor).
    imu_rows: optional iterable of (timestamp_s, [gx gy gz ax ay az]).
    """
    cam_dir = os.path.join(root, "mav0", "cam0", "data")
    os.makedirs(cam_dir, exist_ok=True)
    lines = ["#timestamp [ns],filename"]
    for ts, img in frames:
        ns = int(round(ts * 1e9))
        name = f"{ns}.png"
        _save_png(np.clip(_numpy(img), 0, 255).astype(np.uint8), os.path.join(cam_dir, name))
        lines.append(f"{ns},{name}")
    with open(os.path.join(root, "mav0", "cam0", "data.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    if imu_rows is not None:
        imu_dir = os.path.join(root, "mav0", "imu0")
        os.makedirs(imu_dir, exist_ok=True)
        lines = ["#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
                 "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],"
                 "a_RS_S_z [m s^-2]"]
        for ts, vals in imu_rows:
            ns = int(round(ts * 1e9))
            lines.append(f"{ns}," + ",".join(f"{v:.9f}" for v in vals))
        with open(os.path.join(imu_dir, "data.csv"), "w") as f:
            f.write("\n".join(lines) + "\n")


def write_tum_sequence(root: str, frames, poses_Tcw, depth_factor: float = 5000.0):
    """Write a TUM-RGB-D-format sequence: rgb/*.png (8-bit gray),
    depth/*.png (16-bit, depth_factor counts per metre), rgb.txt, depth.txt
    and groundtruth.txt (timestamp tx ty tz qx qy qz qw, camera-to-world).
    The loader's whole path (PNG decode, lists, association, ground truth)
    then runs without a download.

    frames: iterable of (timestamp, img float/uint8 [H,W], depth_m [H,W]),
    arrays or tensors. poses_Tcw: [N,4,4] world->camera ground truth.
    """
    from sdslam_tpu_torch.geometry import lie

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_lines, depth_lines, gt_lines = [], [], []
    for (ts, img, depth), Tcw in zip(frames, _numpy(poses_Tcw)):
        name = f"{ts:.6f}.png"
        _save_png(np.clip(_numpy(img), 0, 255).astype(np.uint8), os.path.join(root, "rgb", name))
        d16 = np.clip(_numpy(depth) * depth_factor, 0, 65535).astype(np.uint16)
        _save_png(d16, os.path.join(root, "depth", name))
        rgb_lines.append(f"{ts:.6f} rgb/{name}")
        depth_lines.append(f"{ts:.6f} depth/{name}")
        Twc = np.linalg.inv(Tcw)
        q = lie.mat_to_quat(torch.as_tensor(Twc[:3, :3], dtype=torch.float32)).numpy()
        t = Twc[:3, 3]
        gt_lines.append(f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                        f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}")
    for fname, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                         ("groundtruth.txt", gt_lines)):
        with open(os.path.join(root, fname), "w") as f:
            f.write("# synthetic TUM-format sequence\n# timestamp data\n")
            f.write("\n".join(lines) + "\n")
