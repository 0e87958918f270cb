"""Command-line front-ends of the port (sdslam_tpu/cli.py), after the
reference's example binaries (Examples/Monocular/monocular.cc,
Examples/RGB-D/rgbd.cc, Examples/Fusion/monocular_imu.cc):

    python -m sdslam_tpu_torch.cli monocular <config.yaml> <image_dir or euroc_dir>
    python -m sdslam_tpu_torch.cli rgbd <config.yaml> <tum_sequence_dir>
    python -m sdslam_tpu_torch.cli fusion <config.yaml> <euroc_dir>
    python -m sdslam_tpu_torch.cli synthetic [--sensor rgbd|monocular] [--frames N]
    python -m sdslam_tpu_torch.cli calibration <image_dir> [--cell-mm 30.2] [--out cam.yaml]

Each run tracks on `--device` (default cuda; `--device cpu` runs the plain
PyTorch versions of the kernels), prints a progress line every 10 frames
and writes the trajectory in TUM format (`--traj-out`), and optionally
the npz map (`--save-map`) and the reference's YAML map
(`--save-trajectory-yaml`, PNGs in a folder beside it). `monocular` reads
a live V4L2 camera when its data argument is a /dev/video* device, paced at
Camera.fps. `--viewer-port PORT` serves the live viewer (viewer_server.py)
at http://127.0.0.1:PORT while tracking (0 picks a free port).
`calibration` estimates the intrinsics from chessboard views (6x4 inner
corners) and writes them as the reference's YAML.
"""

from __future__ import annotations

import argparse
import os
import time

def _common(sub):
    sub.add_argument("--traj-out", default="trajectory.txt")
    sub.add_argument("--save-map", default=None)
    sub.add_argument("--load-map", default=None)
    # the reference's YAML map (System::SaveTrajectory / LoadTrajectory)
    sub.add_argument("--save-trajectory-yaml", default=None, metavar="YAML",
                     help="reference-schema map save (PNG folder next to it)")
    sub.add_argument("--load-trajectory-yaml", default=None, metavar="YAML")
    sub.add_argument("--localization-only", action="store_true")
    sub.add_argument("--no-loop-closing", action="store_true")
    sub.add_argument("--max-frames", type=int, default=None)
    sub.add_argument("--viewer-port", type=int, default=None, metavar="PORT",
                     help="serve a live map/frame view at http://127.0.0.1:PORT while tracking")
    sub.add_argument("--device", default="cuda",
                     help="torch device to track on (default cuda; cpu runs the plain "
                          "versions of the kernels)")


def _parser():
    ap = argparse.ArgumentParser(prog="sdslam_tpu_torch")
    sp = ap.add_subparsers(dest="cmd", required=True)
    for name in ("monocular", "rgbd", "fusion"):
        sub = sp.add_parser(name)
        sub.add_argument("config")
        sub.add_argument("data")
        _common(sub)
    sub = sp.add_parser("synthetic")
    sub.add_argument("--sensor", default="rgbd", choices=["rgbd", "monocular"])
    sub.add_argument("--frames", type=int, default=30)
    _common(sub)
    sub = sp.add_parser("calibration")
    sub.add_argument("image_dir")
    sub.add_argument("--cell-mm", type=float, default=30.2)
    sub.add_argument("--out", default="calibration.yaml")
    return ap


def _system_and_frames(args):
    """The facade for the subcommand and an iterator of its frames:
    (ts, img, x): x is the depth image (RGB-D), the IMU row (fusion) or
    unused (monocular)."""
    from sdslam_tpu_torch.system import MONOCULAR, MONOCULAR_IMU, RGBD, SDSlamSystem
    from sdslam_tpu_torch.utils.config import load_config

    loop = not args.no_loop_closing
    if args.cmd == "synthetic":
        from sdslam_tpu_torch.geometry.camera import CameraModel
        from sdslam_tpu_torch.io.synthetic import SyntheticSequence
        from sdslam_tpu_torch.utils.config import MapConfig, ORBConfig, SystemConfig

        cam = CameraModel(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320, height=240,
                          bf=32.0)
        cfg = SystemConfig(camera=cam, orb=ORBConfig(max_keypoints=512, n_levels=4),
                           map=MapConfig(max_keyframes=32, max_points=4096,
                                         max_kps_per_frame=512))
        sensor = RGBD if args.sensor == "rgbd" else MONOCULAR
        sysm = SDSlamSystem(cfg, sensor=sensor, loop_closing=loop, device=args.device)
        seq = SyntheticSequence(cam, n_frames=args.frames, trajectory="orbit", radius=0.06,
                                yaw_amp=0.04, device=args.device)
        return sysm, (seq.frame(i) for i in range(len(seq)))

    from sdslam_tpu_torch.io import datasets

    cfg = load_config(args.config)
    if args.cmd == "monocular":
        sysm = SDSlamSystem(cfg, sensor=MONOCULAR, loop_closing=loop, device=args.device)
        if args.data.startswith("/dev/video"):
            # live capture, paced at the camera rate (the reference's
            # monocular example opens /dev/videoN the same way)
            from sdslam_tpu_torch.io.camera import live_frames

            frames = live_frames(args.data, cfg.camera.width, cfg.camera.height,
                                 fps=cfg.camera.fps or 30.0)
            return sysm, ((ts, img, None) for ts, img in frames)
        if os.path.exists(os.path.join(args.data, "mav0", "cam0", "data.csv")):
            ds = datasets.EuRoCDataset(args.data)  # EuRoC's images, without its IMU
        else:
            ds = datasets.TUMMonoDataset(args.data)
        return sysm, ((ts, img, None) for ts, img in ds)
    if args.cmd == "rgbd":
        sysm = SDSlamSystem(cfg, sensor=RGBD, loop_closing=loop, device=args.device)
        ds = datasets.TUMRGBDDataset(args.data,
                                     depth_factor=cfg.tracking.depth_map_factor or 5000.0)
        # raw u8 / u16 payloads: the tracker applies DepthMapFactor on the
        # device, as the reference scales the depth in GrabImageRGBD
        return sysm, ds.prefetch_iter(raw=True)
    sysm = SDSlamSystem(cfg, sensor=MONOCULAR_IMU, loop_closing=loop, device=args.device)
    ds = datasets.EuRoCDataset(args.data)

    def fusion_frames():
        last_t = None
        for ts, img in ds:
            rows = ds.imu_between(last_t, ts) if last_t else []
            last_t = ts
            yield ts, img, rows[-1] if rows else [0.0] * 6

    return sysm, fusion_frames()


def main(argv=None):
    from sdslam_tpu_torch.system import MONOCULAR_IMU, RGBD

    args = _parser().parse_args(argv)
    if args.cmd == "calibration":
        return _run_calibration(args)
    sysm, frames = _system_and_frames(args)

    live = None
    if args.viewer_port is not None:
        from sdslam_tpu_torch.viewer_server import LiveViewer

        live = LiveViewer(sysm)
        port = live.start(port=args.viewer_port)
        print(f"live viewer at http://127.0.0.1:{port}", flush=True)

    if args.load_map:
        sysm.load_map(args.load_map)
    if args.load_trajectory_yaml:
        sysm.load_trajectory(args.load_trajectory_yaml)
    if args.localization_only:
        sysm.activate_localization_mode()

    t0 = time.perf_counter()
    n = 0
    for ts, img, extra in frames:
        if sysm.sensor == MONOCULAR_IMU:
            sysm.track_fusion(img, extra, ts)
        elif sysm.sensor == RGBD:
            sysm.track_rgbd(img, extra, ts)
        else:
            sysm.track_monocular(img, ts)
        n += 1
        if n % 10 == 0:
            # st.status is the host's asynchronous view (get_tracking_state
            # would drain the pipeline)
            fps = n / (time.perf_counter() - t0)
            print(f"frame {n}: state={sysm.tracker.st.status} {fps:.1f} fps", flush=True)
        if args.max_frames and n >= args.max_frames:
            break
        if sysm.stop_requested:
            print("stop requested: saving and exiting", flush=True)
            break

    sysm.finish()
    if live is not None:
        live.stop()
    sysm.save_trajectory_tum(args.traj_out)
    print(f"saved {args.traj_out} ({n} poses); final state {sysm.get_tracking_state()}")
    if args.save_map:
        sysm.save_map(args.save_map)
        print(f"saved map checkpoint {args.save_map}")
    if args.save_trajectory_yaml:
        folder = os.path.splitext(args.save_trajectory_yaml)[0] + "_images"
        sysm.save_trajectory(args.save_trajectory_yaml, folder)
        print(f"saved reference-format map {args.save_trajectory_yaml}")
    sysm.shutdown()


def _run_calibration(args):
    """Chessboard calibration over every image in a folder; writes the
    intrinsics as the reference's YAML (Examples/Calibration)."""
    import glob

    import numpy as np
    from PIL import Image

    from sdslam_tpu_torch.features.pattern import calibrate_from_images

    paths = sorted(p for p in glob.glob(os.path.join(args.image_dir, "*"))
                   if p.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".pgm")))
    if not paths:
        raise SystemExit(f"no images found in {args.image_dir}")
    imgs = [np.asarray(Image.open(p).convert("L")) for p in paths]
    cam, rms = calibrate_from_images(imgs, cell=args.cell_mm / 1000.0)
    with open(args.out, "w") as f:
        f.write("%YAML:1.0\n\n")
        f.write(f"Camera.Width: {cam.width}\n")
        f.write(f"Camera.Height: {cam.height}\n")
        f.write(f"Camera.fx: {cam.fx:.6f}\nCamera.fy: {cam.fy:.6f}\n")
        f.write(f"Camera.cx: {cam.cx:.6f}\nCamera.cy: {cam.cy:.6f}\n")
        f.write(f"Camera.k1: {cam.k1:.6f}\nCamera.k2: {cam.k2:.6f}\n")
        f.write(f"Camera.p1: {cam.p1:.6f}\nCamera.p2: {cam.p2:.6f}\n")
        f.write(f"Camera.k3: {cam.k3:.6f}\n")
    print(f"calibrated {len(imgs)} views, reprojection RMS {rms:.4f} px")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    main()
