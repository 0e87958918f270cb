"""Command-line front-ends of the port (sdslam_tpu/cli.py), after the
reference's example binaries (Examples/Monocular/monocular.cc,
Examples/RGB-D/rgbd.cc, Examples/Fusion/monocular_imu.cc):

    python -m sdslam_tpu_torch.cli monocular <config.yaml> <image_dir or euroc_dir>
    python -m sdslam_tpu_torch.cli rgbd <config.yaml> <tum_sequence_dir>
    python -m sdslam_tpu_torch.cli fusion <config.yaml> <euroc_dir>
    python -m sdslam_tpu_torch.cli synthetic [--sensor rgbd|monocular] [--frames N]

Each run tracks on `--device` (default cuda; `--device cpu` runs the plain
PyTorch versions of the kernels), prints a progress line every 10 frames
and writes the trajectory in TUM format (`--traj-out`), and optionally
the npz map (`--save-map`) and the reference's YAML map
(`--save-trajectory-yaml`, PNGs in a folder beside it).
"""

from __future__ import annotations

import argparse
import os
import time

# what the JAX package's CLI has and the port does not yet, with the item
# of ROADMAP.md's module queue that brings it
_NOT_PORTED = {
    "camera": "live /dev/video capture (io/camera.py) comes with M17c, viewers and "
              "device front-ends",
    "viewer": "the live viewer (viewer_server.py) comes with M17c, viewers and device "
              "front-ends",
    "calibration": "chessboard calibration (features/pattern.py) comes with the last item, "
                   "pattern initialization and calibration",
}


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
                     help="live map/frame view (not ported yet)")
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
        if args.data.startswith("/dev/video"):
            raise NotImplementedError(_NOT_PORTED["camera"])
        sysm = SDSlamSystem(cfg, sensor=MONOCULAR, loop_closing=loop, device=args.device)
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
        raise NotImplementedError(_NOT_PORTED["calibration"])
    if args.viewer_port is not None:
        raise NotImplementedError(_NOT_PORTED["viewer"])
    sysm, frames = _system_and_frames(args)

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


if __name__ == "__main__":
    main()
