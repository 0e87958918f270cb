"""The direct aligner through a cell's lens on the card, against the plain
float64 reference (`perf_bench/align_ref.py`: the lens in the warp, the
raw levels). Not part of a benchmark run.

For `--pairs` frame pairs of the cell's lap (a frame and the one
`--gap` frames later, the first drawn from the seed), the reference frame
becomes a keyframe with the rendered depth at its keypoints, and the
program aligns the later frame to it from the identity: the tracker's seed
(`pipeline/tracking.py::_align_seed`, kernel K1, on the lens-corrected
levels of `features/frame.py`) and the pool alignment of relocalization
and loop detection (`pipeline/relocalization.py::align_pool`, kernel K5).
The reference aligns the same points on the raw levels. Prints one JSON
line per pair: each pose's gap to the reference and to the truth
(translation in mm, rotation in degrees).

    python3 perf_bench/align_check.py --workload <cell> --seed <n> --pairs 4
"""

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
DEPTH_FACTOR = 5000.0


def gap(A, B):
    """(translation mm, rotation degrees) between two [4,4] poses."""
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    dR = A[:3, :3] @ B[:3, :3].T
    ang = math.degrees(math.acos(float(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0))))
    return round(float(np.linalg.norm(A[:3, 3] - B[:3, 3])) * 1e3, 4), round(ang, 5)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--gap", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from perf_bench import align_ref, harness
    from perf_bench import scene as sc
    from perf_bench import traffic as tr
    from perf_bench.manifest import Manifest
    from sdslam_tpu_torch.features.frame import ALIGN_MIN_LEVEL, ORBExtractor, make_frame
    from sdslam_tpu_torch.geometry import camera as cam_mod
    from sdslam_tpu_torch.kernels import _build
    from sdslam_tpu_torch.mapping import map_state as M
    from sdslam_tpu_torch.pipeline import tracking
    from sdslam_tpu_torch.pipeline.relocalization import align_pool

    if not torch.cuda.is_available():
        sys.exit("perf_bench.align_check: no CUDA device")
    dev = torch.device("cuda")
    _build.build()
    manifest = Manifest(ROOT)
    cell = manifest.workload(args.workload)
    conf = manifest.config(cell["config"])
    params = manifest.traffic(cell["traffic"])
    cfg = harness.program_config(conf, False)
    cam = cfg.camera
    scam = sc.Camera.from_yaml_keys(conf["settings"])
    lap = tr.make_lap(params, scam, None, args.seed, dev)
    scene = lap.scene.to(dev)
    rays = sc.pixel_rays(scam, dev)
    ext = ORBExtractor(cam, cfg.orb)
    rng = np.random.default_rng([args.seed % 2**63, 7])
    firsts = rng.choice(len(lap.poses) - args.gap, args.pairs, replace=False)
    sf, nl = cfg.orb.scale_factor, cfg.orb.n_levels
    for k in sorted(int(f) for f in firsts):
        j = k + args.gap
        _, dep = sc.render(scene, rays, torch.as_tensor(lap.poses[k], dtype=torch.float32,
                                                        device=dev))
        img_k = torch.as_tensor(lap.images[k], device=dev)
        img_j = torch.as_tensor(lap.images[j], device=dev)
        fr = make_frame(ext, img_k, torch.round(dep * DEPTH_FACTOR).to(torch.int32), DEPTH_FACTOR)
        cur = make_frame(ext, img_j)
        f = fr.features
        ms = M.init_map(2, 2048, f.capacity,
                        tuple(tuple(p.shape) for p in fr.pyramid[ALIGN_MIN_LEVEL:]), device=dev)
        i32 = torch.int32
        ms = tracking.keyframe_step(
            cam, ms, 0, torch.eye(4, device=dev), f.uv, f.uv_und, f.octave, f.angle, f.desc,
            f.valid, fr.depth, fr.uright, torch.full((f.capacity,), -1, dtype=i32, device=dev),
            tuple(fr.pyramid[ALIGN_MIN_LEVEL:]), torch.tensor(0, dtype=i32, device=dev),
            torch.tensor(0.0, device=dev), torch.tensor(-1, dtype=i32, device=dev),
            scale_factor=sf, n_levels=nl)
        ms = tracking.spawn_points(cam, ms, 0, torch.tensor(float("inf"), device=dev),
                                   scale_factor=sf, n_levels=nl)
        assoc = ms.kf_mp[0]
        T_seed = tracking._align_seed(
            cam, ms, torch.tensor(0, device=dev), ms.kf_Tcw[0], assoc,
            torch.clamp(assoc, 0, ms.P - 1).long(), cur.pyramid, torch.eye(4, device=dev),
            scale_factor=sf, n_levels=nl).T_cur_ref
        T_pool = align_pool(cam, ms, tuple(cur.pyramid[ALIGN_MIN_LEVEL:]), max_level=nl - 1,
                            min_level=ALIGN_MIN_LEVEL, scale_factor=sf,
                            store_min_level=ALIGN_MIN_LEVEL, iters=30)[0][0]
        raw = [ext.extract(im.to(torch.float32))[1][ALIGN_MIN_LEVEL:] for im in (img_k, img_j)]
        valid = (ms.kf_kp_valid[0] & (ms.kf_depth[0] > 0) & (ms.kf_mp[0] >= 0)).cpu()
        X = cam_mod.backproject(cam, ms.kf_uv_und[0].double(),
                                ms.kf_depth[0].double().clamp(1e-3)).cpu()
        T_ref = align_ref.align(tuple(r.cpu() for r in raw[0]), tuple(r.cpu() for r in raw[1]),
                                X, valid, torch.eye(4, dtype=torch.float64), cam,
                                scale_factor=sf, start_level=ALIGN_MIN_LEVEL, max_level=nl - 1,
                                min_level=ALIGN_MIN_LEVEL).numpy()
        truth = lap.poses[j] @ np.linalg.inv(lap.poses[k])
        T_seed, T_pool = T_seed.cpu().numpy(), T_pool.cpu().numpy()
        print(json.dumps({
            "workload": args.workload, "frames": [k, j], "points": int(valid.sum()),
            "device": torch.cuda.get_device_name(0),
            "seed_vs_ref": gap(T_seed, T_ref), "pool_vs_ref": gap(T_pool, T_ref),
            "seed_vs_truth": gap(T_seed, truth), "pool_vs_truth": gap(T_pool, truth),
            "ref_vs_truth": gap(T_ref, truth), "motion": gap(truth, np.eye(4))}), flush=True)


if __name__ == "__main__":
    main()
