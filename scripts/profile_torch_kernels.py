"""Device times, phase cycles and an A/B of the PyTorch/CUDA port's kernels
K1-K7 on an NVIDIA Hopper card.

    python3 scripts/profile_torch_kernels.py            # phases, then this tree's times
    python3 scripts/profile_torch_kernels.py --ab DIR   # phases, then DIR's times beside this tree's

Phases: builds csrc/align_level.cu, csrc/accumulate_gn.cu, csrc/pose_gn.cu
and csrc/chol_solve.cu with -DSD_PROFILE into sdslam_tpu_torch/_build/
profile/, runs each once at chip_smoke.py's phase-3 shapes and prints the
clock64() cycles thread 0 (of lane 0's first CTA) spent in each phase of
the kernel and each build's ptxas line.

Times: for every kernel at chip_smoke.py's phase-3 shapes (K4 also as the
windowed searches call it: the fused form, and the matrix form followed by
the torch masking and best-two ops it replaces), and for one batched
alignment level (solvers/image_align.py:_align_level_batched at
B = 256, N = 1024, levels 4 and 3, 15 iterations), the wrapper's time as
chip_smoke.py measures it (CUDA events around one call, median of 25), the
device time of the kernel's own events and of every device event of the
call (torch.profiler, mean of 10 calls, chip_smoke.device_profile) and the
host time of one call. The inputs always come from this tree's
chip_smoke.py; each timed tree runs in a process of its own with its own
sdslam_tpu_torch and kernels. With --ab, DIR is a checkout of another
commit (for example a `git archive` of the parent in an ignored
directory), timed in the order DIR, this, this, DIR. The card's name and
power limit head the output. Needs the card; prints one JSON line per
result.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
K1_SHAPES = ((4, 1024), (3, 1024), (2, 1024))
K6_SHAPES = (144, 232)
POSE_CASES = ((1.2, 1024), (math.pi - 0.1, 1024), (0.005, 1024), (0.005, 4096))
BA_CASES = ((24, True, 10, 2048), (80, False, 10, 2048), (256, False, 16, 16384))
HAMMING_SHAPES = ((1024, 1024), (16384, 1024))
BA_EDGE_CASES = ((256, 16, 8192), (24, 10, 2048))
LEVELS = (4, 3)
LEVEL_ITERS = 15
# the kernels' own device events, by function name (either tree's)
OWN = {"align_level": ("align_level_kernel",), "pose_gn": ("pose_gn_kernel",),
       "ba_schur": ("ba_schur_kernel",), "hamming": ("hamming_kernel",),
       "hamming_seq": ("hamming_kernel",), "hamming_best2": ("hamming_best2_kernel",),
       "accumulate_gn": ("accumulate_gn_kernel", "align_level_kernel"),
       "chol_solve": ("chol_solve_kernel",), "ba_edge": ("ba_edge_kernel",),
       "align_batched": ("accumulate_gn_kernel", "align_level_kernel")}
K1_PHASES = ("stage", "terms", "block_reduce", "push_and_cluster_barrier", "decide")
K2_PHASES = ("load", "prior_log", "edges_push_cluster_barrier", "decide", "hand_over",
             "reclassify_final")
K6_PHASES = ("load", "first_diag", "trsm_and_forward_step", "syrk_lookahead_diag_forward_gemv",
             "last_forward_step", "backward_triangle", "backward_gemv")


def inputs_module():
    """This tree's chip_smoke.py (the input makers), whichever
    sdslam_tpu_torch is first on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spd(N: int, dev):
    import torch

    g = torch.Generator(device="cpu").manual_seed(5 + N)
    A = torch.randn(N, N, generator=g)
    S = (A @ A.T + N * torch.eye(N)).to(dev).contiguous()
    return S, torch.randn(N, generator=g).to(dev)


def _host_us(fn, n: int = 200) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return dt


def timings(root: Path, tag: str):
    """Times root's wrappers (its own sdslam_tpu_torch) on this tree's inputs."""
    sys.path.insert(0, str(root))
    import torch

    cs = inputs_module()
    from sdslam_tpu_torch.kernels import (
        accumulate_gn_kernel as gk, align_kernel as ak, ba_edge_kernel as ek,
        ba_schur_kernel as bk, chol_kernel as ck, hamming_kernel as hk, pose_kernel as pk,
    )
    from sdslam_tpu_torch.solvers import image_align as ia

    dev = torch.device("cuda", 0)

    def report(kernel, call, reps: int = 25, **case):
        rec = {"tree": tag, "kernel": kernel, **case, "ms": cs.median_ms(call, reps=reps),
               **cs.device_profile(call, OWN[kernel]), "host_us": _host_us(call)}
        print(json.dumps(rec), flush=True)

    for level, n in K1_SHAPES:
        args = cs._align_inputs(dev, level, n)
        report("align_level", lambda: ak.align_level(*args), level=level, N=n)
    for prior, n in POSE_CASES:
        args = cs._pose_inputs(dev, prior, n)
        report("pose_gn", lambda: pk.pose_optimize(*args), prior_rad=prior, N=n)
    for K, zt, Mo, P in BA_CASES:
        args = cs._ba_inputs(dev, K, Mo=Mo, P=P)
        report("ba_schur", lambda: bk.ba_edge_schur(*args, emit_zt=zt), K=K, shape=[28, Mo, P])
    g = torch.Generator(device="cpu").manual_seed(3)
    for na, nb in HAMMING_SHAPES:
        da, db = (torch.randint(-2**31, 2**31 - 1, (m, 8), generator=g, dtype=torch.int64)
                  .to(torch.int32).to(dev) for m in (na, nb))
        report("hamming", lambda: hk.hamming_matrix(da, db), shape=[na, nb])
    from sdslam_tpu_torch.ops import hamming as ham

    for na, nb in HAMMING_SHAPES:
        da, db, margs = cs._best2_inputs(dev, na, nb)
        mask = cs._window_mask(*margs)
        # the windowed searches' call: the matrix form + torch (every tree),
        # K4's fused form (trees that have it)
        report("hamming_seq", lambda: ham.best2(ham.masked_dist(da, db, mask)), shape=[na, nb])
        if hasattr(hk, "hamming_masked_best2"):
            report("hamming_best2", lambda: hk.hamming_masked_best2(da, db, mask),
                   shape=[na, nb])
    for level in LEVELS:
        args = cs._gn_inputs(dev, level)
        report("accumulate_gn", lambda: gk.accumulate_gn(*args), level=level, B=256, N=1024)
    for N in K6_SHAPES:
        S, b = _spd(N, dev)
        report("chol_solve", lambda: ck.chol_solve_dense(S, b), N=N)
    for K, Mo, P in BA_EDGE_CASES:
        args = cs._ba_inputs(dev, K, Mo=Mo, P=P)
        packed = args[0][:27].reshape(27, Mo * P).contiguous()
        report("ba_edge", lambda: ek.ba_edge_terms(packed, *args[2:8]), E=Mo * P)
    for level in LEVELS:
        img, X, patch, J, ok, T, intr = cs._batched_inputs(dev, level)
        report("align_batched", lambda: ia._align_level_batched(img, T, X, patch, J, ok, *intr,
                                                                LEVEL_ITERS),
               reps=10, level=level, B=256, N=1024, iters=LEVEL_ITERS)


def _nvcc(name: str, out_dir: Path):
    """Starts nvcc on csrc/<name>.cu with -DSD_PROFILE; (process, library)."""
    from sdslam_tpu_torch.kernels import _build

    lib = out_dir / f"lib{name}-SD_PROFILE.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DSD_PROFILE", "-o", str(lib),
           str(_build.CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


@contextlib.contextmanager
def bound_to(module: str, symbol: str, lib):
    """The wrappers of `module` call `symbol` of `lib` (the -DSD_PROFILE
    build of the same source) inside the block; a wrapper call must have
    bound the regular build's `symbol` before."""
    from sdslam_tpu_torch.kernels import _build

    key = (module, symbol)
    regular = _build._FNS[key]
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = regular.argtypes, ctypes.c_int
    _build._FNS[key] = fn
    try:
        yield
    finally:
        _build._FNS[key] = regular


def phases():
    """Per-phase cycles of this tree's kernels, built with -DSD_PROFILE."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from sdslam_tpu_torch.kernels import _build, accumulate_gn_kernel as gk
    from sdslam_tpu_torch.kernels import align_kernel as ak, pose_kernel as pk
    from sdslam_tpu_torch.solvers import image_align as ia

    dev = torch.device("cuda", 0)
    out_dir = _build.BUILD_DIR / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    _build.build()
    procs = {name: _nvcc(name, out_dir)
             for name in ("align_level", "accumulate_gn", "pose_gn", "chol_solve")}
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(json.dumps({"build": name, "ptxas": cs.ptxas_summary(log)}), flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    vp = ctypes.c_void_p
    stream = torch.cuda.current_stream(dev).cuda_stream

    def read(lib):
        buf = (ctypes.c_longlong * 8)()
        lib.sd_prof_read.argtypes = [vp]
        lib.sd_prof_read(ctypes.addressof(buf))
        return list(buf)

    def once(fn):
        out = fn()
        torch.cuda.synchronize()
        return out

    lib = libs["chol_solve"]
    lib.sd_chol_solve.argtypes = [vp, vp, vp, ctypes.c_int, vp]
    for N in K6_SHAPES:
        S, b = _spd(N, dev)
        x = torch.empty(N, device=dev)
        _build.check(lib.sd_chol_solve(S.data_ptr(), b.data_ptr(), x.data_ptr(), N, stream),
                     "sd_chol_solve")
        torch.cuda.synchronize()
        print(json.dumps({"kernel": "chol_solve", "N": N,
                          "cycles": dict(zip(K6_PHASES, read(lib)))}), flush=True)
    for level, n in K1_SHAPES + ((2, 4096),):
        args = cs._align_inputs(dev, level, n)
        once(lambda: ak._launch(*args))
        with bound_to("align_level", "sd_align_level", libs["align_level"]):
            out = once(lambda: ak._launch(*args))
        print(json.dumps({"kernel": "align_level", "level": level, "N": n,
                          "evaluations": int(ak._iterations(out)) + 1,
                          "cycles": dict(zip(K1_PHASES, read(libs["align_level"])))}),
              flush=True)
    for level in LEVELS:
        img, X, patch, J, ok, T, intr = cs._batched_inputs(dev, level)
        L = ia._damped_cholesky(J, ok).contiguous()
        args = (img, X, patch, J, ok, L, T, *intr, LEVEL_ITERS)
        once(lambda: gk._launch_level(*args))
        with bound_to("accumulate_gn", "sd_align_batched", libs["accumulate_gn"]):
            out = once(lambda: gk._launch_level(*args))
        print(json.dumps({"kernel": "align_batched", "level": level, "B": 256, "N": 1024,
                          "evaluations_lane0": int(gk._level_views(out, 256)[3][0]) + 1,
                          "cycles": dict(zip(K1_PHASES, read(libs["accumulate_gn"])))}),
              flush=True)
    for prior, n in POSE_CASES:
        args = cs._pose_inputs(dev, prior, n)
        once(lambda: pk.pose_optimize(*args))
        with bound_to("pose_gn", "sd_pose_gn", libs["pose_gn"]):
            once(lambda: pk.pose_optimize(*args))
        print(json.dumps({"kernel": "pose_gn", "prior_rad": prior, "N": n,
                          "steps": args[9] * args[10],
                          "cycles": dict(zip(K2_PHASES, read(libs["pose_gn"])))}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", metavar="DIR", help="checkout of another commit to time beside this tree")
    ap.add_argument("--worker", metavar="TAG", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:  # one timing process, run from the tree it times
        timings(Path.cwd(), a.worker)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_kernels: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    phases()
    runs = [("this", ROOT)]
    if a.ab:
        other = Path(a.ab).resolve()
        runs = [("other", other), ("this", ROOT), ("this", ROOT), ("other", other)]
    for tag, tree in runs:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tag],
                       cwd=tree, check=True)


if __name__ == "__main__":
    main()
