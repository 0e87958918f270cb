"""Phase profile and A/B timing of the PyTorch/CUDA port's kernels K1
(csrc/align_level.cu) and K6 (csrc/chol_solve.cu) on an NVIDIA Hopper card.

    python3 scripts/profile_torch_k1_k6.py            # phases of this tree
    python3 scripts/profile_torch_k1_k6.py --ab DIR   # and DIR's kernels beside this tree's

Phases: builds both sources with -DSD_PROFILE into
sdslam_tpu_torch/_build/profile/, runs each once at chip_smoke.py's
phase-3 shapes (K1: levels 4, 3, 2 at N = 1024; K6: N = 144 and 232) and
prints the clock64() cycles thread 0 spent in each phase of the kernel.

A/B: DIR is a checkout of another commit (for example a `git archive` of
the parent in an ignored directory). DIR, this tree, this tree and DIR
each run in a process of their own (each imports its own
sdslam_tpu_torch and builds its own kernels) and print, per shape, the
wrapper's time as chip_smoke.py measures it (CUDA events around one call,
median of 25), the kernel's device time (torch.profiler, mean of 20
calls) and the host time of one wrapper call. The card's name and power
limit head the output. Needs the card; prints one JSON line per result.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
K1_SHAPES = ((4, 1024), (3, 1024), (2, 1024))
K6_SHAPES = (144, 232)
K1_PHASES = ("stage", "terms", "block_reduce", "push_and_cluster_barrier", "decide")
K6_PHASES = ("load", "first_diag", "trsm_and_forward_step", "syrk_lookahead_diag_forward_gemv",
             "last_forward_step", "backward_triangle", "backward_gemv")


def _spd(N: int, dev):
    import torch

    g = torch.Generator(device="cpu").manual_seed(5 + N)
    A = torch.randn(N, N, generator=g)
    S = (A @ A.T + N * torch.eye(N)).to(dev).contiguous()
    return S, torch.randn(N, generator=g).to(dev)


def _device_us(fn, name: str | None, n: int = 20) -> float:
    """Mean device time per call of fn (torch.profiler): the events whose
    name contains `name`, or every device event when name is None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        if t and (name is None or name in e.key):
            total += t
    return total / n


def _host_us(fn, n: int = 300) -> float:
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
    """Times root's wrappers (its own sdslam_tpu_torch and chip_smoke)."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from sdslam_tpu_torch.kernels import align_kernel as ak, chol_kernel as ck

    dev = torch.device("cuda", 0)
    for level, n in K1_SHAPES:
        args = cs._align_inputs(dev, level, n)
        call = lambda: ak.align_level(*args)  # noqa: E731
        print(json.dumps({"tree": tag, "kernel": "align_level", "level": level, "N": n,
                          "ms": cs.median_ms(call),
                          "device_us": _device_us(call, "align_level_kernel"),
                          "host_us": _host_us(call)}), flush=True)
    for N in K6_SHAPES:
        S, b = _spd(N, dev)
        call = lambda: ck.chol_solve_dense(S, b)  # noqa: E731
        lib = lambda: ck.chol_solve_dense_plain(S, b)  # noqa: E731
        print(json.dumps({"tree": tag, "kernel": "chol_solve", "N": N,
                          "ms": cs.median_ms(call), "library_ms": cs.median_ms(lib),
                          "device_us": _device_us(call, "chol_solve_kernel"),
                          "library_device_us": _device_us(lib, None),
                          "host_us": _host_us(call)}), flush=True)


def phases():
    """Per-phase cycles of this tree's kernels, built with -DSD_PROFILE."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from sdslam_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    out_dir = _build.BUILD_DIR / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("align_level", "chol_solve"):
        lib = out_dir / f"lib{name}-profile.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DSD_PROFILE", "-o", str(lib),
               str(_build.CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = torch.cuda.current_stream(dev).cuda_stream

    def read(lib):
        buf = (ctypes.c_longlong * 8)()
        lib.sd_prof_read.argtypes = [vp]
        lib.sd_prof_read(ctypes.addressof(buf))
        return list(buf)

    lib = libs["chol_solve"]
    lib.sd_chol_solve.argtypes = [vp, vp, vp, ci, vp]
    for N in K6_SHAPES:
        S, b = _spd(N, dev)
        x = torch.empty(N, device=dev)
        _build.check(lib.sd_chol_solve(S.data_ptr(), b.data_ptr(), x.data_ptr(), N, stream),
                     "sd_chol_solve")
        torch.cuda.synchronize()
        print(json.dumps({"kernel": "chol_solve", "N": N,
                          "cycles": dict(zip(K6_PHASES, read(lib)))}), flush=True)
    lib = libs["align_level"]
    lib.sd_align_level.argtypes = [vp, ci, ci, vp, vp, vp, vp, ci, vp, vp, cf, cf, cf, cf, ci,
                                   vp, vp]
    for level, n in K1_SHAPES:
        args = cs._align_inputs(dev, level, n)
        img, X, patch, J, ok, Hinv, T0 = args[:7]
        H, W = img.shape
        out = torch.empty(20, device=dev)
        _build.check(lib.sd_align_level(img.data_ptr(), H, W, X.data_ptr(), patch.data_ptr(),
                                        J.data_ptr(), ok.data_ptr(), n, Hinv.data_ptr(),
                                        T0.data_ptr(), *[float(a) for a in args[7:11]],
                                        int(args[11]), out.data_ptr(), stream), "sd_align_level")
        torch.cuda.synchronize()
        evals = int(out.view(torch.int32)[18]) + 1
        print(json.dumps({"kernel": "align_level", "level": level, "N": n, "evaluations": evals,
                          "cycles": dict(zip(K1_PHASES, read(lib)))}), flush=True)


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
        raise SystemExit("profile_torch_k1_k6: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    phases()
    if a.ab:
        other = Path(a.ab).resolve()
        for tag, tree in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
            subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tag],
                           cwd=tree, check=True)


if __name__ == "__main__":
    main()
