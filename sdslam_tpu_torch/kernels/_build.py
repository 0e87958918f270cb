"""Build the port's CUDA kernels and load them with ctypes.

Each `csrc/<name>.cu` compiles, with nvcc alone, into its own shared library
with a plain C interface (no PyTorch headers: a build takes seconds, not
minutes): `_build/lib<name>-<hash>.so`, where the hash covers the source,
the shared headers and the flags, so an edited source rebuilds and an
unchanged one is reused. The flags define the robust-kernel thresholds of
solvers/ba_const.py (SD_CHI2_*, SD_HUBER_*) for every source. `build()` starts one nvcc per stale source, all in
parallel. Every C entry point returns cudaGetLastError(); `check()` turns a
nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

from sdslam_tpu_torch.solvers import ba_const

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("hamming", "align_level", "pose_gn", "ba_schur", "accumulate_gn", "chol_solve",
           "ba_edge")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
) + tuple(
    # the robust-kernel thresholds have one definition, solvers/ba_const.py
    f"-DSD_{k}={getattr(ba_const, k)!r}f"
    for k in ("CHI2_MONO", "CHI2_STEREO", "HUBER_MONO", "HUBER_STEREO")
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[Tuple[str, str], object] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale library among `names`, one nvcc process per
    source, all started together. Returns {name: compiler log} for the
    sources it compiled (ptxas register/spill report included)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out,
        )
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if stale."""
    lib = _LIBS.get(name)
    if lib is None:
        if not lib_path(name).exists():
            build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib


def bind(name: str, symbol: str, argtypes):
    """ctypes function `symbol` of library `name`, returning int. Bound
    once per (library, symbol): later calls return the same function
    without setting its argtypes again."""
    fn = _FNS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[(name, symbol)] = fn
    return fn


def check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
