"""Hand-written CUDA kernels (K1-K7) with their plain PyTorch versions.

Each module mirrors one sdslam_tpu/ops/pallas kernel: a plain function of
the same signature (used for CPU tensors and as the on-card oracle) and a
wrapper that launches the CUDA kernel for CUDA tensors and counts launches
in its module's `LAUNCHES` (K4's fused form in `BEST2_LAUNCHES`, K5's
batched level in `LEVEL_LAUNCHES`). `COUNTERS` names every counter.

The pipelined tracker (parallel/pipelined.py) launches kernels from its
mapping worker thread as well as from the tracking thread, so a launch is
counted under a lock: `+=` on a module global is a read-modify-write that
a thread switch can split.
"""

from __future__ import annotations

import importlib
import sys
import threading

# kernel name -> (module of this package, its launch counter)
COUNTERS = {
    "align_level": ("align_kernel", "LAUNCHES"),
    "pose_gn": ("pose_kernel", "LAUNCHES"),
    "ba_schur": ("ba_schur_kernel", "LAUNCHES"),
    "hamming": ("hamming_kernel", "LAUNCHES"),
    "hamming_best2": ("hamming_kernel", "BEST2_LAUNCHES"),
    "accumulate_gn": ("accumulate_gn_kernel", "LAUNCHES"),
    "align_batched": ("accumulate_gn_kernel", "LEVEL_LAUNCHES"),
    "chol_solve": ("chol_kernel", "LAUNCHES"),
    "ba_edge": ("ba_edge_kernel", "LAUNCHES"),
}

_LOCK = threading.Lock()


def count_launch(module_name: str, counter: str = "LAUNCHES"):
    """Add one to the launch counter `counter` of module `module_name`."""
    mod = sys.modules[module_name]
    with _LOCK:
        setattr(mod, counter, getattr(mod, counter) + 1)


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def read_counters() -> dict:
    """{kernel name: launches counted since the last reset}."""
    with _LOCK:
        return {k: getattr(_module(m), c) for k, (m, c) in COUNTERS.items()}


def reset_counters():
    with _LOCK:
        for m, c in COUNTERS.values():
            setattr(_module(m), c, 0)
