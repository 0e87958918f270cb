"""The least time the card could take for a hand-written kernel's launch,
counted from the launch's arguments.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM and 67 TFLOP/s of
float32 outside the tensor cores (integer and float operations alike, so
the bound stays a lower bound). The per-unit operation counts are a frozen
copy of `chip_smoke.py`'s (counted from the kernels' sources). Bytes: each
input read once and each output written once. Operations: the work the
inputs need at the least, one evaluation per point or edge where the kernel
iterates until it converges, so the share is a lower bound of the true one
and cannot pass 100% through this counting.

`LaunchRecorder` wraps the kernels' entry points (module attributes the
program calls them through) while a traced block runs, keeps each
launch's arguments and outputs, and counts them afterwards, so the count
is the same whatever implements the kernel.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
PROJ_FLOP = 25  # transform (18) + perspective division and intrinsics (7)
POSE_EDGE_FLOP = 230  # residual + 3x6 Jacobian + robust weight + H (126) + b (36)
POSE_RESID_FLOP = 40  # the residual-only pass closing each round
BA_EDGE_FLOP = 450  # Jc/Jp, W, Hcc, bc, Hpp, bp and the V.ybp terms of one edge
BA_POINT_FLOP = 150  # 3x3 damped Cholesky inverse, ybp and Ze per point
HAMMING_OPS_PER_WORD = 3  # xor, popcount, add
BA_EDGE_TERMS_FLOP = 460  # projection, residual, Huber, Jc/Jp and the 55 outputs of one edge


def chol_flop(N: int) -> float:
    """Factor (N^3 / 3) and the two triangular solves (2 N^2 each)."""
    return N**3 / 3.0 + 4.0 * N**2


def bound_s(n_bytes: float, n_ops: float) -> float:
    """Seconds: the larger of bytes over the memory rate and operations over
    the float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / SCALAR_OPS_PER_S)


def nbytes(*objs) -> int:
    """Bytes of every tensor in `objs` (nested tuples and lists walked)."""
    n = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            n += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            n += nbytes(*o)
    return n


# --- per kernel: (bytes, operations) of one launch from (args, kwargs, out) ---

def _align_level(a, kw, out):
    img, X, _, _, okpx, Hinv, T_init = a[:7]
    return nbytes(img, X, okpx, Hinv, T_init, out), X.shape[0] * PROJ_FLOP


def _pose_gn(a, kw, out):
    edata, T_init, T_prior_inv, prior_info = a[:4]
    rounds = kw.get("rounds", a[9] if len(a) > 9 else 4)
    iters = kw.get("iters", a[10] if len(a) > 10 else 10)
    N = edata.shape[0]
    return (nbytes(edata, T_init, T_prior_inv, prior_info, out),
            N * (rounds * iters * POSE_EDGE_FLOP + (rounds + 1) * POSE_RESID_FLOP))


def _ba_schur(a, kw, out):
    packed = a[0]
    Mo, P = packed.shape[1], packed.shape[2]
    return nbytes(packed, out), Mo * P * BA_EDGE_FLOP + P * BA_POINT_FLOP


def _hamming(a, kw, out):
    da, db = a[:2]
    return nbytes(da, db, out), da.shape[0] * db.shape[0] * 8 * HAMMING_OPS_PER_WORD


def _hamming_best2(a, kw, out):
    da, db, mask = a[:3]
    return nbytes(da, db, mask, out), int(mask.sum()) * 8 * HAMMING_OPS_PER_WORD


def _accumulate_gn(a, kw, out):
    img, Xc, _, _, okpx = a[:5]
    B, N = Xc.shape[:2]
    return nbytes(img, Xc, okpx, out), B * N * PROJ_FLOP


def _align_batched(a, kw, out):
    img, X, _, _, okpx, L, T0 = a[:7]
    B, N = X.shape[:2]
    return nbytes(img, X, okpx, L, T0, out), B * N * PROJ_FLOP


def _chol(a, kw, out):
    S, b = a[:2]
    return nbytes(S, b, out), chol_flop(S.shape[-1])


def _ba_edge(a, kw, out):
    packed = a[0]
    return nbytes(packed, out), packed.shape[-1] * BA_EDGE_TERMS_FLOP


# entry point (module of sdslam_tpu_torch.kernels, attribute) -> (counter,
# substring of the CUDA kernel's name in a device trace)
KERNELS: Dict[Tuple[str, str], Tuple] = {
    ("align_kernel", "align_level"): (_align_level, "align_level_kernel"),
    ("pose_kernel", "pose_optimize"): (_pose_gn, "pose_gn_kernel"),
    ("ba_schur_kernel", "ba_edge_schur"): (_ba_schur, "ba_schur_kernel"),
    ("hamming_kernel", "hamming_matrix"): (_hamming, "hamming_kernel"),
    ("hamming_kernel", "hamming_masked_best2"): (_hamming_best2, "hamming_best2_kernel"),
    ("accumulate_gn_kernel", "accumulate_gn"): (_accumulate_gn, "accumulate_gn"),
    ("accumulate_gn_kernel", "align_level_batched"): (_align_batched, "align_level_kernel"),
    ("chol_kernel", "chol_solve_dense"): (_chol, "chol_solve_kernel"),
    ("ba_edge_kernel", "ba_edge_terms"): (_ba_edge, "ba_edge_kernel"),
}
KERNEL_NAMES = sorted({name for _, name in KERNELS.values()})


def is_hand_written(kernel_name: str) -> bool:
    """A device trace's kernel event of one of the hand-written kernels.
    `hamming_kernel` is matched whole-word so the fused form's name does not
    count twice."""
    base = kernel_name.split("(")[0].split("<")[0].strip().split(" ")[-1]
    return any(base == n or base.endswith("::" + n) or base.startswith(n)
               for n in KERNEL_NAMES)


class LaunchRecorder:
    """While active, each call of a kernel entry point is recorded with its
    arguments and outputs (references only: no copy, no sync)."""

    PACKAGE = "sdslam_tpu_torch.kernels"

    def __init__(self):
        self.calls: List[Tuple] = []
        self._saved = []

    def __enter__(self):
        for (mod_name, attr), (counter, _) in KERNELS.items():
            mod = importlib.import_module(f"{self.PACKAGE}.{mod_name}")
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, counter))
        return self

    def _wrap(self, fn, counter):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
                self.calls.append((counter, a, kw, out))
            return out

        return wrapped

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def bound_seconds(self) -> float:
        """Sum of the recorded launches' bounds."""
        return sum(bound_s(*counter(a, kw, out)) for counter, a, kw, out in self.calls)
