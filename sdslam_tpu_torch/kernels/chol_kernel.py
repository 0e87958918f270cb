"""K6: dense SPD Cholesky factor + solve, x = S^-1 b (csrc/chol_solve.cu).

Port of sdslam_tpu/ops/pallas/chol_kernel.py::chol_solve_dense. The JAX
package keeps the library solve in production; the port solves the reduced
camera system of local BA ([144, 144] at 24 local keyframes) with this
kernel whenever 6K <= N_MAX (solvers/ba.py::_apply_prior_and_solve).

N_MAX is the port's own bound, not the Pallas kernel's 384: the kernel
keeps the whole S in one block's shared memory (N rows at an odd stride,
N*(N|1) + 2N floats: 218,080 bytes at 232), and an H100 block gets at
most 232,448 bytes, so N <= 232 (CS_N_MAX in the source). The kernel is a
blocked right-looking factorization in panels of 16 columns with blocked
substitutions (csrc/chol_solve.cu). Larger systems (global
BA at 256 slots is [1536, 1536]) keep the library factor and solve, as the
JAX package's gate does beyond its N_MAX. The gate reads shapes only.
"""

from __future__ import annotations

import ctypes

import torch

from sdslam_tpu_torch import _device
from sdslam_tpu_torch.kernels import _build, count_launch

LAUNCHES = 0
N_MAX = 232


def chol_solve_dense_plain(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = S^-1 b by the library factor and solve (torch.linalg): K6's
    plain version, and the solve solvers/ba.py keeps above N_MAX."""
    L, _ = torch.linalg.cholesky_ex(S)
    return torch.cholesky_solve(b.reshape(-1, 1), L).reshape(-1)


def chol_solve_dense(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = S^-1 b for SPD S [N, N] f32 and b [N] f32, N <= N_MAX. Each
    pivot is clamped at 1e-20 (LM damping keeps S SPD on the BA path)."""
    if not _device.use_kernel(S, b):
        return chol_solve_dense_plain(S, b)
    N = S.shape[0]
    if N > N_MAX:
        raise ValueError(f"chol_solve_dense: N = {N} > N_MAX = {N_MAX} (gate on N_MAX)")
    _device.check_tensor("S", S, torch.float32, (N, N))
    _device.check_tensor("b", b, torch.float32, (N,))
    x = torch.empty(N, dtype=torch.float32, device=S.device)
    vp = ctypes.c_void_p
    fn = _build.bind("chol_solve", "sd_chol_solve", [vp, vp, vp, ctypes.c_int, vp])
    rc = fn(S.data_ptr(), b.data_ptr(), x.data_ptr(), N, _device.stream_ptr(S))
    _build.check(rc, "sd_chol_solve")
    count_launch(__name__)
    return x

