"""K4: 256-bit Hamming distance matrix (csrc/hamming.cu).

Port of sdslam_tpu/ops/pallas/hamming_kernel.py::hamming_matrix_pallas.
Descriptors are [N, 8] int32 holding the uint32 bit patterns (torch has
almost no uint32 arithmetic); the kernel reinterprets them as uint32.
"""

from __future__ import annotations

import ctypes

import torch

from sdslam_tpu_torch import _device
from sdslam_tpu_torch.kernels import _build

LAUNCHES = 0
WORDS = 8


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int32 bit patterns. Each mask drops the bits that
    the arithmetic right shift copies in from the sign."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_matrix_plain(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """[Qa,8] x [Qb,8] int32 -> [Qa,Qb] int32 (XOR + popcount, word by
    word so the temporaries stay [Qa,Qb])."""
    out = torch.zeros((da.shape[0], db.shape[0]), dtype=torch.int32, device=da.device)
    for w in range(WORDS):
        out += _popcount32(da[:, None, w] ^ db[None, :, w])
    return out


def hamming_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """[Qa,8] x [Qb,8] int32 descriptors -> [Qa,Qb] int32 distances."""
    if not _device.use_kernel(da, db):
        return hamming_matrix_plain(da, db)
    _device.check_tensor("da", da, torch.int32, (None, WORDS))
    _device.check_tensor("db", db, torch.int32, (None, WORDS))
    na, nb = da.shape[0], db.shape[0]
    out = torch.empty((na, nb), dtype=torch.int32, device=da.device)
    fn = _build.bind(
        "hamming", "sd_hamming",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    )
    rc = fn(da.data_ptr(), db.data_ptr(), out.data_ptr(), na, nb, _device.stream_ptr(da))
    _build.check(rc, "sd_hamming")
    global LAUNCHES
    LAUNCHES += 1
    return out
