"""K4: 256-bit Hamming distances (csrc/hamming.cu), in two forms.

Port of sdslam_tpu/ops/pallas/hamming_kernel.py::hamming_matrix_pallas.
Descriptors are [N, 8] int32 holding the uint32 bit patterns (torch has
almost no uint32 arithmetic); the kernels reinterpret them as uint32.

`hamming_matrix` is the TPU kernel's contract, the [Qa, Qb] matrix (the
mutual brute-force search needs it whole). `hamming_masked_best2` is the
same distances fused with what every windowed search does to the matrix
next: a pair outside the mask counts as BIG, then each row's best, its
first index and the second best (`best2`), without the matrix. Each form
has its own launch counter (LAUNCHES, BEST2_LAUNCHES).
"""

from __future__ import annotations

import ctypes

import torch

from sdslam_tpu_torch import _device
from sdslam_tpu_torch.kernels import _build, count_launch

LAUNCHES = 0
BEST2_LAUNCHES = 0
WORDS = 8
BIG = 1 << 20


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
    count_launch(__name__)
    return out


def best2(dist):
    """Per-row best and second-best: returns (d1, j1, d2)."""
    j1 = torch.argmin(dist, dim=1)  # first minimum, as jnp.argmin
    d1 = torch.gather(dist, 1, j1[:, None])[:, 0]
    rows = torch.arange(dist.shape[0], device=dist.device)
    dist2 = dist.index_put((rows, j1), torch.full_like(d1, BIG))
    return d1, j1, torch.amin(dist2, dim=1)


def hamming_masked_best2_plain(da: torch.Tensor, db: torch.Tensor, mask: torch.Tensor):
    """best2 of the distance matrix with BIG where mask is False."""
    d = hamming_matrix_plain(da, db)
    return best2(torch.where(mask, d, torch.full_like(d, BIG)))


def hamming_masked_best2(da: torch.Tensor, db: torch.Tensor, mask: torch.Tensor):
    """[Qa,8] x [Qb,8] int32 descriptors, mask [Qa,Qb] bool -> per row
    (d1 int32, j1 int64, d2 int32): the best distance among the pairs of
    the row (a masked pair counts as BIG), its first index, and the best
    over the other indices (d2 == d1 on a tie). A row with every pair
    masked gives (BIG, 0, BIG)."""
    if not _device.use_kernel(da, db, mask):
        return hamming_masked_best2_plain(da, db, mask)
    _device.check_tensor("da", da, torch.int32, (None, WORDS))
    _device.check_tensor("db", db, torch.int32, (None, WORDS))
    na, nb = da.shape[0], db.shape[0]
    _device.check_tensor("mask", mask, torch.bool, (na, nb))
    if nb == 0:
        raise ValueError("hamming_masked_best2: no targets (argmin of an empty row)")
    # the kernel reads descriptors and the mask in aligned 16-byte words,
    # the mask's last word whole
    da, db = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (da, db))
    if mask.data_ptr() % 16 or (na * nb) % 16:
        padded = torch.zeros(-(-na * nb // 16) * 16, dtype=torch.bool, device=mask.device)
        padded[:na * nb] = mask.reshape(-1)
        mask = padded
    out = torch.empty(4 * na, dtype=torch.int32, device=da.device)
    fn = _build.bind(
        "hamming", "sd_hamming_masked_best2",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    )
    rc = fn(da.data_ptr(), db.data_ptr(), mask.data_ptr(), out.data_ptr(), na, nb,
            _device.stream_ptr(da))
    _build.check(rc, "sd_hamming_masked_best2")
    count_launch(__name__, "BEST2_LAUNCHES")
    # one buffer: d1 [na] int32, d2 [na] int32, then j1 [na] int64
    return out[:na], out[2 * na:].view(torch.int64), out[na:2 * na]
