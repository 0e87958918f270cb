"""Kernel gate: decides, from where the tensors lie, whether a wrapper runs
its CUDA kernel or its plain PyTorch version.

CPU tensors take the plain version (the CPU tests and the parity oracle).
CUDA tensors take the kernel, and only on a card of compute capability
>= 9.0 (the kernels are built for sm_90a); anything else raises. There is
no fallback from a CUDA tensor to the plain version.
"""

from __future__ import annotations

import torch

MIN_CAPABILITY = (9, 0)
_CAPABLE = set()  # indices of the CUDA devices found capable (asked once each)


def resolve(device) -> torch.device:
    """The device an entry point runs on. The entry points default to
    "cuda"; on a machine without a card that raises instead of silently
    running the plain versions on the CPU (pass device="cpu" for those)."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(d)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return d


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a Hopper-class CUDA device, False when
    every tensor is on the CPU; raises on mixed or unsupported devices."""
    if all(t.is_cuda for t in tensors):
        idx = {t.get_device() for t in tensors}
        if len(idx) != 1:
            raise ValueError(f"tensors on several CUDA devices: {sorted(idx)}")
        (i,) = idx
        if i not in _CAPABLE:
            cap = torch.cuda.get_device_capability(i)
            if cap < MIN_CAPABILITY:
                raise RuntimeError(
                    f"CUDA kernels need compute capability >= {MIN_CAPABILITY}, "
                    f"device has {cap}"
                )
            _CAPABLE.add(i)
        return True
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    raise ValueError(f"tensors on unsupported/mixed devices: {sorted(types)}")


def stream_ptr(t: torch.Tensor) -> int:
    """Raw cudaStream_t of the current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensor(name: str, t: torch.Tensor, dtype, shape=None):
    """Raise unless t has the dtype, shape (None entries are free) and is
    contiguous — what a raw-pointer kernel can take."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    # a shape without free entries compares whole (the common, fast case)
    if shape is not None and t.shape != shape and (
        t.dim() != len(shape)
        or any(s is not None and s != d for s, d in zip(shape, t.shape))
    ):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous tensor")
