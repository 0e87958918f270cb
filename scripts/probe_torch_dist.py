"""Probe what torch.distributed offers on a machine with CUDA cards.

    python3 scripts/probe_torch_dist.py

Prints one JSON line: the backends torch.distributed has, the card count,
and, for ranks on cuda:0 started by the port's launcher
(sdslam_tpu_torch.parallel.multihost.launch, spawn method), whether gloo
all-reduces and all-gathers CUDA tensors and whether a two-rank NCCL group
on one device fails (and with what message). A trial whose ranks fail or
hang is recorded with the launcher's error; ranks alive at its time limit
are killed.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from sdslam_tpu_torch.parallel import multihost as mh  # noqa: E402


def rank_collective(device, name: str):
    """One rank's trial: rank r contributes [r + 1] * 4 to collective `name`."""
    w, r = mh.world()
    x = torch.full((4,), float(r + 1), device=device)
    if name == "all_reduce":
        dist.all_reduce(x)
        res = x.cpu().tolist()
    elif name == "all_gather":
        parts = [torch.empty_like(x) for _ in range(w)]
        dist.all_gather(parts, x)
        res = [p.cpu().tolist() for p in parts]
    else:  # all_gather_into_tensor
        y = torch.empty(w * 4, device=device)
        dist.all_gather_into_tensor(y, x)
        res = y.cpu().tolist()
    torch.cuda.synchronize()
    return res


def trial(backend: str, name: str, world: int = 2, timeout: float = 90.0) -> dict:
    t0 = time.perf_counter()
    try:
        ranks = mh.launch(rank_collective, world, args=(name,), backend=backend,
                          devices="cuda:0", timeout=timeout)
        out = {"ok": True, "ranks": ranks}
    except RuntimeError as e:
        out = {"ok": False, "error": str(e)[-1200:]}
    return {"seconds": time.perf_counter() - t0, **out}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_dist: no CUDA device")
    out = {
        "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "device_count": torch.cuda.device_count(),
        "name": torch.cuda.get_device_name(0),
        "nccl_available": dist.is_nccl_available(), "gloo_available": dist.is_gloo_available(),
        "gloo_all_reduce_cuda": trial("gloo", "all_reduce"),
        "gloo_all_gather_cuda": trial("gloo", "all_gather"),
        "gloo_all_gather_into_tensor_cuda": trial("gloo", "all_gather_into_tensor"),
        "gloo_all_reduce_cuda_world4": trial("gloo", "all_reduce", world=4),
        "nccl_two_ranks_one_device": trial("nccl", "all_reduce", timeout=60.0),
        "nccl_world1": trial("nccl", "all_reduce", world=1),
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
