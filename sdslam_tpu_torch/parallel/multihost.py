"""Process groups, sharded placement and the rank launcher of the port's
distributed solvers (port of sdslam_tpu/parallel/multihost.py to
torch.distributed).

The JAX package builds one global mesh over every device of every process
and places host arrays into it; its solvers are shard_map programs whose
`psum("dp")` combines the shards. Here each rank is a process in a
torch.distributed group: `global_put` takes this rank's rows of a host
array (or all of it, replicated), the solvers combine their shards with
`all_reduce(SUM)`, and a result that `all_reduce` left identical on every
rank is read on any of them (`fetch_replicated`).

The backend is always the caller's choice: "nccl" needs one card per rank
and refuses two ranks on one card ("Duplicate GPU detected"); "gloo" runs
ranks on the CPU, and on CUDA tensors it all-reduces and all-gathers
(staging through the host), several ranks on one card included. Both are
what a probe on an H100 machine found (scripts/probe_torch_dist.py).
`gather_rows` assembles a row-sharded result with one all-gather.

`launch` spawns the ranks of one group on this machine (the part
scripts/multihost_worker.py plays for the JAX package) and returns each
rank's result to the caller. The function a rank runs must be importable
from the port: a spawned child imports it by name.
"""

from __future__ import annotations

import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from sdslam_tpu_torch import _device, kernels

SHARDED = "dp"  # spec of an array whose leading axis is split over the ranks
REPLICATED = None


def init_multihost(init_method: str, world_size: int, rank: int, backend: str):
    """Join the process group of `world_size` ranks at `init_method`
    ("tcp://host:port") as `rank`, over `backend` ("nccl" or "gloo").
    Returns the group (the default group)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return dist.group.WORLD


def global_mesh():
    """The group every rank of this job belongs to (the JAX package's one
    mesh over all devices); None outside a process group, where the
    solvers run as a world of one."""
    return dist.group.WORLD if dist.is_initialized() else None


def world(group=None) -> Tuple[int, int]:
    """(world size, this rank) of `group`; (1, 0) outside a process group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def shard_rows(n: int, group=None) -> slice:
    """The rows of an n-row array this rank holds; n must divide the world."""
    w, r = world(group)
    if n % w:
        raise ValueError(f"{n} rows do not divide a world of {w}")
    return slice(r * (n // w), (r + 1) * (n // w))


def global_put(arr, spec, device="cuda", group=None) -> torch.Tensor:
    """This rank's part of a host array (numpy or tensor) on `device`: the
    rows `shard_rows` names for spec SHARDED, the whole array for
    REPLICATED. Every rank passes the same full array."""
    t = torch.as_tensor(np.asarray(arr)) if not isinstance(arr, torch.Tensor) else arr
    if spec == SHARDED:
        t = t[shard_rows(t.shape[0], group)]
    elif spec is not REPLICATED:
        raise ValueError(f"spec {spec!r}: expected {SHARDED!r} or None")
    return t.to(_device.resolve(device))


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of x over the ranks (x itself outside a group). The collectives
    take contiguous tensors only."""
    if dist.is_initialized():
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def gather_rows(local: torch.Tensor, group=None) -> torch.Tensor:
    """The full array whose equal row shards (`shard_rows`) the ranks hold,
    in rank order, on every rank (local itself outside a group)."""
    if not dist.is_initialized():
        return local
    parts = [torch.empty_like(local) for _ in range(world(group)[0])]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts)


def fetch_replicated(x: torch.Tensor) -> np.ndarray:
    """Host value of a tensor every rank holds the same of."""
    return x.detach().cpu().numpy()


def synchronize(device):
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    d = torch.device(device)
    if d.type == "cuda":
        torch.cuda.synchronize(d)


def measure(device, fn: Callable[[], Any]):
    """(fn(), {"ms": wall time of the call, "launches": kernel launches in
    it}) in this rank."""
    synchronize(device)
    kernels.reset_counters()
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3
    return out, {"ms": ms, "launches": kernels.read_counters()}


# -- the launcher ---------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, port, backend, device, threads, inbox, out):
    """Body of one spawned rank: take (fn, args) from the inbox, join the
    group, run fn(device, *args) and put (rank, ok, result or traceback)
    on the outbox."""
    try:
        fn, args = inbox.get()
        torch.set_num_threads(threads)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        init_multihost(f"tcp://127.0.0.1:{port}", world_size, rank, backend)
        try:
            res = fn(device, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:  # noqa: BLE001 (reported to the parent, which raises)
        out.put((rank, False, traceback.format_exc()))


def launch(fn: Callable, world_size: int, args: Sequence = (), *, backend: str,
           devices: Union[str, Sequence[str]], threads: int = 1,
           timeout: float = 600.0) -> List[Any]:
    """Run fn(device, *args) in `world_size` spawned ranks of one process
    group over `backend` ("nccl" or "gloo"); returns [result of rank 0,
    rank 1, ...].

    `devices` is one device for every rank ("cuda:0", "cpu") or one per
    rank. Neither has a default: the caller names both. Each rank uses
    `threads` intra-op threads, so ranks started from several test
    workers do not oversubscribe the host. fn, args and the
    results cross process boundaries by pickling (numpy arrays and plain
    values); the work goes through a queue after the ranks started, so a
    rank that dies while it starts cannot block the caller. A rank that
    fails, or a group that does not finish within `timeout` seconds,
    raises RuntimeError; ranks still alive then are killed."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    devs = [devices] * world_size if isinstance(devices, str) else list(devices)
    devs = [str(_device.resolve(d)) for d in devs]
    if len(devs) != world_size:
        raise ValueError(f"{len(devs)} devices for {world_size} ranks")
    if any(torch.device(d).type == "cuda" for d in devs):
        # the ranks load the kernels; build them once here, not in each rank
        from sdslam_tpu_torch.kernels import _build

        _build.build()
    ctx = torch.multiprocessing.get_context("spawn")
    inbox, out = ctx.Queue(), ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, port, backend, devs[r], threads, inbox, out))
             for r in range(world_size)]
    got = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        for _ in procs:
            inbox.put((fn, tuple(args)))
        # drain the outbox before joining: a child blocks until its result is read
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, res = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break
                continue
            got[rank] = (ok, res)
    finally:
        inbox.cancel_join_thread()  # unread work must not block this process's exit
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    failed = {r: res for r, (ok, res) in got.items() if not ok}
    if failed:
        raise RuntimeError("ranks failed:\n" + "\n".join(f"--- rank {r}\n{tb}"
                                                          for r, tb in sorted(failed.items())))
    if len(got) < world_size:
        missing = sorted(set(range(world_size)) - set(got))
        codes = [p.exitcode for p in procs]
        raise RuntimeError(f"ranks {missing} returned nothing within {timeout:.0f} s "
                           f"(exit codes {codes})")
    return [got[r][1] for r in range(world_size)]


def run_calls(device, calls: Sequence[Tuple[Callable, tuple]]) -> list:
    """Rank body that runs several (fn, args) in order, each as fn(device,
    *args), in one group: one spawn for several solves (a call listed
    twice runs twice, the first time as a warm-up)."""
    return [fn(device, *args) for fn, args in calls]


def rank_layout(device, arr):
    """One rank's view of an array placed by `global_put` and read back:
    {"world", "rank", "sharded", "replicated", "gathered"} as numpy."""
    w, r = world()
    sharded = global_put(arr, SHARDED, device)
    return {"world": w, "rank": r, "sharded": fetch_replicated(sharded),
            "replicated": fetch_replicated(global_put(arr, REPLICATED, device)),
            "gathered": fetch_replicated(gather_rows(sharded))}
