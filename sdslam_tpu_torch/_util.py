"""Deterministic scatter / selection helpers shared by the port.

The JAX package leans on three XLA behaviours that PyTorch does not give
for free:

  * `.at[idx].set(v, mode="drop")` drops out-of-range indices (callers use
    the pool size as a "no write" sentinel) and, on duplicate indices,
    keeps the LAST update (XLA:CPU applies updates in order). CUDA
    `index_put_` with duplicates is arbitrary, so `scatter_set` resolves
    duplicates explicitly: the update with the highest position wins.
  * `jax.lax.top_k` returns the lower index first among equal values;
    `torch.topk` promises no order, so `topk_stable` sorts stably.
  * Boolean masking would need a device->host sync on CUDA; every helper
    here keeps static shapes (sentinel rows instead of filtering).

A tensor built from host data (`torch.tensor(3.0, device="cuda")`) is a
host->device copy, which synchronizes the stream; `as_device` turns Python
scalars into fills instead.
"""

from __future__ import annotations

import torch


def as_device(v, dtype, device) -> torch.Tensor:
    """v as a tensor of dtype on device. A Python scalar becomes a fill
    kernel, not a host->device copy (which would synchronize the stream)."""
    if isinstance(v, (bool, int, float)):
        return torch.full((), v, dtype=dtype, device=device)
    return torch.as_tensor(v, dtype=dtype, device=device)


def topk_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis; ties keep
    the lower index first (jax.lax.top_k semantics)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def scatter_set(dst: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """Out-of-place dst.at[idx].set(val, mode="drop") along axis 0.

    idx: integer tensor of any shape; entries outside [0, len(dst)) are
    dropped. val: broadcastable to idx.shape + dst.shape[1:]. Duplicate
    indices: the last update (in flattened idx order) wins."""
    n = dst.shape[0]
    flat = idx.reshape(-1).long()
    m = flat.shape[0]
    val = as_device(val, dst.dtype, dst.device)
    val = torch.broadcast_to(val, tuple(idx.shape) + tuple(dst.shape[1:]))
    val = val.reshape((m,) + tuple(dst.shape[1:]))
    ok = (flat >= 0) & (flat < n)
    tgt = torch.where(ok, flat, n)
    pos = torch.arange(m, device=dst.device)
    win = torch.full((n + 1,), -1, dtype=torch.long, device=dst.device)
    win = win.scatter_reduce(0, tgt, pos, reduce="amax", include_self=True)[:n]
    has = win >= 0
    picked = val[win.clamp(min=0)] if m > 0 else dst
    has = has.reshape((n,) + (1,) * (dst.dim() - 1))
    return torch.where(has, picked, dst)


def scatter_set2(dst: torch.Tensor, i: torch.Tensor, j: torch.Tensor, val) -> torch.Tensor:
    """Out-of-place dst.at[i, j].set(val, mode="drop") for a 2-D (or more)
    dst, dropping entries where i or j is out of range; last update wins."""
    n0, n1 = dst.shape[0], dst.shape[1]
    i = i.long()
    j = j.long()
    ok = (i >= 0) & (i < n0) & (j >= 0) & (j < n1)
    lin = torch.where(ok, i * n1 + j, n0 * n1)
    flat = dst.reshape((n0 * n1,) + tuple(dst.shape[2:]))
    out = scatter_set(flat, lin, val)
    return out.reshape(dst.shape)


def scatter_min(dst: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """Out-of-place dst.at[idx].min(val, mode="drop") along a 1-D dst."""
    n = dst.shape[0]
    flat = idx.reshape(-1).long()
    val = torch.broadcast_to(as_device(val, dst.dtype, dst.device), idx.shape).reshape(-1)
    tgt = torch.where((flat >= 0) & (flat < n), flat, n)
    ext = torch.cat([dst, dst[:1]])
    return ext.scatter_reduce(0, tgt, val, reduce="amin", include_self=True)[:n]


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without a device->host sync."""
    return x.index_select(0, i.reshape(1).long()).squeeze(0)


def put(x: torch.Tensor, i: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Out-of-place x.at[i].set(v) for a 0-d index tensor, sync-free."""
    return x.index_copy(0, i.reshape(1).long(), v.unsqueeze(0).to(x.dtype))
