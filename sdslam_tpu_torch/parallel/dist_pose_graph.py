"""Distributed Sim(3) pose-graph optimization over the ranks of a process
group (port of sdslam_tpu/parallel/dist_pose_graph.py).

Edges are split over the ranks; each rank assembles the normal equations
of its edges (solvers/pose_graph.py `edge_system`), one all-reduce sums
the dense [7K, 7K] system and gradient, and the damped solve and pose
update are replicated (`solve_and_update`). Communication per GN
iteration: (7K)^2 + 7K floats, independent of the edge count.
"""

from __future__ import annotations

import numpy as np
import torch

from sdslam_tpu_torch.parallel import multihost as mh
from sdslam_tpu_torch.solvers import pose_graph as pg


def _pad_edges(edges: pg.PoseGraphEdges, n_shards: int) -> pg.PoseGraphEdges:
    """Pad the edge arrays to a multiple of the shard count with weight-0
    edges (the weight scales the one-hot assembly, so a padding edge adds
    exactly zero to H and b)."""
    E = edges.i.shape[0]
    pad = (-E) % n_shards
    if pad == 0:
        return edges
    dev = edges.i.device
    return pg.PoseGraphEdges(
        i=torch.cat([edges.i, torch.zeros(pad, dtype=edges.i.dtype, device=dev)]),
        j=torch.cat([edges.j, torch.zeros(pad, dtype=edges.j.dtype, device=dev)]),
        S_ij=torch.cat([edges.S_ij, torch.eye(4, dtype=edges.S_ij.dtype,
                                              device=dev).expand(pad, 4, 4)]),
        weight=torch.cat([edges.weight, torch.zeros(pad, dtype=edges.weight.dtype,
                                                    device=dev)]),
    )


def distributed_pose_graph(kf_Ssw, kf_valid, fixed_mask, edges: pg.PoseGraphEdges,
                           iters: int = 20, fix_scale: bool = False, lm_lambda: float = 1e-6,
                           group=None):
    """optimize_pose_graph with the edges split over the ranks (the same
    result up to the order of the float sums). Every rank passes the whole
    graph; poses and masks are replicated."""
    K = kf_Ssw.shape[0]
    w, _ = mh.world(group)
    padded = _pad_edges(edges, w)
    local = pg.PoseGraphEdges(*(mh.global_put(x, mh.SHARDED, x.device, group) for x in padded))
    S = kf_Ssw
    for _ in range(iters):
        H, b = pg.edge_system(S, local, K, fix_scale)
        H = mh.all_reduce_sum(H, group)
        b = mh.all_reduce_sum(b, group)
        S = pg.solve_and_update(S, H, b, kf_valid, fixed_mask, fix_scale, lm_lambda)
    return S


def rank_pose_graph(device, kf_Ssw, kf_valid, fixed_mask, edges, iters: int = 20):
    """One rank of `distributed_pose_graph` on numpy inputs (`edges` as the
    tuple (i, j, S_ij, weight)); returns {"S", "ms", "launches"}."""
    t = [torch.as_tensor(np.asarray(a), device=device) for a in (kf_Ssw, kf_valid, fixed_mask)]
    e = pg.PoseGraphEdges(*(torch.as_tensor(np.asarray(a), device=device) for a in edges))
    S, stats = mh.measure(device, lambda: distributed_pose_graph(
        *t, e, iters=iters, group=mh.global_mesh()))
    return {"S": mh.fetch_replicated(S), **stats}
