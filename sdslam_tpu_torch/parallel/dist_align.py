"""Distributed global alignment scan: relocalization and loop detection
with the keyframe pool split over the ranks of a process group (port of
sdslam_tpu/parallel/dist_align.py).

Each rank holds K/world keyframe slots (poses, stored pyramids,
keypoints) and aligns the replicated query pyramid against all of them at
once with the batched aligner relocalization uses
(pipeline/relocalization.py `align_pool`: kernel K5's batched level on
the card, one launch per pyramid level). The per-slot errors [K] and
relative poses [K,4,4] are gathered in slot order; the caller takes the
winner. Verification of the best candidates stays on one device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sdslam_tpu_torch.geometry.camera import CameraModel
from sdslam_tpu_torch.mapping import map_state as M
from sdslam_tpu_torch.parallel import multihost as mh
from sdslam_tpu_torch.pipeline.relocalization import align_pool


def _keyframe_shard(ms: M.MapState, rows: slice) -> M.MapState:
    """ms with every keyframe-pool field cut to `rows` (the point pool
    stays whole)."""
    kw = {f: getattr(ms, f)[rows] for f in ms._fields
          if f.startswith("kf_") and f != "kf_pyramid"}
    return ms._replace(kf_pyramid=tuple(p[rows] for p in ms.kf_pyramid), **kw)


def distributed_align_scan(cam: CameraModel, ms: M.MapState, pyr_cur: Tuple[torch.Tensor, ...],
                           scale_factor: float = 2.0, n_levels: int = 5,
                           store_min_level: int = 2, min_level: int | None = None,
                           iters: int = 15, group=None):
    """Photometric alignment of the query frame against every keyframe
    slot, the slots split over the ranks. Returns (T_rels [K,4,4], errors
    [K]) in slot order on every rank. A slot with < 50 alignable pixels,
    or an invalid slot, gets an infinite error. K must divide the world."""
    if min_level is None:
        min_level = n_levels - 2
    w, _ = mh.world(group)
    if ms.K % w:
        raise ValueError(f"keyframe pool of {ms.K} slots must divide the world of {w}")
    shard = _keyframe_shard(ms, mh.shard_rows(ms.K, group))
    T_rels, errors = align_pool(cam, shard, tuple(pyr_cur[store_min_level:]),
                                max_level=n_levels - 1, min_level=min_level,
                                scale_factor=scale_factor, store_min_level=store_min_level,
                                iters=iters)
    errors = torch.where(shard.kf_valid, errors, torch.full_like(errors, float("inf")))
    return mh.gather_rows(T_rels, group), mh.gather_rows(errors, group)


def rank_align_scan(device, cam: CameraModel, ms_np: dict, pyr_cur, kwargs: dict):
    """One rank of `distributed_align_scan` on a map given as numpy
    (interop.map_state_to_numpy) and a query pyramid (a list of numpy
    levels); returns {"T", "errors", "ms", "launches"}."""
    from sdslam_tpu_torch import interop

    ms = interop.map_state_from_numpy(ms_np, device)
    pyr = tuple(torch.as_tensor(np.asarray(p), device=device) for p in pyr_cur)
    (T, err), stats = mh.measure(device, lambda: distributed_align_scan(
        cam, ms, pyr, group=mh.global_mesh(), **kwargs))
    return {"T": mh.fetch_replicated(T), "errors": mh.fetch_replicated(err), **stats}
