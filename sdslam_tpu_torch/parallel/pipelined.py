"""Tracking-vs-mapping pipelining: the keyframe mapping pass off the
tracking loop (port of sdslam_tpu/parallel/pipelined.py).

The reference runs Tracking on the caller's thread and LocalMapping on its
own, sharing the map under a mutex. The JAX package turns the thread split
into a device split: device T runs the per-frame tracking program against
an immutable map snapshot, device M runs the keyframe mapping pass on its
own snapshot, and the refreshed map is swapped in when the pass ends. The
port's map updates are functional too (a MapState is never modified in
place), so the current map already is a snapshot. On one card:

  * tracking runs on the caller's thread and the card's current stream;
  * the mapping pass (`_kf_core`: fuse, local BA, spawn, triangulate, cull,
    statistics) runs on a second CUDA stream, issued from one worker
    thread, at most one pass in flight. Its host reads (the culling gate,
    the new slot) synchronize the map stream only. With two cards it runs
    on cuda:1; on the CPU (the tests) the thread alone separates it;
  * the swap makes the tracking stream wait on the pass's end event before
    the new map is read, and marks the new map's tensors (allocated on the
    map stream) as used by the tracking stream, so the caching allocator
    does not hand their memory to the next pass while tracking reads it.
    The pass's inputs (the old snapshot, the frame's tensors) stay
    referenced until the swap, after which new tracking work is ordered
    behind the pass.

Staleness follows the reference: between a keyframe's decision and the end
of its mapping pass, tracking runs on the pre-keyframe map. A keyframe
decided while a pass is running is skipped (the next decayed frame decides
again), as the JAX tracker skips it.

Host syncs are counted per thread: `host_syncs` on the tracking thread,
`map_syncs` on the worker. Kernel launch counters are shared and count
under a lock (kernels/__init__.py).
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sdslam_tpu_torch import _device
from sdslam_tpu_torch.mapping import map_state as M
from sdslam_tpu_torch.pipeline.tracking import (
    KF_STORE_MIN_LEVEL, PACK_NEED_KF, PACK_POSE, KeyframeOutcome, RGBDTracker, _kf_core,
)
from sdslam_tpu_torch.utils.config import SystemConfig
from sdslam_tpu_torch.utils.profiling import frame_span, span


def _map_to(ms: M.MapState, device) -> M.MapState:
    return M.MapState(*(tuple(p.to(device) for p in v) if isinstance(v, tuple) else v.to(device)
                        for v in ms))


def _map_tensors(ms: M.MapState):
    for v in ms:
        yield from (v if isinstance(v, tuple) else (v,))


class PipelinedRGBDTracker(RGBDTracker):
    """RGB-D tracker whose keyframe mapping pass runs beside the tracking
    loop. API-compatible with RGBDTracker (track / flush / trajectory),
    except `track_batch`.

    The tracking step is RGBDTracker's step without the inline mapping
    pass: the keyframe decision stays on the device and is packed with the
    frame's result (slot -1). When a result with the decision drains, the
    frame's retained tensors go to the mapping pass, and the refreshed map
    is swapped in by `_poll_map_job`.
    """

    def __init__(self, cfg: SystemConfig, device="cuda", map_device=None):
        super().__init__(cfg, device=device)
        self.track_device = self.device
        if map_device is None:
            two = self.device.type == "cuda" and torch.cuda.device_count() > 1
            map_device = torch.device("cuda", 1) if two else self.device
        self.map_device = _device.resolve(map_device)
        self.map_stream = (torch.cuda.Stream(self.map_device)
                           if self.map_device.type == "cuda" else None)
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="sdslam-map")
        # in-flight mapping pass: (future -> (ms, slot, end event), its inputs)
        self._map_job: Optional[Tuple[Future, tuple]] = None
        # per trajectory index: the frame's tensors, until its result drains
        self._retained: Dict[int, tuple] = {}
        self.map_syncs = 0  # host syncs on the mapping worker thread
        self.kf_dispatched = 0
        self.kf_skipped = 0

    # -- tracking thread -------------------------------------------------------

    def _keyframe(self, ms, need_kf_d, n_inl, out, feats, pyramid, d, uright, ts):
        """Decision only: left on the device and packed with slot -1 (a
        deferred keyframe has no slot until its mapping pass ends); the
        frame's tensors are kept for the mapping pass its drained result
        may start."""
        self._retained[len(self.trajectory)] = (feats, pyramid, d, uright, ts, out.assoc)
        dst = self.dst
        need = need_kf_d & self.mapping_enabled
        fskf = dst.frames_since_kf
        return KeyframeOutcome(
            ms, out.Tcw, False, dst.last_kf_slot,
            torch.where(need, torch.zeros_like(fskf), fskf + 1),
            torch.where(need, n_inl.to(torch.int32), dst.ref_kf_inliers), need.to(torch.float32),
            torch.full((), -1.0, device=self.device))

    def _apply_packed_row(self, idx, p):
        need_kf = bool(p[PACK_NEED_KF])
        row = p.copy()
        row[PACK_NEED_KF] = 0.0  # the slot and the keyframe event come with the swap
        super()._apply_packed_row(idx, row)
        if need_kf and self.mapping_enabled:
            self._dispatch_kf(idx, row[PACK_POSE].reshape(4, 4))
        self._retained.pop(idx, None)

    def _dispatch_kf(self, idx: int, pose: np.ndarray):
        """Start the mapping pass for retained frame `idx` on the worker."""
        if idx not in self._retained:
            return
        # one pass in flight (the reference's LocalMapping also takes one
        # keyframe at a time): a keyframe decided while one runs is skipped
        if self._map_job is not None:
            self._poll_map_job()
            if self._map_job is not None:
                self.kf_skipped += 1
                return
        feats, pyramid, d, uright, ts, assoc = self._retained[idx]
        inputs = (self.ms, pose, feats, tuple(pyramid[KF_STORE_MIN_LEVEL:]), d, uright, assoc,
                  idx, ts, self.st.last_kf_slot)
        ready = None
        if self.device.type == "cuda":
            # everything the pass reads was enqueued on the tracking stream
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        self._map_job = (self._pool.submit(self._map_pass, ready, *inputs), inputs)
        self.kf_dispatched += 1

    def _poll_map_job(self, block: bool = False):
        """Swap the refreshed map in if the mapping pass ended (or wait
        for it with block=True)."""
        if self._map_job is None:
            return
        future, _inputs = self._map_job
        if not block and not future.done():
            return
        ms_new, slot, done = future.result()
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in _map_tensors(ms_new):
                t.record_stream(stream)
        self.ms = ms_new
        if self.dst is not None:
            self.dst = self.dst._replace(
                last_kf_slot=torch.full((), slot, dtype=torch.int32, device=self.device))
        self.st.last_kf_slot = slot
        self.kf_events.append(slot)
        self._map_job = None  # frees the inputs: tracking work is now ordered after the pass

    def track(self, img, depth_img, timestamp: float):
        with frame_span(len(self.trajectory)):
            # a LOST tracker relocalizes against the newest map
            self._poll_map_job(block=self.st.status == "LOST")
            return super().track(img, depth_img, timestamp)

    def track_batch(self, items, uploaded=None):
        raise NotImplementedError(
            "PipelinedRGBDTracker has no batched step: the JAX tracker's inherited track_batch "
            "scans the packed step core (_step_packed_core), which its tracking-only step "
            "does not define, so it cannot run there either; call track() per frame")

    def flush(self):
        super().flush()
        self._poll_map_job(block=True)

    # -- mapping worker thread ----------------------------------------------------

    def _map_sync(self, flag: torch.Tensor) -> bool:
        """A host read on the worker (synchronizes the map stream only)."""
        self.map_syncs += 1
        with span("sdslam.wait"):
            return bool(flag)

    def _map_pass(self, ready, ms, pose, feats, stored, d, uright, assoc, frame_id, ts, parent):
        dev = self.map_device
        if self.map_stream is None:
            return self._kf_pass(ms, pose, feats, stored, d, uright, assoc, frame_id, ts,
                                 parent) + (None,)
        with torch.cuda.device(dev), torch.cuda.stream(self.map_stream):
            # upload the pose before waiting: a pageable copy waits for its stream
            pose_t = torch.as_tensor(pose, dtype=torch.float32).to(dev)
            self.map_stream.wait_event(ready)
            if dev != self.device:
                ms = _map_to(ms, dev)
                feats = type(feats)(*(t.to(dev) for t in feats))
                stored, d, uright, assoc, ts = (
                    tuple(p.to(dev) for p in stored), d.to(dev), uright.to(dev), assoc.to(dev),
                    ts.to(dev))
            ms_new, slot = self._kf_pass(ms, pose_t, feats, stored, d, uright, assoc, frame_id,
                                         ts, parent)
            if dev != self.device:
                ms_new = _map_to(ms_new, self.device)
            done = torch.cuda.Event()
            done.record(self.map_stream)
        return ms_new, slot, done

    def _kf_pass(self, ms, pose, feats, stored, d, uright, assoc, frame_id, ts, parent):
        """The mapping pass on the current device and stream; returns (the
        new map, its keyframe slot as a host int). Its spans carry the
        keyframe's trajectory index `frame_id` as their request id."""
        cfg, dev = self.cfg, ms.device
        with span("sdslam.kf", req=frame_id, n=1):
            # the associations were tracked against an older snapshot: drop
            # ids a since-swapped pass may have culled or replaced
            safe = torch.clamp(assoc, 0, ms.P - 1).long()
            assoc = torch.where((assoc >= 0) & ms.pt_valid[safe], assoc,
                                torch.full_like(assoc, -1))
            close = self.close_depth if np.isfinite(self.close_depth) else 1e9
            ms_new, slot, _, _ = _kf_core(
                self.cam, ms, torch.as_tensor(pose, dtype=torch.float32, device=dev), feats.uv,
                feats.uv_und, feats.octave, feats.angle, feats.desc, feats.valid, d, uright, assoc,
                stored, torch.full((), frame_id, dtype=torch.int32, device=dev), ts,
                torch.full((), parent, dtype=torch.int32, device=dev),
                torch.full((), close, device=dev), scale_factor=cfg.orb.scale_factor,
                n_levels=cfg.orb.n_levels, covis_min=cfg.map.covis_min_weight,
                ba_schedule=tuple(cfg.tracking.ba_schedule), sync=self._map_sync,
            )
            self.map_syncs += 1
            with span("sdslam.wait"):
                return ms_new, int(slot)
