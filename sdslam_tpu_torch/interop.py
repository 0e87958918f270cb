"""State carried between the JAX package and the port, as dicts of numpy
arrays (the map is this system's "weights").

`map_state_from_numpy(d)` takes the JAX MapState's fields (e.g.
`{k: np.asarray(v) for k, v in ms._asdict().items()}`, kf_pyramid as a
tuple/list of arrays) and builds the port's MapState; uint32 descriptors
become int32 bit patterns. `map_state_to_numpy` goes back, descriptors as
uint32. The same pair exists for EKFState, IMUState, DeviceState (its
"ekf" and "imu" entries as nested dicts) and the loop closer's
ConsistencyState.

The tests compare the port with the JAX package through them, and
`SDSlamSystem.save_map` / `load_map` write and read the JAX package's npz
layout with the map pair. Like the port's other entry points they build
on the card unless `device` names another ("cpu" for the tests).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from sdslam_tpu_torch._device import resolve
from sdslam_tpu_torch.mapping.map_state import MapState
from sdslam_tpu_torch.pipeline.loop_closing import ConsistencyState
from sdslam_tpu_torch.pipeline.sensors import EKFState, IMUState
from sdslam_tpu_torch.pipeline.tracking import DeviceState

_DESC_FIELDS = ("kf_desc", "pt_desc")


def _to_torch(a, device) -> torch.Tensor:
    """A copy on device, 0-d arrays kept 0-d; uint32 -> int32 bit patterns."""
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor, desc: bool = False) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if desc else a


def map_state_from_numpy(d: Mapping, device="cuda") -> MapState:
    device = resolve(device)
    kw = {}
    for f in MapState._fields:
        if f == "kf_pyramid":
            kw[f] = tuple(_to_torch(p, device) for p in d[f])
        else:
            kw[f] = _to_torch(d[f], device)
    return MapState(**kw)


def map_state_to_numpy(ms: MapState) -> dict:
    out = {}
    for f, v in ms._asdict().items():
        if f == "kf_pyramid":
            out[f] = tuple(_to_numpy(p) for p in v)
        else:
            out[f] = _to_numpy(v, desc=f in _DESC_FIELDS)
    return out


def ekf_state_from_numpy(d: Mapping, device="cuda") -> EKFState:
    device = resolve(device)
    return EKFState(**{f: _to_torch(d[f], device) for f in EKFState._fields})


def ekf_state_to_numpy(s: EKFState) -> dict:
    return {f: _to_numpy(v) for f, v in s._asdict().items()}


def imu_state_from_numpy(d: Mapping, device="cuda") -> IMUState:
    device = resolve(device)
    return IMUState(**{f: _to_torch(d[f], device) for f in IMUState._fields})


def imu_state_to_numpy(s: IMUState) -> dict:
    return {f: _to_numpy(v) for f, v in s._asdict().items()}


_FILTERS = {"ekf": (ekf_state_from_numpy, ekf_state_to_numpy),
            "imu": (imu_state_from_numpy, imu_state_to_numpy)}


def device_state_from_numpy(d: Mapping, device="cuda") -> DeviceState:
    """d: the JAX DeviceState's fields; d["ekf"] and d["imu"] are mappings
    of the filters' fields (or objects with _asdict())."""
    device = resolve(device)
    kw = {}
    for f in DeviceState._fields:
        if f in _FILTERS:
            sub = d[f]._asdict() if hasattr(d[f], "_asdict") else d[f]
            kw[f] = _FILTERS[f][0](sub, device)
        else:
            kw[f] = _to_torch(d[f], device)
    return DeviceState(**kw)


def device_state_to_numpy(s: DeviceState) -> dict:
    return {f: _FILTERS[f][1](v) if f in _FILTERS else _to_numpy(v)
            for f, v in s._asdict().items()}


def consistency_state_from_numpy(d: Mapping, device="cuda") -> ConsistencyState:
    """d: the JAX ConsistencyState's fields (mask [K,K] bool, count [K])."""
    device = resolve(device)
    if hasattr(d, "_asdict"):
        d = d._asdict()
    return ConsistencyState(**{f: _to_torch(d[f], device) for f in ConsistencyState._fields})


def consistency_state_to_numpy(s: ConsistencyState) -> dict:
    return {f: _to_numpy(v) for f, v in s._asdict().items()}
