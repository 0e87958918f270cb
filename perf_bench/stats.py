"""Statistics the benchmark reports: percentiles of per-frame times, and
the camera centres `check.py` judges poses by (a frozen copy of `sdslam_tpu_torch/utils/metrics.py`'s, whose
`ate_rmse` `check.py` writes out per frame)."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile by nearest rank: the smallest value with at least
    q% of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    return float(s[max(0, math.ceil(q / 100.0 * len(s)) - 1)])


def camera_centers(Tcw) -> np.ndarray:
    """[N,4,4] world->camera poses -> [N,3] camera centres in the world."""
    T = np.asarray(Tcw, np.float64)
    return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])

