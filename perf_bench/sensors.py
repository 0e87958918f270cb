"""What differs between the SLAM facade's three sensors, in one table.

A configuration file names its sensor (`"sensor"`) by the facade's own
constant (`sdslam_tpu_torch/system.py`: `rgbd`, `monocular`,
`monocular_imu`); the harness, the traffic generator and the comparison
read everything that depends on it from that sensor's row here:

- `method`: the facade's call for one frame;
- `inputs(lap, k, imu)`: that call's arguments before the timestamp, for
  lap frame `k` (`imu` is the run's `traffic.ImuStream`, or None);
- `depth`: the lap renders depth (the u16 payload), and the ORB check
  compares each keypoint's metric depth;
- `imu`: each call takes one IMU sample (`traffic.ImuStream`, made from
  the lap's poses and the traffic file's `imu` object);
- `fit_sim3`: the comparison fits one similarity of the returned camera
  centres to the truth before it measures anything (a monocular map's
  scale is its own: the bootstrap sets the median depth to 1).

A deployment of any of the three is added with files and `BENCHMARK.json`
entries alone.
"""

from __future__ import annotations

from typing import Callable, NamedTuple


class Sensor(NamedTuple):
    name: str
    method: str
    inputs: Callable
    depth: bool
    imu: bool
    fit_sim3: bool


def _image_depth(lap, k, imu):
    return lap.images[k], lap.depths[k]


def _image(lap, k, imu):
    return (lap.images[k],)


def _image_imu(lap, k, imu):
    return lap.images[k], imu.sample(k)


SENSORS = {s.name: s for s in (
    Sensor("rgbd", "track_rgbd", _image_depth, depth=True, imu=False, fit_sim3=False),
    Sensor("monocular", "track_monocular", _image, depth=False, imu=False, fit_sim3=True),
    Sensor("monocular_imu", "track_fusion", _image_imu, depth=False, imu=True, fit_sim3=True),
)}


def sensor(name: str) -> Sensor:
    """The row of a configuration's `sensor`; any other value is refused."""
    if name not in SENSORS:
        raise ValueError(f"the harness drives {', '.join(SENSORS)} deployments only, "
                         f"not {name!r}")
    return SENSORS[name]
