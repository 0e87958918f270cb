"""Percentiles, the roofline bound and the reduction of a device
trace to busy time, idle gaps and launches."""

import pytest
import torch

from perf_bench import check, roofline, stats, trace


def test_percentile_nearest_rank():
    v = list(range(1, 201))  # 200 samples: the 95th is the 190th value
    assert stats.percentile(v, 95) == 190
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e9, 67e12) == pytest.approx(1.0)
    t = torch.zeros(4, 8, dtype=torch.int32)
    assert roofline.nbytes(t, (t, [t, None]), None) == 3 * 128


def test_kernel_counts_from_launch_arguments():
    da, db = torch.zeros(1024, 8, dtype=torch.int32), torch.zeros(16384, 8, dtype=torch.int32)
    mask = torch.zeros(1024, 16384, dtype=torch.bool)
    mask[:, :10] = True
    out = (torch.zeros(1024, dtype=torch.int32),) * 2 + (torch.zeros(1024, dtype=torch.int64),)
    b, ops = roofline.KERNELS[("hamming_kernel", "hamming_masked_best2")][0]((da, db, mask),
                                                                           {}, out)
    assert b == 32768 + 524288 + 1024 * 16384 + 4096 * 2 + 8192
    assert ops == 10240 * 8 * roofline.HAMMING_OPS_PER_WORD
    S, rhs = torch.zeros(144, 144), torch.zeros(144)
    _, ops = roofline.KERNELS[("chol_kernel", "chol_solve_dense")][0]((S, rhs), {}, rhs)
    assert ops == roofline.chol_flop(144)


def test_hand_written_kernel_names():
    assert roofline.is_hand_written("void align_level_kernel<0, 1, 256>(float const*, int)")
    assert roofline.is_hand_written("hamming_best2_kernel(unsigned int const*, int)")
    assert roofline.is_hand_written("pose_gn_kernel")
    assert not roofline.is_hand_written("void at::native::roll_cuda_kernel<float>(float*)")


class Ev:
    def __init__(self, name, s, e, dev):
        self._n, self._s, self._e, self._d = name, s, e, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._d else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return False


def test_trace_reduction_busy_idle_launches():
    evs = [Ev(trace.BLOCK, 0, 1000, False), Ev(trace.BLOCK, 0, 1000, True),
           Ev("aten::add", 100, 150, False), Ev("aten::nonzero", 500, 700, False),
           Ev("pose_gn_kernel", 100, 300, True), Ev("void roll_kernel<float>", 250, 400, True),
           Ev("Memcpy DtoH (Device -> Pageable)", 600, 650, True),
           Ev("align_level_kernel<1>", 800, 900, True)]
    r = trace.reduce_events(evs, n_frames=2)
    assert r["window_s"] == pytest.approx(1e-6)
    assert r["busy_s"] == pytest.approx((300 + 50 + 100) * 1e-9)
    assert r["kernels"] == 3 and r["launches_per_frame"] == 1.5
    assert r["own_device_s"] == pytest.approx(300e-9)
    assert r["idle_gaps"][0][1] == pytest.approx(200e-9)
    assert "aten::nonzero" in r["idle_gaps"][0][0]


def test_judge_holds_every_number_to_its_limit():
    ok, checks = check.judge({"ate_cm": 0.5, "map_err_cm": 2.0}, {"ate_cm": 1.0, "map_err_cm": 1.0})
    assert not ok and checks["ate_cm"] == {"value": 0.5, "limit": 1.0}
    ok, _ = check.judge({"ate_cm": 0.5, "map_err_cm": 1.0}, {"ate_cm": 1.0, "map_err_cm": 1.0})
    assert ok
    ok, _ = check.judge({"ate_cm": float("inf")}, {"ate_cm": 1.0})  # an answer that never came
    assert not ok


def test_frame_rate_reads_the_window():
    """The per-layer frame rate is the window's frames over its seconds, as
    the end-to-end rate was; an empty window reads nothing."""
    from pathlib import Path

    from perf_bench.manifest import Manifest

    read = Manifest(Path(__file__).resolve().parents[2]).layer_reader("frame_rate")
    assert read({"frames": 918, "window_s": 51.0}) == pytest.approx(18.0)
    assert read({"frames": 0, "window_s": 0.0}) is None
