"""Tests of the benchmark harness (`python -m pytest perf_bench/tests`).

They run on the CPU at test sizes. A test that needs the card is marked
`card` and skips, inside the test, where `torch.cuda.is_available()` is
false."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.fixture
def one_thread():
    """One intra-op thread, as the benchmark runs: on the CPU a reduction
    split over threads may sum in another order."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
