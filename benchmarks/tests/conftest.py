"""CPU tests of the benchmark harness (`benchmarks/`). The harness and
its references import neither JAX nor the JAX package, and neither do
these tests."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: runs the benchmark on an NVIDIA GPU; skips where "
        "torch.cuda.is_available() is false")


@pytest.fixture
def card():
    """The first CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")
    return torch.device("cuda:0")
