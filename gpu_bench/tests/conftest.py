"""The benchmark's own tests (``python -m pytest gpu_bench/tests``): on
the CPU at tiny sizes, except those marked ``card``, which need an
NVIDIA card and skip without one (decided inside each test)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"
