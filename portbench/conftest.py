"""pytest settings of the benchmark's own tests (`python -m pytest
portbench/tests`): the `card` marker, and the fixture that skips a card
test on a machine without a CUDA card (decided when the test runs)."""

import sys
from pathlib import Path

import pytest

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
