"""The benchmark's own tests: CPU tests, and tests marked `card` that
need an NVIDIA GPU (they skip elsewhere, deciding inside a fixture)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA GPU (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")
