"""The benchmark's own tests: `python -m pytest bench_port/tests -p no:randomly`
from the repository root. Tests marked `card` need an NVIDIA card; they
decide in the `card` fixture, never at import, and skip without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
