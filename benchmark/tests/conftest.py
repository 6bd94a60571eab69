"""The benchmark's own tests (CPU; the `cuda` ones run on the card):

    python -m pytest benchmark/tests -q

They are not under tests/, so the repository's tier-1 run does not
collect them.  Nothing here imports jax."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    """The CUDA device, decided when a test asks for it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    return "cuda"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)
