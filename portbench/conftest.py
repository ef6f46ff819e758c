"""pytest settings of the benchmark's own tests (`pytest portbench/tests`).

Tests that need an NVIDIA card carry the `cuda` marker and take the `card`
fixture, which decides when the test runs whether a card is there and skips
with a reason where it is not."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")
