"""Shared fixtures of the benchmark's tests. The tests run on the CPU; a
test marked ``cuda`` asks for the card through the ``card`` fixture, which
skips without one (decided when the test runs, never at import)."""

import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
