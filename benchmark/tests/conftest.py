"""Fixtures of the benchmark's tests: whether a CUDA card is here is
decided inside a fixture, so every worker collects the same tests."""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures on the card only")
    return torch.device("cuda")
