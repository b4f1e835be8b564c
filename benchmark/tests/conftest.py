"""The benchmark's own tests: the repo root on the path, and the `cuda`
fixture, which decides inside a test whether a card is there."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark runs on one)")
    return torch.device("cuda:0")
