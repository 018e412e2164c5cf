"""The benchmark's tests: CPU tests at small widths, and tests marked
``cuda`` that need the card and skip elsewhere (from the ``card`` fixture).

    python -m pytest benchmark/tests -q                      # here
    python -m pytest benchmark/tests -q -m cuda              # on the card
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips on machines without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
