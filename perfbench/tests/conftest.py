"""The benchmark's own tests: `python -m pytest perfbench/tests -q` from the
root of the repo.  They run on the CPU; those marked `card` need a CUDA
device and skip without one (decided in the `card` fixture, never at
import): `python -m pytest perfbench/tests -q -m card -s` on the card."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
