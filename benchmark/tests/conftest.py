"""CPU tests of the benchmark (python -m pytest benchmark/tests). Tests
that need the card carry the marker `card` and skip, inside the `card`
fixture, where there is no CUDA device."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# Crops of the films that a CPU run can hold (x0, x1, y0, y1 pixels).
WINDOWS = {"config4_big": (250, 258, 300, 308), "bench3": (100, 106, 100, 106)}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
