"""pytest settings for the benchmark's own tests (`slambench/tests/`).

    python -m pytest slambench/tests -q

Tests that need a CUDA card carry the `chip` marker and skip without
one; whether a card is present is decided inside the test (the `card`
fixture), never while a module is imported.
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)
