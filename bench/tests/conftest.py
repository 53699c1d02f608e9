"""The benchmark's own tests: ``python -m pytest bench/tests`` from the
root of the checkout.  Tests that need a CUDA card carry the ``card``
marker and skip without one, decided inside the ``card`` fixture."""
from __future__ import annotations

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT / "bench", ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda", 0)


def spec() -> dict:
    """``BENCHMARK.json``."""
    import json

    return json.loads((ROOT / "BENCHMARK.json").read_text())
