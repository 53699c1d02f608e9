import pathlib
import sys

import numpy as np
import pytest

# bare `pytest` puts only tests/ on sys.path; the modules here import
# `tests.conftest`, so make the repo root importable too
_ROOT = str(pathlib.Path(__file__).resolve().parents[1])
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

try:  # prefer the real property-testing engine when available
    import hypothesis  # noqa: F401
except ImportError:  # gate the missing dep: deterministic fallback shim
    from tests import _hypothesis_fallback

    sys.modules["hypothesis"] = _hypothesis_fallback
    sys.modules["hypothesis.strategies"] = _hypothesis_fallback.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_graph(rng, n_lo=5, n_hi=40, cap_hi=15):
    from repro.core.csr import Graph
    n = int(rng.integers(n_lo, n_hi))
    m = int(rng.integers(n, 5 * n))
    edges = rng.integers(0, n, size=(m, 2)).astype(np.int64)
    caps = rng.integers(1, cap_hi, size=m).astype(np.int64)
    return Graph(n, edges, caps)
