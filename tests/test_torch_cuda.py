"""The port's CUDA kernels and its solve on the card, against the plain
PyTorch versions on the same inputs.  Every test here needs a CUDA card and
skips without one; the file imports neither ``jax`` nor ``repro``, so it
runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: exact equality (int32 throughout; integer adds commute)."""
import numpy as np
import pytest
import torch

from repro_torch.api import MaxflowProblem, Solver
from repro_torch.core.csr import Graph, build_residual
from repro_torch.graphs.generators import washington_rlg
from repro_torch.kernels import ref as kref
from repro_torch.kernels.revsearch import bcsr_rev_search, search_steps
from repro_torch.kernels.segmin import (tile_min_neighbor,
                                        tile_min_neighbor_plain)

INF = kref.INF
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _t(x, dev):
    return torch.tensor(np.asarray(x), dtype=torch.int32, device=dev)


def _rows(b: int, seed: int):
    """``b`` BCSR residuals of random graphs with a hub vertex of degree
    > 1024, padded to one arc count: ``(indptr, heads, tails, rev)`` as
    ``(b, ·)`` numpy arrays, the arc count and ``deg_max``."""
    rows = []
    for i in range(b):
        rng = np.random.default_rng(seed + i)
        e = rng.integers(0, 1500, size=(3000, 2))
        hub = np.stack([np.zeros(1100, np.int64), np.arange(1, 1101)], 1)
        rows.append(build_residual(
            Graph(1500, np.concatenate([e, hub]), np.ones(4100, np.int64)),
            "bcsr"))
    a = max(r.num_arcs for r in rows)
    fields = [np.stack([r.indptr for r in rows])] + [
        np.stack([np.pad(getattr(r, f), (0, a - r.num_arcs)) for r in rows])
        for f in ("heads", "tails", "rev")]
    return fields, a, max(r.deg_max for r in rows)


def _same(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype == torch.int32
        assert torch.equal(g, w)


@pytest.mark.parametrize("batched", [False, True])
def test_segmin_kernel_matches_plain(cuda, batched):
    """AVQ and dense forms; ``u >= n`` padding, empty and all-INF segments
    and a segment longer than 1024 arcs."""
    rng = np.random.default_rng(5)
    n, b = 300, 3
    deg = rng.integers(0, 9, size=n)
    deg[[4, 40]] = 0
    deg[7] = 2500
    indptr = np.concatenate([[0], np.cumsum(deg)])
    a = int(indptr[-1])
    key = rng.integers(0, n + 2, size=(b, a))
    key[:, rng.random(a) < 0.3] = INF
    key[:, indptr[11]:indptr[12]] = INF
    avq = np.full((b, n), n)
    special = [4, 7, 11, 40]  # empty, long, all-INF, empty
    others = np.setdiff1d(np.arange(n), special)
    for i in range(b):  # distinct entries, as an AVQ holds
        live = np.sort(rng.choice(others, size=120, replace=False))
        avq[i, :124] = np.concatenate([special, live])
    if not batched:
        avq, key = avq[0], key[0]
    ip = indptr if not batched else np.tile(indptr, (b, 1))
    ip, key, avq = _t(ip, cuda), _t(key, cuda), _t(avq, cuda)
    before = tile_min_neighbor.launches
    for q in (avq, None):
        _same(tile_min_neighbor(q, ip, key, n=n),
              tile_min_neighbor_plain(q, ip, key, n=n))
    assert tile_min_neighbor.launches == before + 2


@pytest.mark.parametrize("batched", [False, True])
def test_revsearch_kernel_matches_plain_and_rev_table(cuda, batched):
    (indptr, heads, tails, rev), a, deg_max = _rows(3, 50)
    rng = np.random.default_rng(9)
    arcs = rng.integers(0, a + 8, size=(3, 2 * a))  # arcs >= A included
    sl = slice(None) if batched else 0
    args = [_t(x[sl], cuda) for x in (arcs, indptr, heads, tails)]
    got = bcsr_rev_search(*args, deg_max=deg_max)
    _same(got, kref.rev_search_bsearch_ref(*args, steps=search_steps(deg_max)))
    if not batched:  # the build-time rev table, on row 0's real arcs
        real = (args[0] < int(indptr[0, -1])) | (args[0] >= a)
        want = kref.rev_search_ref(args[0], _t(rev[0], cuda), a)
        torch.cuda.synchronize()
        assert torch.equal(got[real], want[real])


@pytest.mark.parametrize("mode", ["vc_kernel", "vc_kernel_bsearch"])
def test_kernel_mode_solve_matches_cpu(cuda, mode):
    g, s, t = washington_rlg(24, 24, seed=3)
    p = MaxflowProblem(g, s, t)
    on_card = Solver(mode=mode, device="cuda").solve(p)
    on_cpu = Solver(mode="vc", device="cpu").solve(p)
    assert on_card.value == on_cpu.value
    for f in ("cycles", "rounds", "global_relabels", "gr_sweeps"):
        assert getattr(on_card.stats, f) == getattr(on_cpu.stats, f), f
    for f in ("res", "h", "e"):
        assert torch.equal(getattr(on_card.state, f).cpu(),
                           getattr(on_cpu.state, f)), f
