"""The vectorised generators keep their families' invariants and draw the
same graph from the same seed."""
from __future__ import annotations

import numpy as np
import pytest

from bench.gen import graphs
from bench.lib.request import seed_seq


def rlg(seed, rows=32, cols=24, max_cap=100):
    return graphs.make("washington_rlg", seed_seq(seed, 0, 0),
                       {"rows": rows, "cols": cols, "max_cap": max_cap})


def bip(seed, nl=300, nr=200, deg=8.0):
    return graphs.make("bipartite_random", seed_seq(seed, 0, 0),
                       {"n_left": nl, "n_right": nr, "avg_deg": deg,
                        "skew": 1.5})


def test_rlg_levels_and_degrees():
    rows, cols, cap = 32, 24, 100
    g = rlg(5, rows, cols, cap)
    assert (g.n, g.s, g.t) == (rows * cols + 2, rows * cols, rows * cols + 1)
    u, v = g.edges[:, 0], g.edges[:, 1]
    src, snk = u == g.s, v == g.t
    assert np.array_equal(np.sort(v[src]), np.arange(rows))
    assert np.array_equal(np.sort(u[snk]), (cols - 1) * rows
                          + np.arange(rows))
    term = g.cap[src | snk]
    assert (term % rows == 0).all() and term.min() >= rows \
        and term.max() <= cap * rows
    mid = ~(src | snk)
    assert (v[mid] // rows == u[mid] // rows + 1).all()  # next level
    assert np.array_equal(np.bincount(u[mid], minlength=(cols - 1) * rows),
                          np.full((cols - 1) * rows, 3))
    assert g.cap[mid].min() >= 1 and g.cap[mid].max() <= cap


def test_bipartite_degrees_and_unit_capacities():
    nl, nr = 300, 200
    b = bip(7, nl, nr)
    assert (b.n, b.s, b.t, b.n_left, b.n_right) == (nl + nr + 2, nl + nr,
                                                    nl + nr + 1, nl, nr)
    assert (b.cap == 1).all()
    lr = b.edges[: len(b.edges) - nl - nr]
    assert ((lr[:, 0] < nl) & (lr[:, 1] >= nl) & (lr[:, 1] < nl + nr)).all()
    assert len(np.unique(lr[:, 0] * (nl + nr) + lr[:, 1])) == len(lr)
    deg = np.bincount(lr[:, 0], minlength=nl)
    assert deg.min() >= 1 and deg.max() <= nr
    assert deg.sum() == len(lr)
    tail = b.edges[len(lr):]
    assert np.array_equal(np.sort(tail[tail[:, 0] == b.s][:, 1]),
                          np.arange(nl))
    assert np.array_equal(np.sort(tail[tail[:, 1] == b.t][:, 0]),
                          np.arange(nl, nl + nr))


def test_bipartite_mean_degree_follows_the_scale():
    b = bip(3, 4000, 4000, deg=8.0)
    lr = b.edges[: len(b.edges) - 8000]
    # degrees scaled to a mean of 8, then floored at 1
    assert 8.0 <= len(lr) / 4000 < 12.0


@pytest.mark.parametrize("make", [rlg, bip])
def test_same_seed_same_graph(make):
    a, b, c = make(11), make(11), make(12)
    assert np.array_equal(a.edges, b.edges) and np.array_equal(a.cap, b.cap)
    assert not (a.edges.shape == c.edges.shape
                and np.array_equal(a.edges, c.edges)
                and np.array_equal(a.cap, c.cap))


def test_large_seed_draws():
    g = rlg(2**31 + 12345)
    assert g.edges.shape[0] == 2 * 32 + 3 * 23 * 32
