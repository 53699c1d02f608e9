"""Bipartite graphs with Zipf-skewed left degrees, unit capacities and a
super-source and super-sink (matching as max flow), drawn in a few
vectorised NumPy calls."""
from __future__ import annotations

import numpy as np

from bench.gen.graphs import Instance
from bench.reference.pairs import unique


def _distinct_draws(rng, degs: np.ndarray, n_right: int) -> np.ndarray:
    """For each left vertex ``u``, ``degs[u]`` distinct right indices in
    ``[0, n_right)``, as sorted keys ``u * n_right + v``.  Vertices that
    take more than an eighth of the right side are drawn without
    replacement one by one; the rest draw with replacement, drop repeats
    and draw again what they lack."""
    big = np.nonzero(degs > n_right // 8)[0]
    keys = [u * n_right + rng.choice(n_right, size=int(degs[u]),
                                     replace=False) for u in big]
    want = degs.copy()
    want[big] = 0
    need = want
    have = np.zeros(0, np.int64)
    while need.sum():
        u = np.repeat(np.arange(degs.size, dtype=np.int64), need)
        have = unique(np.concatenate(
            [have, u * n_right + rng.integers(0, n_right, size=u.size)]))
        need = want - np.bincount(have // n_right, minlength=degs.size)
    return np.sort(np.concatenate([have, *keys]))


def make(rng: np.random.Generator, n_left: int, n_right: int,
         avg_deg: float = 4.0, skew: float = 1.5) -> Instance:
    """Left degrees drawn from Zipf(``skew``), clipped to the right side
    and scaled to a mean of ``avg_deg`` (at least 1), each left vertex
    joined to that many distinct right vertices; a super-source feeds
    every left vertex and every right vertex drains to a super-sink;
    every capacity 1 (the matching's size is the max flow).  Vertices:
    left ``0..L-1``, right ``L..L+R-1``, ``s = L+R``, ``t = L+R+1``."""
    degs = np.clip(rng.zipf(skew, size=n_left), 1, max(1, n_right))
    scale = avg_deg * n_left / max(1, degs.sum())
    degs = np.minimum(np.maximum(1, (degs * scale).astype(np.int64)),
                      n_right)
    key = _distinct_draws(rng, degs, n_right)
    lr = np.stack([key // n_right, n_left + key % n_right], 1)
    s, t = n_left + n_right, n_left + n_right + 1
    left = np.arange(n_left, dtype=np.int64)
    right = np.arange(n_left, n_left + n_right, dtype=np.int64)
    edges = np.concatenate([lr, np.stack([np.full(n_left, s), left], 1),
                            np.stack([right, np.full(n_right, t)], 1)])
    return Instance(n_left + n_right + 2, edges.astype(np.int64),
                    np.ones(len(edges), np.int64), s, t, n_left, n_right)
