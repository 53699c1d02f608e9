"""DIMACS Washington random-level graph (RLG), drawn in a few vectorised
NumPy calls."""
from __future__ import annotations

import numpy as np

from bench.gen.graphs import Instance


def make(rng: np.random.Generator, rows: int, cols: int,
         max_cap: int = 100) -> Instance:
    """``cols`` levels of ``rows`` vertices (vertex ``c * rows + r``), 3
    arcs from each vertex to random vertices of the next level with
    capacities in ``[1, max_cap]``; the source feeds level 0 and the last
    level drains to the sink, each terminal arc ``[1, max_cap] * rows``."""
    n = rows * cols + 2
    s, t = rows * cols, rows * cols + 1
    r = np.arange(rows, dtype=np.int64)
    src = np.stack([np.full(rows, s, np.int64), r], 1)
    snk = np.stack([(cols - 1) * rows + r, np.full(rows, t, np.int64)], 1)
    term_cap = rng.integers(1, max_cap + 1, size=2 * rows) * rows
    tails = np.repeat(np.arange((cols - 1) * rows, dtype=np.int64), 3)
    level = tails // rows
    heads = (level + 1) * rows + rng.integers(0, rows, size=tails.size)
    mid_cap = rng.integers(1, max_cap + 1, size=tails.size)
    edges = np.concatenate([src, snk, np.stack([tails, heads], 1)])
    cap = np.concatenate([term_cap, mid_cap]).astype(np.int64)
    return Instance(n, edges, cap, s, t)
