"""Plain NumPy checks of a max flow, a min cut and a maximum matching.

They judge the program's answers by what the answers say, against the
graph the benchmark drew, and take nothing else from the program:

* a max-flow answer is the value, the net flow of every vertex pair
  (in :class:`pairs.PairTable` order) and the source side of a cut.  The
  flow has to respect every capacity and conserve at every vertex but
  the terminals, carry the value out of ``s`` and into ``t``, and leave
  no path from ``s`` to ``t`` in its residual graph; the cut has to hold
  ``s`` and not ``t`` and have the value as its capacity.  A feasible
  flow and a cut of equal size are each optimal (max-flow = min-cut), so
  this is the whole proof, and it costs two passes over the arcs and one
  breadth-first search.
* a matching answer is its size and its ``(left, right)`` pairs.  Every
  pair has to be an edge of the graph, no vertex may be used twice, the
  size has to be the number of pairs, and no augmenting path may exist:
  a breadth-first search along alternating paths from every free left
  vertex reaches no free right vertex (Berge's theorem).

Each check returns named counts whose limit is 0.
"""
from __future__ import annotations

import numpy as np

from bench.reference.pairs import PairTable, unique


def _csr(tails: np.ndarray, heads: np.ndarray, n: int):
    order = np.argsort(tails)
    indptr = np.searchsorted(tails[order], np.arange(n + 1))
    return indptr, heads[order]


def _neighbours(indptr, heads, frontier: np.ndarray) -> np.ndarray:
    starts, ends = indptr[frontier], indptr[frontier + 1]
    lens = ends - starts
    if not lens.sum():
        return np.zeros(0, np.int64)
    offs = np.repeat(starts - np.cumsum(lens) + lens, lens)
    return heads[offs + np.arange(lens.sum())]


def reachable(n: int, tails: np.ndarray, heads: np.ndarray,
              sources: np.ndarray) -> np.ndarray:
    """Vertices reachable from ``sources`` over the arcs ``tails ->
    heads``, as a mask (one level of the search per loop)."""
    indptr, hd = _csr(tails, heads, n)
    seen = np.zeros(n, bool)
    seen[sources] = True
    frontier = np.asarray(sources, np.int64)
    while frontier.size:
        nxt = unique(_neighbours(indptr, hd, frontier))
        frontier = nxt[~seen[nxt]]
        seen[frontier] = True
    return seen


def maxflow(table: PairTable, s: int, t: int, value: int,
            flow: np.ndarray, source_side: np.ndarray) -> dict:
    """The counts that certify a max-flow answer (each must be 0)."""
    n = table.n
    if flow.shape != (table.m,) or source_side.shape != (n,):
        return {"shape": 1}
    f = flow.astype(np.int64)
    over = int(((f > table.fwd) | (-f > table.bwd)).sum())
    net = (np.bincount(table.lo, weights=f, minlength=n)
           - np.bincount(table.hi, weights=f, minlength=n))
    inner = np.ones(n, bool)
    inner[[s, t]] = False
    conserve = int((net[inner] != 0).sum())
    value_gap = abs(int(net[s]) - value) + abs(int(-net[t]) - value)
    # residual arcs: lo -> hi while fwd - f > 0, hi -> lo while bwd + f > 0
    up, down = table.fwd - f > 0, table.bwd + f > 0
    tails = np.concatenate([table.lo[up], table.hi[down]])
    heads = np.concatenate([table.hi[up], table.lo[down]])
    augment = int(reachable(n, tails, heads, np.array([s]))[t])
    side = source_side.astype(bool)
    cross = (table.fwd * (side[table.lo] & ~side[table.hi])
             + table.bwd * (side[table.hi] & ~side[table.lo])).sum()
    cut_gap = abs(int(cross) - value) + int(not side[s]) + int(side[t])
    return {"over_capacity": over, "unconserved": conserve,
            "value_gap": value_gap, "augmenting_path": augment,
            "cut_gap": cut_gap}


def matching(n_left: int, n_right: int, lr: np.ndarray, value: int,
             pairs: np.ndarray) -> dict:
    """The counts that certify a maximum-matching answer (each must be
    0).  ``lr`` holds the graph's ``(left, right)`` edges, right vertices
    numbered from ``n_left``."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    nl, nr = n_left, n_right
    key = lr[:, 0] * (nl + nr) + lr[:, 1]
    order = np.sort(key)
    pk = pairs[:, 0] * (nl + nr) + pairs[:, 1]
    pos = np.minimum(np.searchsorted(order, pk), order.size - 1)
    in_range = ((pairs[:, 0] >= 0) & (pairs[:, 0] < nl)
                & (pairs[:, 1] >= nl) & (pairs[:, 1] < nl + nr))
    not_edge = int((~in_range | (order[pos] != pk)).sum())
    reused = (len(pairs) - unique(pairs[:, 0]).size
              + len(pairs) - unique(pairs[:, 1]).size)
    ok = pairs[in_range]
    match_l = np.full(nl, -1, np.int64)
    match_r = np.full(nr, -1, np.int64)
    match_l[ok[:, 0]] = ok[:, 1] - nl
    match_r[ok[:, 1] - nl] = ok[:, 0]
    # alternating search: left -> any right neighbour -> its partner
    indptr, heads = _csr(lr[:, 0], lr[:, 1] - nl, nl)
    seen_l = match_l < 0
    seen_r = np.zeros(nr, bool)
    frontier = np.nonzero(seen_l)[0]
    augment = 0
    while frontier.size:
        right = unique(_neighbours(indptr, heads, frontier))
        right = right[~seen_r[right]]
        seen_r[right] = True
        if (match_r[right] < 0).any():
            augment = 1
            break
        frontier = match_r[right]
        frontier = frontier[~seen_l[frontier]]
        seen_l[frontier] = True
    return {"not_an_edge": not_edge, "vertex_reused": int(reused),
            "value_gap": abs(len(pairs) - value), "augmenting_path": augment}
