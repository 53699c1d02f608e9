"""The reference's view of a capacitated digraph: its coalesced vertex
pairs.

A residual graph has one arc each way between two vertices, so parallel
edges add up and an edge ``v -> u`` beside ``u -> v`` is the pair's
reverse capacity (self-loops carry nothing).  A :class:`PairTable` holds
each unordered pair ``lo < hi`` once, sorted by ``lo * n + hi``, with the
capacities ``fwd`` (``lo -> hi``) and ``bwd`` (``hi -> lo``).  That order
is also the order of a solver's per-pair flows (entry ``i`` is the net
flow ``lo[i] -> hi[i]``), so the reference can read them without any
table of the program's.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def unique(keys: np.ndarray, return_inverse: bool = False):
    """``np.unique`` of integer keys by a sort (numpy 2.3's ``np.unique``
    takes seconds for millions of keys, where a sort takes a fraction of
    one)."""
    order = np.argsort(keys) if return_inverse else None
    s = keys[order] if return_inverse else np.sort(keys)
    first = np.ones(s.size, bool)
    first[1:] = s[1:] != s[:-1]
    if not return_inverse:
        return s[first]
    inverse = np.empty(s.size, np.int64)
    inverse[order] = np.cumsum(first) - 1
    return s[first], inverse


@dataclasses.dataclass(frozen=True)
class PairTable:
    n: int
    lo: np.ndarray  # (m,) int64
    hi: np.ndarray  # (m,) int64
    fwd: np.ndarray  # (m,) int64 capacity lo -> hi
    bwd: np.ndarray  # (m,) int64 capacity hi -> lo

    @classmethod
    def from_edges(cls, n: int, edges: np.ndarray,
                   cap: np.ndarray) -> PairTable:
        u, v = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
        keep = u != v
        u, v, c = u[keep], v[keep], cap[keep].astype(np.int64)
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        keys, idx = unique(lo * n + hi, return_inverse=True)
        up = u == lo
        fwd = np.bincount(idx[up], weights=c[up], minlength=keys.size)
        bwd = np.bincount(idx[~up], weights=c[~up], minlength=keys.size)
        return cls(n, keys // n, keys % n, fwd.astype(np.int64),
                   bwd.astype(np.int64))

    @property
    def m(self) -> int:
        return self.lo.size
