"""Graph generators for the paper's benchmark families.

This container has no network access, so the SNAP / KONECT datasets the paper
uses are replaced by generator-matched stand-ins at CPU-feasible scale:

* ``washington_rlg`` — Washington random-level graph (DIMACS 1st Challenge
  family used for S0): a W x H grid of levels, each vertex connected to
  random vertices in the next level, plus source/sink.
* ``genrmf`` — GENRMF (DIMACS family used for S1): ``b`` square grid frames of
  side ``a``; in-frame grid arcs with capacity c2, frame-to-frame random
  permutation arcs with capacity c1.
* ``powerlaw`` — preferential-attachment graph (SNAP social-network stand-in;
  high degree variance = the workload-imbalance regime the paper targets).
* ``grid_road`` — 2-D lattice (roadNet stand-in; tiny max degree = the regime
  where the paper's VC tiles under-utilise).
* ``random_sparse`` — Erdős–Rényi-style sparse digraph.
* ``bipartite_random`` — KONECT stand-in: L/R sets with power-law left
  degrees, plus super-source/super-sink, unit capacities (paper Table 2).

All return ``(Graph, s, t)`` (or ``BipartiteProblem``) with int capacities.

A copy of the JAX package's ``repro.graphs.generators`` (the port imports
nothing of ``repro``).  The per-vertex Python loops stay as they are: the
same seed must draw the same random stream, so both packages build
byte-identical graphs.  The streaming update traces come with the
streaming slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.csr import Graph


def _rng(seed):
    return np.random.default_rng(seed)


def washington_rlg(rows: int, cols: int, max_cap: int = 100, seed: int = 0):
    """Random level graph: ``cols`` levels of ``rows`` vertices; each vertex
    has 3 arcs to random vertices of the next level.  s feeds level 0, level
    ``cols-1`` drains to t."""
    rng = _rng(seed)
    n = rows * cols + 2
    s, t = rows * cols, rows * cols + 1
    edges, caps = [], []
    vid = lambda r, c: c * rows + r
    for r in range(rows):
        edges.append((s, vid(r, 0)))
        caps.append(int(rng.integers(1, max_cap + 1)) * rows)
        edges.append((vid(r, cols - 1), t))
        caps.append(int(rng.integers(1, max_cap + 1)) * rows)
    for c in range(cols - 1):
        for r in range(rows):
            for tgt in rng.integers(0, rows, size=3):
                edges.append((vid(r, c), vid(int(tgt), c + 1)))
                caps.append(int(rng.integers(1, max_cap + 1)))
    return Graph(n, np.array(edges, np.int64), np.array(caps, np.int64)), s, t


def genrmf(a: int, b: int, c1: int = 100, c2: int = 1000, seed: int = 0):
    """GENRMF: b frames of a*a grids. s = corner of frame 0, t = corner of
    frame b-1.  In-frame arcs cap c2*a*a, inter-frame (random permutation)
    arcs cap in [1, c1]."""
    rng = _rng(seed)
    fa = a * a
    n = fa * b
    vid = lambda f, x, y: f * fa + x * a + y
    edges, caps = [], []
    big = c2 * a * a
    for f in range(b):
        for x in range(a):
            for y in range(a):
                if x + 1 < a:
                    edges += [(vid(f, x, y), vid(f, x + 1, y)),
                              (vid(f, x + 1, y), vid(f, x, y))]
                    caps += [big, big]
                if y + 1 < a:
                    edges += [(vid(f, x, y), vid(f, x, y + 1)),
                              (vid(f, x, y + 1), vid(f, x, y))]
                    caps += [big, big]
        if f + 1 < b:
            perm = rng.permutation(fa)
            for i in range(fa):
                edges.append((f * fa + i, (f + 1) * fa + perm[i]))
                caps.append(int(rng.integers(1, c1 + 1)))
    g = Graph(n, np.array(edges, np.int64), np.array(caps, np.int64))
    return g, 0, n - 1


def powerlaw(n: int, m_per_node: int = 4, max_cap: int = 1, seed: int = 0,
             directed: bool = True):
    """Preferential attachment (Barabási–Albert flavour).  With ``max_cap=1``
    this matches the paper's unit-capacity SNAP setting."""
    rng = _rng(seed)
    targets = list(range(m_per_node))
    repeated = list(range(m_per_node))
    edges = []
    for v in range(m_per_node, n):
        tgts = rng.choice(repeated, size=m_per_node, replace=False) \
            if len(repeated) >= m_per_node else list(range(v))
        for u in set(int(x) for x in np.atleast_1d(tgts)):
            edges.append((v, u))
            if not directed:
                edges.append((u, v))
            repeated += [v, u]
    edges = np.array(edges, np.int64)
    caps = (np.ones(len(edges), np.int64) if max_cap == 1
            else rng.integers(1, max_cap + 1, size=len(edges)).astype(np.int64))
    g = Graph(n, edges, caps)
    # multi-source/multi-sink via super vertices, as the paper does for SNAP
    return _add_super_terminals(g, rng, k=min(8, n // 4))


def _add_super_terminals(g: Graph, rng, k: int):
    """Paper §4.1: add a super-source/super-sink connected to k sources/sinks."""
    out_deg = np.bincount(g.edges[:, 0], minlength=g.n)
    in_deg = np.bincount(g.edges[:, 1], minlength=g.n)
    sources = np.argsort(-out_deg)[:k]
    sinks = [v for v in np.argsort(-in_deg) if v not in set(sources.tolist())][:k]
    s, t = g.n, g.n + 1
    extra, ecaps = [], []
    big = int(max(1, g.cap.max())) * g.n
    for v in sources:
        extra.append((s, int(v))); ecaps.append(big)
    for v in sinks:
        extra.append((int(v), t)); ecaps.append(big)
    edges = np.concatenate([g.edges, np.array(extra, np.int64)])
    caps = np.concatenate([g.cap, np.array(ecaps, np.int64)])
    return Graph(g.n + 2, edges, caps), s, t


def grid_road(rows: int, cols: int, max_cap: int = 10, seed: int = 0):
    """2-D lattice with bidirectional arcs (road-network stand-in, d<=4)."""
    rng = _rng(seed)
    n = rows * cols
    vid = lambda r, c: r * cols + c
    edges, caps = [], []
    for r in range(rows):
        for c in range(cols):
            for dr, dc in ((0, 1), (1, 0)):
                rr, cc = r + dr, c + dc
                if rr < rows and cc < cols:
                    w = int(rng.integers(1, max_cap + 1))
                    edges += [(vid(r, c), vid(rr, cc)), (vid(rr, cc), vid(r, c))]
                    caps += [w, w]
    g = Graph(n, np.array(edges, np.int64), np.array(caps, np.int64))
    return g, 0, n - 1


def random_sparse(n: int, m: int, max_cap: int = 50, seed: int = 0):
    rng = _rng(seed)
    e = rng.integers(0, n, size=(m, 2)).astype(np.int64)
    caps = rng.integers(1, max_cap + 1, size=m).astype(np.int64)
    g = Graph(n, e, caps)
    return g, 0, n - 1


@dataclasses.dataclass(frozen=True)
class BipartiteProblem:
    graph: Graph  # with super source/sink already attached
    s: int
    t: int
    n_left: int
    n_right: int
    lr_edges: np.ndarray  # (k, 2) original left->right pairs (left ids 0..L-1)


def bipartite_random(n_left: int, n_right: int, avg_deg: float = 4.0,
                     seed: int = 0, skew: float = 1.5) -> BipartiteProblem:
    """Bipartite graph with Zipf-skewed left degrees (KONECT stand-in).

    Vertices: 0..L-1 left, L..L+R-1 right, s = L+R, t = L+R+1.
    All capacities 1 (matching == max flow)."""
    rng = _rng(seed)
    degs = np.clip(rng.zipf(skew, size=n_left), 1, max(1, n_right))
    scale = avg_deg * n_left / max(1, degs.sum())
    degs = np.maximum(1, (degs * scale).astype(np.int64))
    edges = []
    for u in range(n_left):
        d = min(int(degs[u]), n_right)
        for v in rng.choice(n_right, size=d, replace=False):
            edges.append((u, n_left + int(v)))
    lr = np.array(sorted(set(map(tuple, edges))), np.int64)
    s, t = n_left + n_right, n_left + n_right + 1
    se = np.stack([np.full(n_left, s, np.int64), np.arange(n_left)], 1)
    te = np.stack([np.arange(n_left, n_left + n_right),
                   np.full(n_right, t, np.int64)], 1)
    all_e = np.concatenate([lr, se, te])
    caps = np.ones(len(all_e), np.int64)
    return BipartiteProblem(
        graph=Graph(n_left + n_right + 2, all_e, caps), s=s, t=t,
        n_left=n_left, n_right=n_right, lr_edges=lr)
