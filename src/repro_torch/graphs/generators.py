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
byte-identical graphs and the same streaming update traces, event for
event.
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


# ---------------------------------------------------------------------------
# update traces for the streaming tier


def _directed_caps(g: Graph) -> dict:
    """Host mirror of the coalesced residual's directed capacities: both
    directions of every unordered pair (self-loops dropped, parallel
    edges summed) — the exact arc set ``build_residual`` materialises."""
    caps: dict[tuple[int, int], int] = {}
    for (u, v), c in zip(g.edges.tolist(), g.cap.tolist()):
        if u == v:
            continue
        caps[(u, v)] = caps.get((u, v), 0) + int(c)
        caps.setdefault((v, u), 0)
    return caps


def update_trace(g: Graph, s: int, t: int, n_batches: int = 20,
                 batch_size: int = 4, p_insert: float = 0.15,
                 p_delete: float = 0.15, locality: float = 0.0,
                 adversarial: bool = False, max_cap: int = 50,
                 seed: int = 0) -> list:
    """A replayable stream of edit-event batches for ``(g, s, t)``.

    Returns ``[batch, ...]`` where each batch is a list of
    ``repro_torch.streaming`` events (``EdgeInsert`` / ``EdgeDelete``
    / ``CapacityReweight``), guaranteed admissible when applied in order
    (no self-loops, no deletes of missing arcs, vertices in range).

    ``locality`` in [0, 1] biases consecutive events toward recently
    touched vertices (1.0 = the whole trace hammers one neighbourhood —
    the best case for warm starts; 0.0 = uniform).  ``adversarial=True``
    instead alternates large re-weights on the source/sink frontier
    arcs, repeatedly invalidating the routed flow — the worst case for
    incremental re-solve and the honest baseline for the benchmark.
    """
    from repro_torch.streaming.events import (CapacityReweight,
                                              EdgeDelete, EdgeInsert)

    rng = _rng(seed)
    caps = _directed_caps(g)
    pairs = list(caps.keys())
    recent: list[int] = []

    def pick_pair():
        if recent and locality > 0 and rng.random() < locality:
            u = int(recent[int(rng.integers(0, len(recent)))])
            cand = [p for p in pairs if p[0] == u or p[1] == u]
            if cand:
                return cand[int(rng.integers(0, len(cand)))]
        return pairs[int(rng.integers(0, len(pairs)))]

    def note(u, v):
        recent.extend((u, v))
        del recent[:-8]

    if adversarial:
        # the flow-carrying frontier: arcs leaving s and entering t.
        # Zeroing them strands routed flow at depth (maximal reroute
        # work); restoring them forces a full re-route back in.
        frontier = [p for p in pairs
                    if (p[0] == s or p[1] == t) and caps[p] > 0]
        if not frontier:
            frontier = [p for p in pairs if caps[p] > 0] or pairs
        batches = []
        for i in range(n_batches):
            batch = []
            for j in range(batch_size):
                u, v = frontier[(i + j) % len(frontier)]
                lo = 0 if (i + j) % 2 == 0 else max_cap
                batch.append(CapacityReweight(u, v, lo))
                caps[(u, v)] = lo
            batches.append(batch)
        return batches

    batches = []
    for _ in range(n_batches):
        batch = []
        # pairs inserted in THIS batch: further same-batch events on them
        # are inadmissible (normalize_events rejects events on a pair
        # that does not exist until the batch is applied)
        fresh: set[frozenset] = set()
        for _ in range(batch_size):
            roll = rng.random()
            if roll < p_insert:
                # a genuinely new pair when one exists, else a
                # parallel-edge insert (degrades to a capacity increase)
                for _ in range(8):
                    u, v = int(rng.integers(0, g.n)), int(rng.integers(0, g.n))
                    if u != v and (u, v) not in caps:
                        break
                else:
                    for _ in range(8):
                        u, v = pick_pair()
                        if frozenset((u, v)) not in fresh:
                            break
                    else:
                        continue
                c = int(rng.integers(1, max_cap + 1))
                batch.append(EdgeInsert(u, v, c))
                if (u, v) not in caps:  # genuinely new pair: track both arcs
                    pairs.extend([(u, v), (v, u)])
                    fresh.add(frozenset((u, v)))
                caps[(u, v)] = caps.get((u, v), 0) + c
                caps.setdefault((v, u), 0)
            elif roll < p_insert + p_delete:
                live = [p for p in pairs if caps.get(p, 0) > 0
                        and frozenset(p) not in fresh]
                if not live:
                    continue
                u, v = live[int(rng.integers(0, len(live)))]
                batch.append(EdgeDelete(u, v))
                caps[(u, v)] = 0
            else:
                for _ in range(8):
                    u, v = pick_pair()
                    if frozenset((u, v)) not in fresh:
                        break
                else:
                    continue
                c = int(rng.integers(0, max_cap + 1))
                batch.append(CapacityReweight(u, v, c))
                caps[(u, v)] = c
            note(u, v)
        if batch:
            batches.append(batch)
    return batches


def apply_events_to_graph(g: Graph, batches) -> Graph:
    """Fold event batches into a plain ``Graph`` — the cold-solve
    reference a replayed trace is compared against.  Accepts a single
    batch or a list of batches."""
    from repro_torch.streaming.events import (CapacityReweight,
                                              EdgeDelete, EdgeInsert)

    caps = _directed_caps(g)
    if batches and not isinstance(batches[0], (list, tuple)):
        batches = [batches]
    for batch in batches:
        for ev in batch:
            if isinstance(ev, EdgeInsert):
                caps[(ev.u, ev.v)] = caps.get((ev.u, ev.v), 0) + int(ev.cap)
                caps.setdefault((ev.v, ev.u), 0)
            elif isinstance(ev, EdgeDelete):
                if (ev.u, ev.v) not in caps:
                    raise KeyError(f"delete of missing arc {ev.u}->{ev.v}")
                caps[(ev.u, ev.v)] = 0
            elif isinstance(ev, CapacityReweight):
                if (ev.u, ev.v) not in caps:
                    raise KeyError(f"re-weight of missing arc {ev.u}->{ev.v}")
                caps[(ev.u, ev.v)] = int(ev.cap)
            else:  # CapacityUpdate / (u, v, delta) tuples
                u, v, d = (ev.u, ev.v, ev.delta) if hasattr(ev, "delta") \
                    else ev
                if (u, v) not in caps:
                    raise KeyError(f"update of missing arc {u}->{v}")
                caps[(u, v)] += int(d)
                if caps[(u, v)] < 0:
                    raise ValueError(f"cap({u}->{v}) driven below zero")
    items = sorted(caps.items())
    edges = np.array([p for p, _ in items], np.int64).reshape(-1, 2)
    cap = np.array([c for _, c in items], np.int64)
    return Graph(g.n, edges, cap)
