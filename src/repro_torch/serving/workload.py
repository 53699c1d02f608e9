"""Synthetic serving workloads: stochastic arrivals over a mixed request set
(a copy of the JAX package's ``repro.serving.workload``: the same seed
gives the same items and arrays).

Models the traffic regime the serving subsystem targets: many
small-to-medium max-flow and bipartite-matching queries in a handful of
size classes, with a configurable fraction of exact repeats (result-cache
hits) and of *edits* of earlier graphs (capacity bumps -> warm-started
re-solves).

Four arrival processes (all seed-deterministic; ``arrival_times``):
``poisson`` (the steady-state baseline), ``bursty`` (Markov-modulated:
short high-rate bursts between idle lulls — stresses queue depth),
``diurnal`` (sinusoidally-modulated rate over one "day" — peak-hour
pressure with recovery troughs) and ``flood`` (everything lands at once —
the open-loop stampede admission control exists for).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs import generators as G

#: arrival shapes ``synthesize``/``arrival_times`` accept
ARRIVAL_PROCESSES = ("poisson", "bursty", "diurnal", "flood")


@dataclasses.dataclass
class WorkItem:
    arrival_s: float  # arrival offset from workload start
    kind: str  # 'maxflow' | 'matching' | 'repeat' | 'resubmit'
    graph: object = None  # Graph for maxflow, BipartiteProblem for matching
    s: int = 0
    t: int = 0
    repeat_of: int = -1  # index of the item this repeats / edits
    updates: list = dataclasses.field(default_factory=list)
    deadline_s: float | None = None  # relative deadline carried to submit


def arrival_times(num: int, rate_hz: float = 200.0,
                  process: str = "poisson", seed: int = 0,
                  rng=None) -> np.ndarray:
    """``num`` monotone arrival offsets (seconds) under one of
    ``ARRIVAL_PROCESSES``, at mean rate ``rate_hz``.  Deterministic for a
    fixed ``(num, rate_hz, process, seed)``."""
    rng = np.random.default_rng(seed) if rng is None else rng
    if process == "poisson":
        return np.cumsum(rng.exponential(1.0 / rate_hz, size=num))
    if process == "bursty":
        # Markov-modulated Poisson: geometric bursts at 10x the mean rate
        # separated by idle lulls.  Mean rate stays ~rate_hz; the queues
        # see it as alternating stampede/starvation.
        times: list[float] = []
        clock = 0.0
        while len(times) < num:
            burst = 1 + int(rng.geometric(0.2))
            for _ in range(min(burst, num - len(times))):
                clock += float(rng.exponential(1.0 / (10.0 * rate_hz)))
                times.append(clock)
            clock += float(rng.exponential(4.0 / rate_hz))
        return np.asarray(times)
    if process == "diurnal":
        # inhomogeneous Poisson with a sinusoidal rate over one "day"
        # (the workload's own span): peak hours run ~1.8x the mean rate,
        # troughs ~0.2x — sustained pressure with recovery windows
        period = max(num / rate_hz, 1e-9)
        times = []
        clock = 0.0
        for _ in range(num):
            r = rate_hz * (1.0 + 0.8 * np.sin(2.0 * np.pi * clock / period))
            clock += float(rng.exponential(1.0 / max(r, 0.05 * rate_hz)))
            times.append(clock)
        return np.asarray(times)
    if process == "flood":
        # open-loop stampede: every request lands (essentially) at once —
        # the case bounded queues + typed rejections exist for
        return np.sort(rng.uniform(0.0, 1e-3, size=num))
    raise ValueError(
        f"unknown arrival process {process!r}; one of {ARRIVAL_PROCESSES}")


# (family, size) classes keep traffic inside a few shape buckets; the
# grids are deep enough that routing takes several relabel rounds (the
# regime where warm re-solves pay off)
_MAXFLOW_CLASSES = [
    ("sparse", 60), ("sparse", 120), ("grid", 12), ("grid", 16),
]
_MATCHING_CLASSES = [(40, 25), (80, 50)]


def _fresh_instance(rng, matching_frac: float):
    if rng.random() < matching_frac:
        L, R = _MATCHING_CLASSES[rng.integers(len(_MATCHING_CLASSES))]
        bp = G.bipartite_random(L, R, 3.0, seed=int(rng.integers(1 << 30)))
        return WorkItem(0.0, "matching", graph=bp, s=bp.s, t=bp.t)
    fam, size = _MAXFLOW_CLASSES[rng.integers(len(_MAXFLOW_CLASSES))]
    seed = int(rng.integers(1 << 30))
    if fam == "sparse":
        g, s, t = G.random_sparse(size, 4 * size, max_cap=20, seed=seed)
    else:
        g, s, t = G.grid_road(size, size, max_cap=10, seed=seed)
    return WorkItem(0.0, "maxflow", graph=g, s=s, t=t)


def _capacity_bumps(rng, item: WorkItem, k: int = 1):
    """Small positive-capacity edits on existing edges of a maxflow item.
    One edit lands on a source-adjacent and one on a sink-adjacent edge so
    the update opens real s-t capacity (the warm re-solve then has flow to
    route, not just a no-op relabel); edits are small relative to the total
    flow — the incremental regime warm starts target."""
    g = item.graph
    picks = list(rng.choice(g.m, size=min(k, g.m), replace=False))
    src_adj = np.where(g.edges[:, 0] == item.s)[0]
    snk_adj = np.where(g.edges[:, 1] == item.t)[0]
    if src_adj.size:
        picks.append(int(src_adj[rng.integers(src_adj.size)]))
    if snk_adj.size:
        picks.append(int(snk_adj[rng.integers(snk_adj.size)]))
    return [(int(g.edges[a, 0]), int(g.edges[a, 1]),
             int(rng.integers(1, 5))) for a in set(picks)
            if g.edges[a, 0] != g.edges[a, 1]]


def synthesize(num_requests: int, rate_hz: float = 200.0, seed: int = 0,
               matching_frac: float = 0.3, repeat_frac: float = 0.15,
               resubmit_frac: float = 0.2, process: str = "poisson",
               deadline_s: float | None = None) -> list[WorkItem]:
    """Arrival stream of ``num_requests`` mixed work items under the
    ``process`` arrival shape (see ``ARRIVAL_PROCESSES``).

    ``repeat_frac`` of items re-ask an earlier graph verbatim;
    ``resubmit_frac`` re-ask an earlier *maxflow* graph with capacity
    increases (warm-start candidates).  The remainder are fresh instances,
    ``matching_frac`` of which are bipartite matchings.  ``deadline_s``
    attaches the same relative deadline to every item (None = none).

    Arrival times draw from their own derived rng stream, so the item
    *content* for a given seed is identical across processes — the same
    graphs under different traffic shapes compare apples-to-apples.
    """
    rng = np.random.default_rng(seed)
    arrivals = arrival_times(
        num_requests, rate_hz, process,
        rng=np.random.default_rng([seed, 0xA221]))
    items: list[WorkItem] = []
    for k in range(num_requests):
        clock = float(arrivals[k])
        roll = rng.random()
        prior_mf = [i for i, it in enumerate(items) if it.kind == "maxflow"]
        if roll < repeat_frac and items:
            src = int(rng.integers(len(items)))
            base = items[src]
            while base.kind in ("repeat", "resubmit"):  # chase to original
                src = base.repeat_of
                base = items[src]
            item = WorkItem(clock, "repeat", repeat_of=src)
        elif roll < repeat_frac + resubmit_frac and prior_mf:
            src = int(prior_mf[rng.integers(len(prior_mf))])
            item = WorkItem(clock, "resubmit", repeat_of=src,
                            updates=_capacity_bumps(rng, items[src]))
        else:
            item = _fresh_instance(rng, matching_frac)
            item.arrival_s = clock
        item.deadline_s = deadline_s
        items.append(item)
    return items


def updated_graph(base: WorkItem, updates):
    """A resubmit target as a standalone ``(Graph, s, t)`` — the extra
    parallel edges coalesce into the capacity bumps at CSR build time."""
    from repro_torch.core.csr import Graph

    g = base.graph
    extra = np.array([(u, v) for u, v, _ in updates], np.int64)
    ecap = np.array([d for _, _, d in updates], np.int64)
    return (Graph(g.n, np.concatenate([g.edges, extra.reshape(-1, 2)]),
                  np.concatenate([g.cap, ecap])), base.s, base.t)


def resolve_item(items: list[WorkItem], item: WorkItem):
    """The standalone ``(Graph, s, t)`` a work item denotes (chasing
    repeats/resubmits back to their base) — what a sequential,
    cache-less solver would be handed for it."""
    if item.kind == "resubmit":
        return updated_graph(items[item.repeat_of], item.updates)
    base = items[item.repeat_of] if item.kind == "repeat" else item
    if base.kind == "matching":
        return base.graph.graph, base.graph.s, base.graph.t
    return base.graph, base.s, base.t


def drive(service, items: list[WorkItem],
          poll_every: int = 1) -> list[dict]:
    """Feed a workload through a ``MaxflowService`` in arrival order,
    polling every ``poll_every`` admissions; returns one record per item:
    ``{"kind", "result", "latency_s", "error"}`` — exactly one of
    ``result``/``error`` is set.

    Error-tolerant by design: typed rejections (``Overloaded``,
    ``DeadlineExceeded``) and terminal failures (``DispatchFailed``) are
    *recorded*, not raised — an overloaded service degrades the workload,
    it does not kill the driver.  A resubmit whose base failed falls back
    to a cold submit of the resolved edited graph (the answer a client
    retrying against a lossy service would reconstruct).

    ``poll_every > 1`` models a driver that services completions less
    often than admissions — queue depth builds between polls, which is
    how a bounded queue actually overflows under a flood.
    """
    from repro_torch.errors import ServiceError

    futures: list = [None] * len(items)
    errors: list = [None] * len(items)

    def _base_result(idx: int):
        """The base item's MaxflowResult, or None if it failed."""
        fut = futures[idx]
        if fut is None:
            return None
        try:
            return fut.result()
        except ServiceError:
            return None

    for i, item in enumerate(items):
        try:
            if item.kind == "matching":
                futures[i] = service.submit_matching(
                    item.graph, deadline_s=item.deadline_s)
            elif item.kind == "maxflow":
                futures[i] = service.submit(item.graph, item.s, item.t,
                                            deadline_s=item.deadline_s)
            elif item.kind == "repeat":
                base = items[item.repeat_of]
                if base.kind == "matching":
                    futures[i] = service.submit_matching(
                        base.graph, deadline_s=item.deadline_s)
                else:
                    futures[i] = service.submit(
                        base.graph, base.s, base.t,
                        deadline_s=item.deadline_s)
            elif item.kind == "resubmit":
                # warm start needs the base's cached residual -> force it
                base_res = _base_result(item.repeat_of)
                if base_res is None:  # base was rejected/shed/failed:
                    g, s, t = resolve_item(items, item)  # cold re-ask
                    futures[i] = service.submit(
                        g, s, t, deadline_s=item.deadline_s)
                else:
                    futures[i] = service.resubmit(
                        base_res.graph_id, item.updates,
                        deadline_s=item.deadline_s)
            else:
                raise ValueError(f"unknown work item kind {item.kind!r}")
        except ServiceError as exc:
            errors[i] = exc
        if (i + 1) % max(poll_every, 1) == 0:
            service.poll()
    service.flush()
    records = []
    for item, fut, err in zip(items, futures, errors):
        rec = {"kind": item.kind, "result": None, "latency_s": None,
               "error": err}
        if fut is not None and err is None:
            try:
                rec["result"] = fut.result()
                rec["latency_s"] = fut.latency_s
            except ServiceError as exc:
                rec["error"] = exc
        records.append(rec)
    return records
