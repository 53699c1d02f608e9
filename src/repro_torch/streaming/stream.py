"""Long-lived streaming graphs: apply edit events, query versions (port
of the JAX package's ``repro.streaming.stream``).

``StreamingGraph`` owns one client's mutable max-flow instance.  Each
``apply`` folds a batch of edit events (``EdgeInsert`` / ``EdgeDelete`` /
``CapacityReweight`` / ``CapacityUpdate`` / ``(u, v, delta)`` tuples)
into a *new version*: the previous version's phase-2-corrected flow is
reused — capacity increases re-enter the solver with a budgeted warm
start, decreases reroute the overflowed flow on-device
(``streaming.reroute``), and genuinely new arc pairs rebuild the CSR
*around* the routed flow (``rebuild_with_state``) so even structural
edits stay warm.  Updates whose reroute already restores maximality
(the warm start injects no excess) never dispatch the solver at all.

Versions live in a bounded-LRU ``VersionChain``
(``streaming.versioned``): ``query(version)`` addresses any retained
snapshot, ``pin`` holds one against eviction.  ``Solver.open_stream``
is the ``repro_torch.api`` entry point.  Every device step (the solve,
the drains, the warm re-solves, the views) runs on the solver's device;
a rebuilt handle keeps its predecessor's device and kernel hook.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import batched
from repro_torch.core.csr import Graph, ResidualCSR, build_residual
from repro_torch.obs import counter, span
from repro_torch.streaming.events import normalize_events
from repro_torch.streaming.versioned import VersionChain


def rebuild_with_state(r: ResidualCSR, res: np.ndarray, e: np.ndarray,
                       new_pairs) -> tuple[ResidualCSR, np.ndarray,
                                           np.ndarray]:
    """Rebuild the CSR with extra (zero-capacity) arc pairs, embedding the
    currently routed flow.

    ``new_pairs`` is ``[(u, v), ...]`` of directed pairs absent from
    ``r`` (neither direction exists — the CSR materialises both arcs of
    every coalesced pair).  The old arc set is a subset of the new one,
    so the phase-2-corrected ``res`` maps over arc-by-arc and the result
    is the *same* feasible maximum flow on the grown graph: inserted
    capacity arrives afterwards as ordinary increase deltas, keeping one
    warm-start path for structural and non-structural edits alike.
    Returns ``(r2, res2, e2)``.
    """
    n = r.n
    edges = np.stack([r.tails, r.heads], axis=1).astype(np.int64)
    caps = np.asarray(r.res0, np.int64)
    add = np.asarray([[u, v] for u, v in new_pairs], np.int64)
    g2 = Graph(n, np.concatenate([edges, add]),
               np.concatenate([caps, np.zeros(len(add), np.int64)]))
    r2 = build_residual(g2, r.layout)
    # old (tail, head) keys are unique (coalesced) and all present in r2
    key_old = r.tails.astype(np.int64) * n + r.heads
    key_new = r2.tails.astype(np.int64) * n + r2.heads
    order = np.argsort(key_new, kind="stable")
    pos = np.searchsorted(key_new[order], key_old)
    idx = order[pos]
    res2 = np.asarray(r2.res0, np.int64).copy()  # new arcs: empty, cap 0
    res2[idx] = np.asarray(res, np.int64)
    return (r2, batched.as_state_dtype(res2, "rebuilt res"),
            np.asarray(e, batched.STATE_DTYPE).copy())


class StreamingGraph:
    """One client's long-lived graph: versioned incremental re-solves.

    Construct via ``repro_torch.api.Solver.open_stream(problem)`` (or
    directly with a ``MaxflowProblem`` and an optional ``Solver``).
    Version 0 is the initial solve; every ``apply`` returns the id of the
    version it created.  ``query`` returns a full
    ``repro_torch.api.Solution`` (value, flows, min-cut views) for any
    retained version.
    """

    def __init__(self, problem, solver=None, max_versions: int = 8):
        from repro_torch.api.solver import Solver

        self._solver = solver if solver is not None else Solver()
        self._problem = problem
        self._chain = VersionChain(max_versions)
        self._closed = False
        self.n_applies = 0
        self.n_events = 0
        self.n_rebuilds = 0
        self.n_queries = 0
        sol = self._solver.solve(problem)
        if sol.warm_start is None:
            raise ValueError(
                f"backend {self._solver.options.backend!r} does not capture "
                "solver state and cannot back a stream")
        self._chain.append(sol.warm_start, sol.value, parent=None)

    # -- lifecycle ----------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def latest_version(self) -> int:
        return self._chain.latest

    @property
    def s(self) -> int:
        return self._problem.s

    @property
    def t(self) -> int:
        return self._problem.t

    def close(self) -> None:
        """Release every retained version; subsequent calls raise."""
        self._closed = True
        self._chain = VersionChain(1)  # drop handles (and their arrays)

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("stream is closed")

    # -- updates ------------------------------------------------------------

    def apply(self, events) -> int:
        """Fold a batch of edit events into a new version; returns its id.

        The base is always the latest version (updates chain linearly).
        Raises ``KeyError`` for a delete/re-weight of a missing arc,
        ``ValueError`` for empty event sets, self-loops, out-of-range
        vertices or capacities driven below zero.
        """
        self._check_open()
        base = self._chain.get(self._chain.latest)
        handle = base.handle
        with span("stream.apply", version=base.version):
            inserts, deltas = normalize_events(handle.residual, events)
            nev = len(inserts) + len(deltas)
            if nev == 0:
                raise ValueError("empty update event set")
            if inserts:
                self.n_rebuilds += 1
                counter("stream.structural_rebuilds").inc()
                r2, res2, e2 = rebuild_with_state(
                    handle.residual, *handle.arrays(),
                    [(u, v) for u, v, _ in inserts])
                handle = type(handle)(
                    r2, handle.s, handle.t, res2, e2, corrected=True,
                    use_kernel=handle._use_kernel, device=handle.device)
                # inserted capacity becomes plain increase deltas on the
                # rebuilt CSR — one downstream path for every edit kind
                deltas = deltas + [(u, v, cap) for u, v, cap in inserts]
            if deltas:
                sol = self._solver.resolve(handle, deltas)
                new_handle, value = sol.warm_start, sol.value
            else:  # cap-0 inserts only: the flow is untouched
                new_handle, value = handle, handle.maxflow
            version = self._chain.append(new_handle, value,
                                         parent=base.version, events=nev)
        self.n_applies += 1
        self.n_events += nev
        counter("stream.applies").inc()
        counter("stream.events").inc(nev)
        return version

    # -- queries ------------------------------------------------------------

    def query(self, version: int | None = None):
        """A ``repro_torch.api.Solution`` for ``version`` (default:
        latest), its ``state`` the version's phase-2-corrected flow on the
        handle's device (heights zero).  Raises ``KeyError`` if the
        version was evicted or never issued."""
        self._check_open()
        from repro_torch.api.problem import MaxflowProblem
        from repro_torch.api.solution import Solution, SolveStats
        from repro_torch.core import pushrelabel as pr

        with span("stream.query"):
            rec = self._chain.get(
                self._chain.latest if version is None else int(version))
        self.n_queries += 1
        counter("stream.queries").inc()
        h = rec.handle
        problem = MaxflowProblem.from_residual(h.residual, h.s, h.t)
        opts = self._solver.options
        stats = SolveStats(backend="stream", mode=opts.mode,
                           layout=h.residual.layout,
                           warm=rec.parent is not None)
        res, e = h.arrays()
        state = pr.state_from_numpy(res, np.zeros(h.residual.n, np.int32),
                                    e, h.device)
        return Solution(problem, rec.value, stats, h, state)

    def pin(self, version: int) -> None:
        """Hold ``version`` against LRU eviction until :meth:`unpin`."""
        self._check_open()
        self._chain.pin(version)

    def unpin(self, version: int) -> None:
        self._check_open()
        self._chain.unpin(version)

    def stats(self) -> dict:
        return {
            "applies": self.n_applies,
            "events": self.n_events,
            "queries": self.n_queries,
            "structural_rebuilds": self.n_rebuilds,
            "closed": self._closed,
            "chain": self._chain.stats(),
        }

    def __repr__(self) -> str:
        state = "closed" if self._closed else \
            f"latest=v{self._chain.latest}"
        return (f"StreamingGraph(n={self._problem.residual().n}, "
                f"s={self.s}, t={self.t}, {state})")


# ``repro_torch.api.Solver.open_stream`` documents its return type under this
# name; the class above is the implementation.
StreamHandle = StreamingGraph
