"""Typed problem specifications: what to solve, decoupled from how (port
of the JAX package's ``repro.api.problem``).

A problem owns its graph construction — it wraps ``csr.build_residual``
and caches one ``ResidualCSR`` per layout, so callers never juggle raw
CSR arrays and a solve can be re-run under a different layout without
rebuilding the problem.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.csr import Graph, ResidualCSR, build_residual
from repro_torch.graphs.generators import BipartiteProblem


@dataclasses.dataclass(eq=False)
class _ResidualOwner:
    """Shared residual-construction cache (one ``ResidualCSR`` per layout)."""

    def __post_init__(self):
        self._residuals: dict[str, ResidualCSR] = {}

    def residual(self, layout: str = "bcsr") -> ResidualCSR:
        r = self._residuals.get(layout)
        if r is None:
            if self.graph is None:
                built = sorted(self._residuals)
                raise ValueError(
                    f"problem was built from a prebuilt {built} residual "
                    f"and has no Graph to construct layout {layout!r} from")
            r = self._residuals[layout] = build_residual(self.graph, layout)
        return r


@dataclasses.dataclass(eq=False)
class MaxflowProblem(_ResidualOwner):
    """A single-commodity max-flow instance ``(graph, s, t)``."""

    graph: Graph | None
    s: int
    t: int

    def __post_init__(self):
        super().__post_init__()
        if self.graph is not None:
            n = self.graph.n
            if not (0 <= self.s < n and 0 <= self.t < n):
                raise ValueError(
                    f"terminals s={self.s}, t={self.t} out of range for "
                    f"n={n} vertices")

    @classmethod
    def from_arrays(cls, n: int, edges, caps, s: int, t: int):
        return cls(Graph(n, np.asarray(edges, np.int64),
                         np.asarray(caps, np.int64)), s, t)

    @classmethod
    def from_residual(cls, r: ResidualCSR, s: int, t: int):
        """Wrap a prebuilt residual (e.g. a warm-start product) directly."""
        p = cls(None, s, t)
        p._residuals[r.layout] = r
        return p

    @property
    def n(self) -> int:
        if self.graph is not None:
            return self.graph.n
        return next(iter(self._residuals.values())).n


class MinCutProblem(MaxflowProblem):
    """Same spec as max-flow; asks for the dual certificate.

    ``Solution.min_cut()`` is available on any max-flow solution — this
    subclass exists so intent is typed and ``Solution.value`` documents
    itself as the cut capacity (equal to the max flow by LP duality).
    """


@dataclasses.dataclass(eq=False)
class MatchingProblem(_ResidualOwner):
    """Maximum bipartite matching via unit-capacity max-flow.

    Wraps the generator's ``BipartiteProblem`` (super-source/super-sink
    construction already attached); matching size == max-flow value and
    the matched pairs come from ``Solution.matching()``.
    """

    bipartite: BipartiteProblem

    @property
    def graph(self) -> Graph:
        return self.bipartite.graph

    @property
    def s(self) -> int:
        return self.bipartite.s

    @property
    def t(self) -> int:
        return self.bipartite.t

    @property
    def n_left(self) -> int:
        return self.bipartite.n_left

    @property
    def n_right(self) -> int:
        return self.bipartite.n_right

    @property
    def n(self) -> int:
        return self.graph.n
