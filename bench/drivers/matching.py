"""A maximum bipartite matching on one of the run's graphs, through the
facade: ``Solver.solve(MatchingProblem)``, then the ``matching`` view."""
from __future__ import annotations

import numpy as np

from bench.lib.request import Pool, Spans, worst
from bench.reference import certify

CONTROL = "greedy_matching"
FAULTS = ("stalled_step", "value_altered", "pair_altered")


def _lr(inst) -> np.ndarray:
    """A bipartite instance's left-right edges (its edge list leads with
    them, before the terminals' edges)."""
    return inst.edges[: len(inst.edges) - inst.n_left - inst.n_right]


class Driver(Pool):
    def request(self, i: int, spans: Spans) -> dict:
        from repro_torch.api import MatchingProblem
        from repro_torch.core.csr import Graph
        from repro_torch.graphs.generators import BipartiteProblem

        k, inst = self.instance(i)
        with spans("solve_call"):
            problem = MatchingProblem(BipartiteProblem(
                Graph(inst.n, inst.edges, inst.cap), inst.s, inst.t,
                inst.n_left, inst.n_right, _lr(inst)))
            sol = self.solver.solve(problem)
            value = sol.value
        with spans("views"):
            pairs = sol.matching()
        self.answers.append((k, value, pairs))
        return {"cycles": sol.stats.cycles, "sweeps": sol.stats.gr_sweeps}

    def check(self) -> dict:
        insts = self.instances
        return worst(
            certify.matching(insts[k].n_left, insts[k].n_right,
                             _lr(insts[k]), value, pairs)
            for k, value, pairs in self.answers)
