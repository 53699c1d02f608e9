"""A cold max flow on one of the run's graphs, through the facade:
``Solver.solve(MaxflowProblem)``, then the ``flows`` and ``min_cut``
views."""
from __future__ import annotations

from bench.lib.request import Pool, Spans, worst
from bench.reference import certify
from bench.reference.pairs import PairTable

CONTROL = "preflow_flows"
FAULTS = ("stalled_step", "value_altered", "flow_altered")


class Driver(Pool):
    def request(self, i: int, spans: Spans) -> dict:
        from repro_torch.api import MaxflowProblem
        from repro_torch.core.csr import Graph

        k, inst = self.instance(i)
        with spans("solve_call"):
            problem = MaxflowProblem(Graph(inst.n, inst.edges, inst.cap),
                                     inst.s, inst.t)
            sol = self.solver.solve(problem)
            value = sol.value
        with spans("views"):
            flows = sol.flows()
            side = sol.min_cut().source_side
        self.answers.append((k, value, flows, side))
        return {"cycles": sol.stats.cycles, "sweeps": sol.stats.gr_sweeps}

    def check(self) -> dict:
        insts = self.instances
        tables = {k: PairTable.from_edges(insts[k].n, insts[k].edges,
                                          insts[k].cap)
                  for k in {a[0] for a in self.answers}}
        return worst(
            certify.maxflow(tables[k], insts[k].s, insts[k].t, value, flows,
                            side)
            for k, value, flows, side in self.answers)
