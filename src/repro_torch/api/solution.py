"""Solve results (port of the JAX package's ``repro.api.solution`` for the
single backend).  A ``Solution`` carries the value, the counters and the
final solver state; the views that need phase 2 (flows, min cut,
matching, warm starts) raise until phase 2 is ported."""
from __future__ import annotations

import dataclasses

from repro_torch.core.pushrelabel import PRState

#: the ROADMAP.md entry the phase-2 views wait on
_PHASE2 = ("needs phase 2 (preflow -> flow), which is not ported yet "
           "(see ROADMAP.md Queue 1, 'Phase 2, result views and the facade')")


@dataclasses.dataclass
class SolveStats:
    """Execution counters."""

    cycles: int = 0  # push-relabel iterations spent
    rounds: int = 0  # [cycles -> global relabel] rounds
    global_relabels: int = 0
    gr_sweeps: int = 0  # Bellman-Ford sweeps across all global relabels
    backend: str = "single"
    mode: str = "vc"
    layout: str = "bcsr"


class Solution:
    """The result of one solve.

    ``value`` is the max-flow value (== cut capacity for min-cut
    problems); ``state`` is the final ``PRState`` — a maximum *preflow*,
    with stranded excess at deactivated vertices — on the solve's device.
    """

    def __init__(self, problem, value: int, stats: SolveStats,
                 state: PRState):
        self.problem = problem
        self.value = int(value)
        self.stats = stats
        self.state = state

    @property
    def warm_start(self):
        raise NotImplementedError(f"warm starts {_PHASE2}")

    def flows(self):
        raise NotImplementedError(f"flows() {_PHASE2}")

    def min_cut(self):
        raise NotImplementedError(f"min_cut() {_PHASE2}")

    def matching(self):
        raise NotImplementedError(f"matching() {_PHASE2}")

    def __repr__(self) -> str:
        return (f"Solution(value={self.value}, backend="
                f"{self.stats.backend!r}, mode={self.stats.mode!r}, "
                f"cycles={self.stats.cycles})")
