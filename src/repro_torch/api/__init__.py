"""Solver facade: Problem -> Solver -> Solution (port of the JAX package's
``repro.api`` for one instance)::

    from repro_torch.api import MaxflowProblem, Solver, SolverOptions

    problem = MaxflowProblem(graph, s, t)
    solution = Solver(SolverOptions(mode="vc_kernel_bsearch")).solve(problem)
    solution.value            # max-flow value
    solution.state            # final PRState (res, h, e) on the card
    solution.flows()          # per-edge flows (phase 2 on the card)
    solution.min_cut()        # the saturated cut of capacity value
    Solver().resolve(solution.warm_start, [(u, v, +5)])  # warm re-solve
    stream = Solver().open_stream(problem)  # versioned streaming session
"""
from repro_torch.api.options import SolverOptions  # noqa: F401
from repro_torch.api.problem import (MatchingProblem,  # noqa: F401
                                     MaxflowProblem, MinCutProblem)
from repro_torch.api.solution import (CapacityUpdate, Solution,  # noqa: F401
                                      SolveStats, WarmStartHandle)
from repro_torch.api.solver import Solver  # noqa: F401

__all__ = [
    "CapacityUpdate",
    "MatchingProblem",
    "MaxflowProblem",
    "MinCutProblem",
    "Solution",
    "SolveStats",
    "Solver",
    "SolverOptions",
    "WarmStartHandle",
]
