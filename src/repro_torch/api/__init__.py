"""Solver facade: Problem -> Solver -> Solution (port of the JAX package's
``repro.api`` for one instance)::

    from repro_torch.api import MaxflowProblem, Solver, SolverOptions

    problem = MaxflowProblem(graph, s, t)
    solution = Solver(SolverOptions(mode="vc_kernel_bsearch")).solve(problem)
    solution.value            # max-flow value
    solution.state            # final PRState (res, h, e) on the card
"""
from repro_torch.api.options import SolverOptions  # noqa: F401
from repro_torch.api.problem import MaxflowProblem, MinCutProblem  # noqa: F401
from repro_torch.api.solution import Solution, SolveStats  # noqa: F401
from repro_torch.api.solver import Solver  # noqa: F401

__all__ = [
    "MaxflowProblem",
    "MinCutProblem",
    "Solution",
    "SolveStats",
    "Solver",
    "SolverOptions",
]
