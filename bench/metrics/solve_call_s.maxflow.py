"""Seconds a max-flow request spends in ``Solver.solve`` up to the value on
the host."""
from bench.lib import readers


def read(ctx):
    return readers.mean_span(ctx, "solve_call")
