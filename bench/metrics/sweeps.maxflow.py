"""Global-relabel sweeps of a max-flow request (``SolveStats.gr_sweeps``)."""
from bench.lib import readers


def read(ctx):
    return readers.mean_counter(ctx, "sweeps")
