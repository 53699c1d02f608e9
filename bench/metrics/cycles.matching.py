"""Push-relabel cycles of a matching request (``SolveStats.cycles``)."""
from bench.lib import readers


def read(ctx):
    return readers.mean_counter(ctx, "cycles")
