"""Share of the traced request in which the device ran nothing."""
from bench.lib import readers


def read(ctx):
    return readers.idle_pct(ctx)
