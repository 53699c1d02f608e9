"""Seconds a max-flow request spends in its ``flows`` and ``min_cut``
views."""
from bench.lib import readers


def read(ctx):
    return readers.mean_span(ctx, "views")
