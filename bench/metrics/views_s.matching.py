"""Seconds a matching request spends in its ``matching`` view."""
from bench.lib import readers


def read(ctx):
    return readers.mean_span(ctx, "views")
