"""Solver core: residual layouts, push-relabel, global relabel and the
sweep engine."""
