"""A metric file that names a kernel names an entry the program has, and
counts a call's bytes from its shapes alone; the traced request's
wrappers count those calls and leave the program as it was."""
from __future__ import annotations

import importlib
import time

import pytest
import torch
from conftest import spec as benchmark

from bench.lib import devtrace, harness, spec

KERNEL_METRICS = [m["name"] for m in benchmark()["per_layer"]
                  if hasattr(spec.load_metric(m["name"]), "SYMBOL")]


@pytest.mark.parametrize("metric", KERNEL_METRICS)
def test_entry_is_the_programs(metric):
    mod = spec.load_metric(metric)
    assert isinstance(mod.SYMBOL, tuple) and all(mod.SYMBOL)
    if hasattr(mod, "ENTRY"):
        where, attr = mod.ENTRY.split(":")
        assert callable(getattr(importlib.import_module(where), attr))
        assert callable(mod.bytes_of)


def test_dense_bytes_come_from_shapes():
    mod = spec.load_metric("gather_dense_roofline")
    n, a = 10, 37
    indptr = torch.zeros(2, n + 1, dtype=torch.int32)
    res = torch.ones(2, a, dtype=torch.int32)
    h = torch.zeros(2, n, dtype=torch.int32)
    assert mod.bytes_of(None, indptr, res, res, h, n=n) == \
        4.0 * 2 * ((n + 1) + a + 2 * n)
    # the same shapes, other data: the same count
    assert mod.bytes_of(None, indptr, res * 0, res * 0, h, n=n) == \
        mod.bytes_of(None, indptr, res, res, h, n=n)
    assert mod.bytes_of(torch.zeros(2, 4, dtype=torch.int32), indptr, res,
                        res, h, n=n) is None


def test_rev_bytes_come_from_shapes():
    mod = spec.load_metric("gather_rev_roofline")
    avq = torch.zeros(3, 8, dtype=torch.int32)
    assert mod.bytes_of(avq, None, None, None, None, None, n=5,
                        deg_max=2) == 16.0 * 24


def test_traced_request_counts_calls_and_restores_the_program():
    from repro_torch.kernels import ops

    before = (ops.tile_min_neighbor_gather, ops.tile_min_neighbor_gather_rev)
    cell = spec.load_cell("rlg1m-solve")
    out = harness.run(cell, 3, 0.2, True, torch.device("cpu"),
                      time.perf_counter(), quick=True)
    assert out["correct"] is True
    assert (ops.tile_min_neighbor_gather,
            ops.tile_min_neighbor_gather_rev) == before
    metrics = {m["name"]: spec.load_metric(m["name"])
               for m in cell.per_layer}
    tracer = devtrace.DeviceTrace(torch.device("cpu"), metrics)
    g = harness.request.load("maxflow").Driver(
        harness._merge(cell.config, cell.config["quick"]), cell.traffic, 3,
        torch.device("cpu"))
    with tracer:
        g.request(0, harness.Spans())
    assert ops.tile_min_neighbor_gather is before[0]
    r = tracer.readings["gather_dense_roofline"]
    assert r.calls > 0 and r.bytes > 0
