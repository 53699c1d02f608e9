"""With the timed path broken underneath, a run's ``correct`` comes out
false: for each control and each fault a cell can have.  The look for a
card is skipped (the CPU rehearsal's sizes, on the plain path)."""
from __future__ import annotations

import contextlib
import json
import time

import pytest
import torch
from conftest import spec as benchmark

from bench.lib import faults, harness, request, spec

CELLS = {w["name"]: w for w in benchmark()["workloads"]}


def cases():
    for name, w in CELLS.items():
        kind = request.load(json.loads(
            (spec.BENCH / "traffic" / f"{w['traffic']}.json").read_text())[
                "kind"])
        for inject in sorted({kind.CONTROL, *kind.FAULTS}):
            yield name, inject


def quick_run(cell, seed, inject=None):
    c = spec.load_cell(cell)
    with faults.INJECT[inject]() if inject else contextlib.nullcontext():
        return harness.run(c, seed, 0.5, False, torch.device("cpu"),
                           time.perf_counter(), quick=True)


@pytest.mark.parametrize("cell", list(CELLS))
def test_sound_run_is_correct(cell):
    out = quick_run(cell, 5)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("cell,inject", list(cases()))
def test_broken_path_is_not_correct(cell, inject):
    out = quick_run(cell, 5, inject)
    assert out["correct"] is False
    assert out["failed"] or any(c["value"] > c["limit"]
                                for c in out["checks"].values())


def test_every_fault_restores_the_program():
    from repro_torch.api.solution import Solution
    from repro_torch.core import pushrelabel

    def now():
        return (Solution.flows, Solution.matching, Solution.__init__,
                pushrelabel.run_cycles,
                pushrelabel.globalrelabel.global_relabel_impl)

    before = now()
    for make in faults.INJECT.values():
        with make():
            assert now() != before
    assert now() == before
