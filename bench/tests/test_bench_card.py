"""On a card: one short run of each cell prints a correct result with
every end-to-end metric, and a traced one every per-layer metric.
Skipped without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench.lib import spec

SPEC = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_runs_on_the_card(card, cell, trace):
    p = subprocess.run(
        [sys.executable, str(spec.BENCH / "run.py"), "--workload", cell,
         "--seed", "4000000001", "--seconds", "1", "--trace", str(trace)],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    c = spec.load_cell(cell)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(out["metrics"]) == want
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
