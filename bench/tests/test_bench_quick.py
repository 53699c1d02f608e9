"""The CPU rehearsal (``--quick``) of each cell prints a last line of the
contract's shape, with no time or device reading, and loads nothing of
JAX or the JAX package (the run exits 2 where it has)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench.lib.spec import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def run(*args):
    return subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"),
                           *args], capture_output=True, text=True,
                          cwd=ROOT, timeout=300)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_quick_rehearsal_prints_the_result_line(cell, trace):
    p = run("--workload", cell, "--seed", str(2**31 + 7), "--seconds", "0.5",
            "--trace", str(trace), "--quick")
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert out["device"]["platform"] == "cpu"
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    counters = {m["name"] for m in spec["per_layer"]
                if m["source"] == "program_counter"
                and cell in m["workloads"]}
    assert set(out["metrics"]) == (counters if trace else set())
    checks = [ln for ln in p.stderr.strip().splitlines()
              if ln.startswith("check ")]
    assert len(checks) == len(out["checks"]) and checks == \
        p.stderr.strip().splitlines()[-len(checks):]
    for name, c in out["checks"].items():
        assert c == {"value": 0, "limit": 0}, name


def test_no_card_no_result():
    p = run("--workload", CELLS[0], "--seed", "1", "--seconds", "1",
            "--trace", "0")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    assert p.returncode == 1 and p.stdout.strip() == ""
