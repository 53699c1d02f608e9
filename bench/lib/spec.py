"""Finding a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration (``bench/configs/<config>.json``), its traffic mix
(``bench/traffic/<traffic>.json``) and the reader of each of its
per-layer metrics (``bench/metrics/<metric>.py``)."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

#: the root of the checkout, which holds ``BENCHMARK.json``, ``bench/``
#: and the program under ``src/``
ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, benchmark: pathlib.Path | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; ``KeyError`` if there is
    none."""
    spec = json.loads((benchmark or ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    cfg = next(c for c in spec["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((ROOT / cfg["file"]).read_text()),
        traffic=json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def load_metric(name: str):
    """The reader module of the per-layer metric ``name``: its
    ``read(ctx)`` returns the value, or ``None`` where the run holds
    nothing to read."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
