"""Every configuration, traffic mix, graph family, request kind and metric
that BENCHMARK.json names loads by its name."""
from __future__ import annotations

import json

import pytest
from conftest import spec as benchmark

from bench.lib import spec

SPEC = benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_loads(cell):
    c = spec.load_cell(cell)
    assert c.config["name"] == next(
        w["config"] for w in SPEC["workloads"] if w["name"] == cell)
    names = {m["name"] for m in c.end_to_end}
    assert {"setup_s", "peak_mem_gib", c.traffic["request_metric"]} <= names
    assert c.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_loads(metric):
    assert callable(spec.load_metric(metric).read)


def test_every_file_is_named():
    names = {m["name"] for m in SPEC["per_layer"]}
    files = {p.name[:-3] for p in (spec.BENCH / "metrics").glob("*.py")}
    assert names == files
    traffic = {w["traffic"] for w in SPEC["workloads"]}
    assert traffic == {p.stem for p in (spec.BENCH / "traffic").glob("*.json")}
    for cfg in SPEC["configs"]:
        assert json.loads((spec.ROOT / cfg["file"]).read_text())[
            "name"] == cfg["name"]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")


@pytest.mark.parametrize("cfg", [c["name"] for c in SPEC["configs"]])
def test_family_loads_by_name(cfg):
    from bench.gen import graphs

    c = json.loads((spec.ROOT / next(
        x["file"] for x in SPEC["configs"] if x["name"] == cfg)).read_text())
    assert callable(graphs.family(c["family"]).make)


@pytest.mark.parametrize("traffic", sorted({w["traffic"]
                                            for w in SPEC["workloads"]}))
def test_request_kind_loads_by_name(traffic):
    from bench.lib import faults, request

    kind = json.loads((spec.BENCH / "traffic" / f"{traffic}.json")
                      .read_text())["kind"]
    mod = request.load(kind)
    assert callable(mod.Driver)
    assert {mod.CONTROL, *mod.FAULTS} <= set(faults.INJECT)


def test_unknown_family_and_kind_are_refused():
    from bench.gen import graphs
    from bench.lib import request

    for bad in ("no_such_family", "graphs"):
        with pytest.raises(KeyError):
            graphs.family(bad)
    with pytest.raises(KeyError):
        request.load("no_such_kind")
