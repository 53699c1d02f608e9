"""Capacities the int32 state lattice cannot hold are refused at every
entry of the port (``pushrelabel.check_capacity_range``), on the CPU.

The reference wraps such capacities silently (JAX ``vc`` returns 0 on
``BIG`` and -2 on ``WRAP``); the port departs from it by design, toward
the README's dtype contract: ``OverflowError`` for an arc pair or a
source out-capacity above ``2**31 - 1``, ``ValueError`` for a negative
capacity, before anything is packed.  Checked on the ``single``,
``batched`` and ``distributed`` backends (gloo ranks at world size 1 and
2, in subprocesses started together), in every mode, through ``solve``,
``solve_many``, ``MaxflowService.submit`` and ``partition_graph``; after
increases through ``Solver.resolve``, ``WarmStartHandle.apply``,
``MaxflowService.resubmit``, ``StreamingGraph.apply`` and
``batched.apply_capacity_increases``, each of which leaves its handle,
service or stream usable.  A graph exactly at the bound solves to
Dinic's value everywhere, and in-range results are unchanged (every
other port test)."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.api import MaxflowProblem, Solver
from repro_torch.core import batched
from repro_torch.core import distributed as D
from repro_torch.core import pushrelabel as pr
from repro_torch.core.csr import Graph, build_residual
from repro_torch.core.ref_maxflow import dinic_maxflow
from repro_torch.serving import MaxflowService, ServiceConfig
from repro_torch.streaming.events import CapacityReweight, EdgeInsert

ROOT = pathlib.Path(__file__).resolve().parents[1]
BOUND = 2**31 - 1


def _graph(n, edges, caps):
    return Graph(n, np.array(edges, np.int64), np.array(caps, np.int64))


#: name -> (graph, the error every entry raises); s = 0, t = n - 1
BAD = {
    # a capacity past int32: the reference's batched / distributed give 0
    "big": (_graph(3, [[0, 1], [1, 2]], [2**33, 5]), OverflowError),
    # every capacity in range, the source's out-capacity 2**32 - 2: every
    # backend of both packages returns -2 (e[t] wraps)
    "wrap": (_graph(4, [[0, 1], [0, 2], [1, 3], [2, 3]], [BOUND] * 4),
             OverflowError),
    # two antiparallel arcs whose pair holds 2**31
    "pair": (_graph(3, [[0, 1], [1, 0], [1, 2]], [2**30, 2**30, 5]),
             OverflowError),
    "negative": (_graph(3, [[0, 1], [1, 2]], [-1, 5]), ValueError),
}
#: the source's out-capacity exactly 2**31 - 1, every pair within it
AT_BOUND = _graph(4, [[0, 1], [0, 2], [1, 3], [2, 3]],
                  [2**30, 2**30 - 1, BOUND, BOUND])
#: one below the bound at the source: an increase of 1 on a source arc
#: still fits, 2 does not
NEAR = _graph(4, [[0, 1], [0, 2], [1, 3], [2, 3]],
              [2**30, 2**30 - 2, 2**30, 2**30])
BACKENDS = ("single", "batched")
MODES = pr.ALL_MODES
ENV = {**os.environ, "OMP_NUM_THREADS": "1",
       "PYTHONPATH": str(ROOT / "src")}


def _problem(g):
    return MaxflowProblem(g, 0, g.n - 1)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(BAD))
def test_solve_refuses(name, backend, mode):
    g, err = BAD[name]
    solver = Solver(backend=backend, mode=mode, device="cpu")
    with pytest.raises(err):
        solver.solve(_problem(g))
    with pytest.raises(err):
        solver.solve_many([_problem(AT_BOUND), _problem(g)])


@pytest.mark.parametrize("name", sorted(BAD))
def test_messages_name_the_broken_bound(name):
    g, _ = BAD[name]
    want = {"big": "arc pair", "pair": "arc pair", "wrap": "out-capacity",
            "negative": "negative capacity"}[name]
    with pytest.raises((OverflowError, ValueError), match=want):
        pr.check_capacity_range(build_residual(g, "bcsr"), 0)


@pytest.mark.parametrize("name", sorted(BAD))
def test_service_submit_refuses_before_any_flush(name):
    g, err = BAD[name]
    svc = MaxflowService(ServiceConfig(mode="vc", device="cpu"))
    with pytest.raises(err):
        svc.submit(g, 0, g.n - 1)
    assert svc.stats()["batches"] == 0 and svc.stats()["pending"] == 0
    # the service goes on answering
    assert svc.submit(AT_BOUND, 0, 3).result().maxflow == BOUND


@pytest.mark.parametrize("mode", D.MODES)
@pytest.mark.parametrize("p", (1, 2, 4))
@pytest.mark.parametrize("name", sorted(BAD))
def test_partition_graph_refuses(name, p, mode):
    g, err = BAD[name]
    with pytest.raises(err):
        D.partition_graph(build_residual(g, "bcsr"), p, 0, g.n - 1, mode)


@pytest.mark.parametrize("layout", ("bcsr", "rcsr"))
def test_pack_instances_refuses(layout):
    insts = [(build_residual(AT_BOUND, layout), 0, 3),
             (build_residual(BAD["big"][0], layout), 0, 2)]
    with pytest.raises(OverflowError):
        batched.pack_instances(insts, device="cpu")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_at_the_bound_solves_to_dinic(backend, mode):
    want = dinic_maxflow(AT_BOUND, 0, 3)
    assert want == BOUND
    sol = Solver(backend=backend, mode=mode, device="cpu").solve(
        _problem(AT_BOUND))
    assert sol.value == want
    assert sol.min_cut().value == want
    assert int(sol.flows()[sol.warm_start.residual.pair_u == 0].sum()) \
        == want


# ---------------------------------------------------------------------------
# increases past the bound
# ---------------------------------------------------------------------------

def _near_solution(backend="single"):
    sol = Solver(backend=backend, device="cpu").solve(_problem(NEAR))
    assert sol.value == BOUND - 1
    return sol


@pytest.mark.parametrize("update,err", [((0, 2, 2), OverflowError),
                                        ((1, 3, 2**30), OverflowError),
                                        ((2, 3, -2**31), ValueError)])
@pytest.mark.parametrize("backend", BACKENDS)
def test_resolve_refuses_and_keeps_the_handle(backend, update, err):
    solver = Solver(device="cpu")
    sol = _near_solution(backend)
    handle = sol.warm_start
    with pytest.raises(err):
        solver.resolve(handle, [update])
    # the handle still serves its flow and re-solves within the bound
    assert handle.maxflow == BOUND - 1
    sol2 = solver.resolve(handle, [(0, 2, 1)])
    assert sol2.value == BOUND
    caps = NEAR.cap.copy()
    caps[1] += 1
    assert sol2.value == dinic_maxflow(Graph(4, NEAR.edges, caps), 0, 3)


def test_warm_start_handle_apply_refuses():
    handle = _near_solution().warm_start
    before = handle.residual.res0.copy()
    with pytest.raises(OverflowError, match="out-capacity"):
        handle.apply([(0, 1, 2)])
    assert np.array_equal(handle.residual.res0, before)
    r2, warm = handle.apply([(0, 1, 1)])
    assert warm is not None and int(r2.res0[r2.tails == 0].sum()) == BOUND


def test_service_resubmit_refuses_and_keeps_the_entry():
    svc = MaxflowService(ServiceConfig(mode="vc", device="cpu"))
    first = svc.submit(NEAR, 0, 3).result()
    assert first.maxflow == BOUND - 1
    with pytest.raises(OverflowError):
        svc.resubmit(first.graph_id, [(0, 1, 5)])
    assert svc.resubmit(first.graph_id, [(0, 2, 1)]).result().maxflow \
        == BOUND


def test_stream_apply_refuses_and_keeps_its_versions():
    stream = Solver(device="cpu").open_stream(_problem(NEAR))
    v0 = stream.latest_version
    with pytest.raises(OverflowError):
        stream.apply([CapacityReweight(0, 2, 2**30)])
    with pytest.raises(OverflowError):  # a new pair past the bound
        stream.apply([EdgeInsert(0, 3, 2**31)])
    assert stream.latest_version == v0
    assert stream.query().value == BOUND - 1
    v1 = stream.apply([CapacityReweight(0, 2, 2**30 - 1)])
    assert v1 != v0 and stream.query(v1).value == BOUND


def test_apply_capacity_increases_refuses():
    r = build_residual(NEAR, "bcsr")
    res = r.res0.copy()
    # an out-capacity past the bound is refused where the result is packed
    r2, _ = batched.apply_capacity_increases(r, res, [(0, 1, 2)])
    with pytest.raises(OverflowError, match="out-capacity"):
        batched.pack_instances([(r2, 0, NEAR.n - 1)], device="cpu")
    with pytest.raises(OverflowError, match="arc pair"):
        batched.apply_capacity_increases(r, res, [(1, 3, 2**30)])
    assert np.array_equal(r.res0, build_residual(NEAR, "bcsr").res0)


# ---------------------------------------------------------------------------
# the distributed backend: gloo ranks at world size 1 and 2
# ---------------------------------------------------------------------------

DIST_SCRIPT = r"""
import json, os, sys
rank, P, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    work, f"rendezvous_P{P}"), rank=rank, world_size=P)
from repro_torch.api import MaxflowProblem, Solver
from repro_torch.core import distributed as D
from repro_torch.core.csr import Graph, build_residual
spec = json.loads(open(os.path.join(work, "graphs.json")).read())
out = {}
for name, (n, edges, caps) in spec.items():
    g = Graph(n, np.array(edges, np.int64), np.array(caps, np.int64))
    p = MaxflowProblem(g, 0, n - 1)
    solver = Solver(backend="distributed", device="cpu")
    calls = [("solve", lambda: solver.solve(p).value),
             ("solve_many", lambda: [x.value
                                     for x in solver.solve_many([p, p])])]
    calls += [(f"impl[{m}]", lambda m=m: D.solve_distributed(
        build_residual(g, "bcsr"), 0, n - 1, mode=m, device="cpu"))
        for m in D.MODES]
    got = {}
    for what, call in calls:
        try:
            got[what] = call()
        except (OverflowError, ValueError) as exc:
            got[what] = type(exc).__name__
    out[name] = got
if rank == 0:
    with open(os.path.join(work, f"out_P{P}.json"), "w") as f:
        json.dump(out, f)
dist.destroy_process_group()
print("DIST-OK")
"""
DIST_SIZES = (1, 2)


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("overflow_dist")
    spec = {name: (g.n, g.edges.tolist(), g.cap.tolist())
            for name, (g, _) in BAD.items()}
    spec["at_bound"] = (AT_BOUND.n, AT_BOUND.edges.tolist(),
                        AT_BOUND.cap.tolist())
    (work / "graphs.json").write_text(json.dumps(spec))
    procs = [subprocess.Popen(
        [sys.executable, "-c", DIST_SCRIPT, str(rank), str(p), str(work)],
        env=ENV, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for p in DIST_SIZES for rank in range(p)]
    for proc in procs:
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err[-3000:]
        assert "DIST-OK" in out
    return {p: json.loads((work / f"out_P{p}.json").read_text())
            for p in DIST_SIZES}


@pytest.mark.parametrize("p", DIST_SIZES)
@pytest.mark.parametrize("name", sorted(BAD))
def test_distributed_refuses(dist_runs, name, p):
    err = BAD[name][1].__name__
    got = dist_runs[p][name]
    assert set(got) == {"solve", "solve_many"} | {f"impl[{m}]"
                                                  for m in D.MODES}
    assert all(v == err for v in got.values()), got


@pytest.mark.parametrize("p", DIST_SIZES)
def test_distributed_at_the_bound_solves_to_dinic(dist_runs, p):
    got = dist_runs[p]["at_bound"]
    assert got["solve"] == BOUND and got["solve_many"] == [BOUND, BOUND]
    assert all(got[f"impl[{m}]"] == BOUND for m in D.MODES)
