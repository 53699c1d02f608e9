"""The port's streaming tier against the JAX package's, on the same numpy
inputs: the device drain of capacity decreases (``apply_signed``, single
and pooled, the multi-sink distances and the deficit step, on the plain
path and on the kernel hook, whose plain version the CPU runs), the
stall and its cold re-solve, ``Solver.resolve`` with decreases on the
single and the batched backend, the edit events, the version chain, the
update traces, ``StreamingGraph`` replays and the span tracer.  JAX runs
on its plain path, as ``tests/test_streaming.py`` runs it.  Tolerance:
exact equality."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import CapacityUpdate as JUpdate
from repro.api import MaxflowProblem as JMaxflowProblem
from repro.api import Solver as JSolver
from repro.api import WarmStartHandle as JHandle
from repro.core import batched as jb
from repro.core import pushrelabel as jpr
from repro.core.csr import Graph as JGraph
from repro.core.csr import build_residual
from repro.graphs import generators as jgen
from repro.obs import REGISTRY as JREGISTRY
from repro.obs import trace as jtrace
from repro.streaming import events as jev
from repro.streaming import reroute as jrr
from repro.streaming import stream as jstream
from repro.streaming import versioned as jver
from repro_torch.api import CapacityUpdate, MaxflowProblem, Solver
from repro_torch.api import WarmStartHandle
from repro_torch.core import batched as tb
from repro_torch.core import pushrelabel as tpr
from repro_torch.core.csr import residual_from_arrays
from repro_torch.graphs import generators as tgen
from repro_torch.obs import REGISTRY, TRACER, Tracer
from repro_torch.obs import trace as ttrace
from repro_torch.streaming import (CapacityReweight, EdgeDelete, EdgeInsert,
                                   StreamingGraph, VersionChain,
                                   normalize_events, reroute)
from repro_torch.streaming import stream as tstream
from tests.conftest import random_graph

SEEDS = range(6)


def _port(rj):
    return residual_from_arrays(**dataclasses.asdict(rj))


def _tgraph(gj):
    return tgen.Graph(gj.n, gj.edges.copy(), gj.cap.copy())


def _flow(seed, layout="bcsr", n_lo=8, n_hi=40):
    """A JAX-solved corrected flow on a seeded random graph: ``(jax
    residual, port residual, res, e, s, t, rng)``."""
    rng = np.random.default_rng(seed)
    g = random_graph(rng, n_lo=n_lo, n_hi=n_hi)
    rj = build_residual(g, layout)
    sol = jpr.solve_impl(rj, 0, g.n - 1)
    res = jpr.convert_preflow_to_flow(rj, sol.state, 0, g.n - 1)
    e = np.zeros(g.n, np.int32)
    e[g.n - 1] = sol.maxflow
    return rj, _port(rj), res.astype(np.int32), e, 0, g.n - 1, rng


def _overflowing_updates(rng, r, res, k_hi=5):
    """Mixed-sign updates on existing arcs whose decreases take arcs that
    carry flow below it (so they overflow), never below zero."""
    res0 = np.asarray(r.res0, np.int64)
    flow = res0 - res
    carrying = np.nonzero((res0 > 0) & (flow > 0))[0]
    fwd = np.nonzero(res0 > 0)[0]
    ups = []
    for a in rng.choice(carrying, size=min(int(rng.integers(1, k_hi)),
                                           carrying.size), replace=False):
        ups.append((int(r.tails[a]), int(r.heads[a]),
                    -int(rng.integers(res0[a] - flow[a] + 1, res0[a] + 1))))
    for a in rng.choice(fwd, size=min(2, fwd.size), replace=False):
        if rng.random() < 0.5:
            ups.append((int(r.tails[a]), int(r.heads[a]),
                        int(rng.integers(1, 9))))
    return ups


def _same_result(got, want):
    for f in ("value", "budget", "overflow", "rerouted", "ok"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.res, want.res)
    np.testing.assert_array_equal(got.e, want.e)
    assert got.res.dtype == want.res.dtype == np.int32
    np.testing.assert_array_equal(got.residual.res0, want.residual.res0)


def _events(batches):
    return [[(type(ev).__name__, *dataclasses.astuple(ev)) for ev in b]
            for b in batches]


# -- the drain ----------------------------------------------------------------

@pytest.mark.parametrize("layout", ["bcsr", "rcsr"])
@pytest.mark.parametrize("seed", SEEDS)
def test_apply_signed_matches_jax(seed, layout):
    """Mixed-sign updates with overflowing decreases: ``res``, ``e``,
    value, budget, overflow and ``ok`` equal JAX's, on the plain path and
    on the kernel hook (its plain version on the CPU)."""
    rj, rt, res, e, s, t, rng = _flow(seed, layout)
    ups = _overflowing_updates(rng, rj, res)
    want = jrr.apply_signed(rj, res, e, s, t, ups)
    assert want.rerouted == (want.overflow > 0)
    for use_kernel in (False, True):
        got = reroute.apply_signed(rt, res, e, s, t, ups,
                                   use_kernel=use_kernel, device="cpu")
        _same_result(got, want)


def test_apply_signed_drains_and_counts():
    """Across the seeds the drain runs, the counters move as JAX's, and
    the result is a feasible flow on the new capacities."""
    ran = 0
    for seed in SEEDS:
        rj, rt, res, e, s, t, rng = _flow(seed)
        ups = _overflowing_updates(rng, rj, res)
        before = {k: REGISTRY.counter(k).value for k in (
            "stream.reroute.applies", "stream.reroute.overflow_units")}
        got = reroute.apply_signed(rt, res, e, s, t, ups, device="cpu")
        assert got.ok
        if not got.rerouted:
            continue
        ran += 1
        assert (REGISTRY.counter("stream.reroute.applies").value
                == before["stream.reroute.applies"] + 1)
        assert (REGISTRY.counter("stream.reroute.overflow_units").value
                == before["stream.reroute.overflow_units"] + got.overflow)
        r2 = got.residual
        res0 = np.asarray(r2.res0, np.int64)
        f = res0 - got.res
        assert (got.res >= 0).all() and (f <= res0).all()
        net = np.zeros(r2.n, np.int64)
        np.subtract.at(net, r2.tails, np.maximum(f, 0))
        np.add.at(net, r2.heads, np.maximum(f, 0))
        inner = np.ones(r2.n, bool)
        inner[[s, t]] = False
        assert not net[inner].any() and net[t] == got.value
    assert ran >= 4


def test_no_drain_answers_without_device():
    """Increases and slack-only decreases: no drain, the same answer as
    JAX's."""
    rj, rt, res, e, s, t, _ = _flow(1)
    slack = np.nonzero((np.asarray(rj.res0) > 0) & (res > 0))[0][:2]
    ups = [(int(rj.tails[a]), int(rj.heads[a]), -1) for a in slack]
    ups.append((int(rj.tails[0]), int(rj.heads[0]), 4))
    got = reroute.apply_signed(rt, res, e, s, t, ups, device="cpu")
    _same_result(got, jrr.apply_signed(rj, res, e, s, t, ups))
    assert not got.rerouted and got.budget == 4


def _drain_inputs(seed):
    """A prepared overflow on both sides: ``(jax g, meta, res0, res, b,
    e, port tensors of the same, s, t)``."""
    rj, rt, res, e, s, t, rng = _flow(seed)
    prep = jrr.prepare_signed(rj, res, e, s, t,
                              _overflowing_updates(rng, rj, res))
    g, meta, _ = jpr.to_device(prep.residual)
    arrs = [np.asarray(x, np.int32) for x in (prep.residual.res0, prep.res,
                                              prep.b, prep.e)]
    tg, tmeta, _ = tpr.to_device(_port(prep.residual), "cpu")
    return (g, meta, [jnp.asarray(x) for x in arrs], tg, tmeta,
            [torch.from_numpy(x) for x in arrs], s, t, prep)


@pytest.mark.parametrize("seed", SEEDS)
def test_multi_sink_distances_and_deficit_step_match_jax(seed):
    """The drain's two device steps from a prepared overflow: the
    multi-sink distances (plain sweep and the kernel hook's key
    ``min(dist + 1, INF)``) and one deficit cancellation."""
    from repro_torch.kernels import ops as kops

    g, meta, (res0, res, b, _), tg, tmeta, tt, s, t, _ = _drain_inputs(seed)
    sink = np.asarray((b > 0).at[t].set(True))
    want = np.asarray(jrr._multi_sink_distances(g, meta, res0 - res,
                                                jnp.asarray(sink)))
    fres = tt[0] - tt[1]
    for fn in (None, kops.min_neighbor_minh_fn()):
        got = reroute._multi_sink_distances(tg, tmeta, fres,
                                            torch.from_numpy(sink), fn)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32
    height = jnp.asarray(want)
    wres, wb = jrr._deficit_cancel_step(g, meta, res0, res, height, b, s, t)
    for fn in (None, kops.min_neighbor_minh_fn()):
        gres, gb = reroute._deficit_cancel_step(
            tg, tmeta, tt[0], tt[1], torch.from_numpy(want), tt[2], s, t, fn)
        np.testing.assert_array_equal(gres.numpy(), np.asarray(wres))
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))


@pytest.mark.parametrize("seed", SEEDS)
def test_reroute_impl_matches_jax(seed):
    """The whole device drain: ``(res, e, deficit_left, excess_left)``."""
    g, meta, (res0, res, b, e), tg, tmeta, tt, s, t, _ = _drain_inputs(seed)
    want = jrr._reroute_impl(g, meta, res0, res, b, e, s, t)
    got = reroute._reroute_impl(tg, tmeta, *tt, s, t)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert got[2].dtype == got[3].dtype == torch.int32


def test_reroute_cancels_cycle_flow():
    """A decrease whose overflow can only annihilate against a deficit (a
    cancelled cycle, no path to t): the deficit-first drain retires it
    rather than stall — value, arrays and stats as JAX's."""
    edges = np.array([[0, 1], [1, 3], [1, 2], [2, 1]], np.int64)
    caps = np.array([4, 4, 3, 3], np.int64)
    ups = [(1, 2, -3), (2, 1, -3)]
    jsolver = JSolver()
    jsol = jsolver.solve(JMaxflowProblem(JGraph(4, edges, caps), 0, 3))
    want = jsolver.resolve(jsol.warm_start, [JUpdate(*u) for u in ups])
    for use_kernel in ("vc", "vc_kernel_bsearch"):
        solver = Solver(device="cpu", mode=use_kernel)
        sol = solver.solve(MaxflowProblem(tgen.Graph(4, edges, caps), 0, 3))
        out = solver.resolve(sol.warm_start, [CapacityUpdate(*u)
                                              for u in ups])
        assert out.value == want.value == 4
        assert out.stats.warm and out.stats.rerouted
        for x, y in zip(out.warm_start.arrays(), want.warm_start.arrays()):
            np.testing.assert_array_equal(x, y)


def test_reroute_noop_short_circuit():
    """A decrease to exactly the routed flow overflows nothing and frees
    nothing: no solve (``stream.noop_resolves`` + 1), as in JAX."""
    edges = np.array([[0, 1], [1, 2]], np.int64)
    caps = np.array([5, 3], np.int64)
    solver = Solver(device="cpu")
    sol = solver.solve(MaxflowProblem(tgen.Graph(3, edges, caps), 0, 2))
    before = REGISTRY.counter("stream.noop_resolves").value
    out = solver.resolve(sol.warm_start, [CapacityUpdate(0, 1, -2)])
    jsol = JSolver().solve(JMaxflowProblem(JGraph(3, edges, caps), 0, 2))
    want = JSolver().resolve(jsol.warm_start, [JUpdate(0, 1, -2)])
    assert out.value == want.value == 3 and out.stats.warm
    assert out.stats.cycles == 0
    assert REGISTRY.counter("stream.noop_resolves").value == before + 1


@pytest.mark.parametrize("use_kernel", [False, True])
def test_pooled_drain_matches_jax_and_per_item(use_kernel):
    """``apply_signed_batched`` over rows of different sizes and layouts
    (one without overflow) equals JAX's pooled drain and the port's own
    per-item ``apply_signed``, in ONE pooled dispatch."""
    items, jitems = [], []
    for seed, layout in ((0, "bcsr"), (2, "rcsr"), (4, "bcsr"),
                         (5, "bcsr"), (14, "rcsr"), (9, "bcsr")):
        rj, rt, res, e, s, t, rng = _flow(seed, layout, n_lo=6, n_hi=60)
        ups = (_overflowing_updates(rng, rj, res) if seed != 5
               else [(int(rj.tails[0]), int(rj.heads[0]), 2)])
        items.append((rt, res, e, s, t, ups))
        jitems.append((rj, res, e, s, t, ups))
    assert len({it[0].n for it in items}) > 1
    want = jrr.apply_signed_batched(jitems)
    disp = REGISTRY.counter("stream.reroute.batched_dispatches")
    before = disp.value
    got = reroute.apply_signed_batched(items, use_kernel=use_kernel,
                                       device="cpu")
    assert disp.value == before + 1
    assert sum(x.rerouted for x in got) == 5
    for g_, w in zip(got, want):
        _same_result(g_, w)
    for g_, it in zip(got, items):
        _same_result(g_, reroute.apply_signed(*it, use_kernel=use_kernel,
                                              device="cpu"))


def _stalled_handle(handle_cls, **kw):
    """A handle that claims to hold a corrected flow but holds the
    preflow of s->a (5), a->t (2): 3 units stranded at a."""
    edges = np.array([[0, 1], [1, 2]], np.int64)
    caps = np.array([5, 2], np.int64)
    r = build_residual(JGraph(3, edges, caps), "bcsr")
    a01 = jb.find_arc(r, 0, 1)
    a12 = jb.find_arc(r, 1, 2)
    res = np.asarray(r.res0, np.int32).copy()
    res[a01] -= 5
    res[r.rev[a01]] += 5
    res[a12] -= 2
    res[r.rev[a12]] += 2
    e = np.array([0, 3, 2], np.int32)
    rr = r if handle_cls is JHandle else _port(r)
    return handle_cls(rr, 0, 2, res, e, corrected=True, **kw), edges, caps


def test_stall_gives_not_ok_and_resolve_goes_cold():
    """A preflow handed to the drain as if it were a flow: the deficit
    cannot drain, ``ok=False`` and ``stream.reroute.stalls`` + 1, as in
    JAX; ``Solver.resolve`` then answers with a cold solve of the
    updated graph, whose value equals JAX's."""
    jh, _, _ = _stalled_handle(JHandle)
    stalls = REGISTRY.counter("stream.reroute.stalls")
    jstalls = JREGISTRY.counter("stream.reroute.stalls")
    ups = [(0, 1, -4)]
    want_rr = jrr.apply_signed(jh.residual, *jh.arrays(), 0, 2, ups)
    assert not want_rr.ok
    for pooled in (False, True):
        th, _, _ = _stalled_handle(WarmStartHandle, device="cpu")
        before = stalls.value
        if pooled:
            rr = reroute.drain_prepared([th.prepare_updates(ups)],
                                        device="cpu")[0]
        else:
            rr = reroute.apply_signed(th.residual, *th.arrays(), 0, 2, ups,
                                      device="cpu")
        assert stalls.value == before + 1
        _same_result(rr, want_rr)
        assert th.finish_updates(rr)[1] is None
    jbefore = jstalls.value
    want = JSolver().resolve(jh, [JUpdate(0, 1, -4)])
    assert jstalls.value == jbefore + 1
    for mode in ("vc", "vc_kernel_bsearch"):
        th, _, _ = _stalled_handle(WarmStartHandle, device="cpu",
                                   use_kernel=mode != "vc")
        before = stalls.value
        got = Solver(device="cpu", mode=mode).resolve(
            th, [CapacityUpdate(0, 1, -4)])
        assert stalls.value == before + 1
        assert got.value == want.value == 1
        assert not got.stats.warm and got.stats.backend == "single"
        np.testing.assert_array_equal(got.warm_start.residual.res0,
                                      want.warm_start.residual.res0)


RESOLVE_CASES = {
    "washington": ("washington_rlg", (10, 10)),
    "genrmf": ("genrmf", (3, 5)),
    "random_sparse": ("random_sparse", (300, 1200)),
}


@pytest.mark.parametrize("backend", ["single", "batched"])
@pytest.mark.parametrize("case", list(RESOLVE_CASES))
def test_resolve_with_decreases_matches_jax(case, backend):
    """``Solver.resolve`` after decreases below the routed flow (and an
    increase), chained twice, in mode ``vc``: value, ``stats.rerouted``,
    cycles and the corrected arrays equal JAX's."""
    name, args = RESOLVE_CASES[case]
    gj, s, t = getattr(jgen, name)(*args)
    gt = getattr(tgen, name)(*args)[0]
    jsolver = JSolver(backend=backend)
    solver = Solver(device="cpu", backend=backend)
    jh = jsolver.solve(JMaxflowProblem(gj, s, t)).warm_start
    th = solver.solve(MaxflowProblem(gt, s, t)).warm_start
    rng = np.random.default_rng(len(case))
    for _ in range(2):
        r = jh.residual
        res, _ = jh.arrays()
        ups = _overflowing_updates(rng, r, res)
        want = jsolver.resolve(jh, [JUpdate(*u) for u in ups])
        got = solver.resolve(th, [CapacityUpdate(*u) for u in ups])
        assert got.value == want.value
        assert got.stats.rerouted == want.stats.rerouted
        assert got.stats.warm and got.stats.cycles == want.stats.cycles
        for x, y in zip(got.warm_start.arrays(), want.warm_start.arrays()):
            np.testing.assert_array_equal(x, y)
        jh, th = want.warm_start, got.warm_start
    assert got.value == solver.solve(MaxflowProblem.from_residual(
        th.residual, s, t)).value


# -- events, the chain, the traces -------------------------------------------

def _tiny():
    gj = JGraph(4, np.array([[0, 1], [1, 3], [0, 2], [1, 1]], np.int64),
                np.array([5, 5, 4, 2], np.int64))
    rj = build_residual(gj, "bcsr")
    return rj, _port(rj)


def test_normalize_events_matches_jax():
    rj, rt = _tiny()
    cases = [
        [EdgeInsert(2, 3, 4), EdgeInsert(0, 1, 2)],
        [CapacityReweight(0, 1, 9), EdgeDelete(0, 1)],
        [EdgeDelete(1, 3), CapacityUpdate(0, 2, -1), (0, 1, 3)],
        [EdgeInsert(3, 0, 0)],
        CapacityReweight(0, 2, 1),
    ]
    jmap = {EdgeInsert: jev.EdgeInsert, EdgeDelete: jev.EdgeDelete,
            CapacityReweight: jev.CapacityReweight, CapacityUpdate: JUpdate}

    def to_jax(ev):
        if isinstance(ev, tuple):
            return ev
        return jmap[type(ev)](*dataclasses.astuple(ev))

    for evs in cases:
        jevs = ([to_jax(x) for x in evs] if isinstance(evs, list)
                else to_jax(evs))
        assert normalize_events(rt, evs) == jev.normalize_events(rj, jevs)
    bad = [([EdgeDelete(0, 3)], KeyError, jev.EdgeDelete(0, 3)),
           ([CapacityReweight(3, 2, 1)], KeyError,
            jev.CapacityReweight(3, 2, 1)),
           ([EdgeInsert(1, 1, 2)], ValueError, jev.EdgeInsert(1, 1, 2)),
           ([EdgeInsert(0, 9, 2)], ValueError, jev.EdgeInsert(0, 9, 2)),
           ([EdgeInsert(0, 1, -2)], ValueError, jev.EdgeInsert(0, 1, -2)),
           ([CapacityReweight(0, 1, -1)], ValueError,
            jev.CapacityReweight(0, 1, -1))]
    for evs, exc, jx in bad:
        with pytest.raises(exc) as got:
            normalize_events(rt, evs)
        with pytest.raises(exc) as want:
            jev.normalize_events(rj, [jx])
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="follows its own insert"):
        normalize_events(rt, [EdgeInsert(2, 3, 1), EdgeDelete(2, 3)])


def test_version_chain_lru_eviction_and_pins():
    chain = VersionChain(capacity=3)
    for i in range(5):
        assert chain.append(f"h{i}", i) == i
    assert len(chain) == 3 and chain.latest == 4
    with pytest.raises(KeyError, match="evicted"):
        chain.get(0)
    with pytest.raises(KeyError, match="never issued"):
        chain.get(99)
    chain.pin(2)
    for i in range(5, 9):
        chain.append(f"h{i}", i)
    assert 2 in chain
    chain.unpin(2)
    for i in range(9, 12):
        chain.append(f"h{i}", i)
    assert 2 not in chain
    with pytest.raises(ValueError):
        chain.unpin(chain.latest)
    with pytest.raises(ValueError, match="capacity"):
        VersionChain(0)


def test_version_chain_never_evicts_latest_and_pins_overflow():
    chain = VersionChain(capacity=1)
    chain.append("a", 0)
    chain.append("b", 1)
    assert chain.latest == 1 and chain.get(1).handle == "b"
    assert 0 not in chain
    chain = VersionChain(capacity=2)
    chain.append("a", 0)
    chain.pin(0)
    chain.append("b", 1)
    chain.pin(1)
    chain.append("c", 2)
    assert len(chain) == 3 and chain.stats()["pinned"] == 2


def test_version_chain_matches_jax_under_a_random_schedule():
    """The same schedule of appends, gets, pins and unpins leaves both
    chains with the same versions, stats and errors."""
    rng = np.random.default_rng(3)
    ours, theirs = VersionChain(3), jver.VersionChain(3)
    for _ in range(200):
        op = int(rng.integers(0, 4))
        v = int(rng.integers(0, max(1, ours._next + 1)))
        outs = []
        for chain in (ours, theirs):
            try:
                if op == 0:
                    outs.append(chain.append(f"h{v}", v, parent=v))
                elif op == 1:
                    outs.append(chain.get(v).value)
                elif op == 2:
                    outs.append(chain.pin(v))
                else:
                    outs.append(chain.unpin(v))
            except (KeyError, ValueError) as exc:
                outs.append((type(exc), str(exc)))
        assert outs[0] == outs[1]
        assert ours.stats() == theirs.stats()
        assert list(ours._records) == list(theirs._records)


TRACE_KINDS = {
    "uniform": {},
    "locality": {"locality": 0.7},
    "adversarial": {"adversarial": True},
    "inserts": {"p_insert": 0.5, "p_delete": 0.0},
}


@pytest.mark.parametrize("seed", [0, 5, 11])
@pytest.mark.parametrize("kind", list(TRACE_KINDS))
def test_update_trace_and_folded_graph_match_jax(kind, seed):
    """The same seed gives the same batches, event for event, and the
    same folded graph."""
    gj, s, t = jgen.random_sparse(24, 70, seed=seed)
    gt = tgen.random_sparse(24, 70, seed=seed)[0]
    kw = TRACE_KINDS[kind]
    bj = jgen.update_trace(gj, s, t, n_batches=5, batch_size=4, seed=seed,
                           **kw)
    bt = tgen.update_trace(gt, s, t, n_batches=5, batch_size=4, seed=seed,
                           **kw)
    assert _events(bt) == _events(bj) and len(bt) > 0
    assert all(type(ev).__module__ == "repro_torch.streaming.events"
               for b in bt for ev in b)
    fj = jgen.apply_events_to_graph(gj, bj)
    ft = tgen.apply_events_to_graph(gt, bt)
    assert ft.n == fj.n
    np.testing.assert_array_equal(ft.edges, fj.edges)
    np.testing.assert_array_equal(ft.cap, fj.cap)
    one = tgen.apply_events_to_graph(gt, bt[0])  # a single batch
    np.testing.assert_array_equal(
        one.cap, jgen.apply_events_to_graph(gj, bj[0]).cap)
    assert tgen._directed_caps(gt) == jgen._directed_caps(gj)


def test_apply_events_to_graph_errors_and_updates():
    gt = tgen.Graph(3, np.array([[0, 1], [1, 2]], np.int64),
                    np.array([5, 5], np.int64))
    out = tgen.apply_events_to_graph(gt, [[CapacityUpdate(0, 1, -2),
                                          (1, 2, 1)]])
    assert dict(zip(map(tuple, out.edges.tolist()), out.cap.tolist())) == {
        (0, 1): 3, (1, 0): 0, (1, 2): 6, (2, 1): 0}
    with pytest.raises(KeyError):
        tgen.apply_events_to_graph(gt, [EdgeDelete(0, 2)])
    with pytest.raises(KeyError):
        tgen.apply_events_to_graph(gt, [CapacityReweight(2, 0, 1)])
    with pytest.raises(ValueError, match="below zero"):
        tgen.apply_events_to_graph(gt, [[(0, 1, -6)]])


def test_rebuild_with_state_matches_jax():
    rj, rt, res, e, s, t, _ = _flow(4)
    have = set(zip(rj.tails.tolist(), rj.heads.tolist()))
    pairs = [(u, v) for u in range(rj.n) for v in range(rj.n)
             if u != v and (u, v) not in have][:3]
    want = jstream.rebuild_with_state(rj, res, e, pairs)
    got = tstream.rebuild_with_state(rt, res, e, pairs)
    for f in ("indptr", "heads", "tails", "rev", "res0"):
        np.testing.assert_array_equal(getattr(got[0], f),
                                      getattr(want[0], f))
    for x, y in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


# -- StreamingGraph -------------------------------------------------------------

@pytest.mark.parametrize("mode, backend", [("vc", "single"),
                                           ("vc", "batched"),
                                           ("vc_kernel_bsearch", "single")])
@pytest.mark.parametrize("kind", ["locality", "adversarial"])
def test_stream_replay_matches_jax_and_cold(kind, mode, backend):
    """Replaying a generated trace: at every version the value and the
    corrected arrays equal JAX's ``StreamingGraph`` (run in ``vc``, to
    which the kernel modes are bit-equal) and the value a cold solve of
    the folded graph."""
    gj, s, t = jgen.random_sparse(22, 66, seed=7)
    gt = tgen.random_sparse(22, 66, seed=7)[0]
    kw = TRACE_KINDS[kind]
    batches = tgen.update_trace(gt, s, t, n_batches=4, batch_size=3,
                                seed=11, **kw)
    jbatches = jgen.update_trace(gj, s, t, n_batches=4, batch_size=3,
                                 seed=11, **kw)
    solver = Solver(device="cpu", mode=mode, backend=backend)
    sg = solver.open_stream(MaxflowProblem(gt, s, t), max_versions=12)
    jsg = JSolver(backend=backend).open_stream(JMaxflowProblem(gj, s, t),
                                               max_versions=12)
    assert isinstance(sg, StreamingGraph)
    for i, (b, jbt) in enumerate(zip(batches, jbatches)):
        v, jv = sg.apply(b), jsg.apply(jbt)
        assert v == jv == i + 1
        got, want = sg.query(v), jsg.query(jv)
        assert got.value == want.value
        assert got.stats.warm and got.stats.backend == "stream"
        for x, y in zip(got.warm_start.arrays(), want.warm_start.arrays()):
            np.testing.assert_array_equal(x, y)
        assert torch.equal(got.state.res, torch.from_numpy(
            got.warm_start.arrays()[0]))
        cold = solver.solve(MaxflowProblem(
            tgen.apply_events_to_graph(gt, batches[:i + 1]), s, t))
        assert got.value == cold.value
        assert got.min_cut().value == got.value
    assert sg.stats() == jsg.stats()


def test_stream_structural_insert_rebuilds_warm():
    """A genuinely new arc pair rebuilds the CSR around the routed flow;
    the inserted capacity then routes as an ordinary increase."""
    edges = np.array([[0, 1], [1, 3], [0, 2]], np.int64)
    caps = np.array([5, 5, 4], np.int64)
    sg = Solver(device="cpu").open_stream(MaxflowProblem(
        tgen.Graph(4, edges, caps), 0, 3))
    assert sg.query().value == 5
    before = REGISTRY.counter("stream.structural_rebuilds").value
    v = sg.apply([EdgeInsert(2, 3, 4)])
    q = sg.query(v)
    assert q.value == 9 and sg.stats()["structural_rebuilds"] == 1
    assert REGISTRY.counter("stream.structural_rebuilds").value == before + 1
    assert q.stats.warm and q.warm_start.device == torch.device("cpu")
    v2 = sg.apply([EdgeInsert(2, 1, 0)])  # cap-0 insert: flow untouched
    assert sg.query(v2).value == 9 and sg.stats()["structural_rebuilds"] == 2


def test_stream_delete_and_reweight_events():
    sg = Solver(device="cpu").open_stream(MaxflowProblem(tgen.Graph(
        3, np.array([[0, 1], [1, 2]], np.int64), np.array([5, 5],
                                                           np.int64)), 0, 2))
    v1 = sg.apply([CapacityReweight(0, 1, 2)])
    assert sg.query(v1).value == 2
    v2 = sg.apply([EdgeDelete(1, 2)])
    assert sg.query(v2).value == 0
    with pytest.raises(KeyError):
        sg.apply([EdgeDelete(0, 2)])
    with pytest.raises(ValueError):
        sg.apply([EdgeInsert(1, 1, 3)])
    with pytest.raises(ValueError):
        sg.apply([])


def test_stream_pin_query_and_close():
    gt, s, t = tgen.random_sparse(16, 40, seed=9)
    sg = Solver(device="cpu").open_stream(MaxflowProblem(gt, s, t),
                                          max_versions=3)
    r = sg.query().problem.residual()
    u, v = int(r.tails[0]), int(r.heads[0])
    v1 = sg.apply([(u, v, 2)])
    sg.pin(v1)
    for _ in range(4):
        sg.apply([(u, v, 1)])
    assert sg.query(v1).value is not None
    with pytest.raises(KeyError):
        sg.query(0)
    sg.unpin(v1)
    # the chain's latest is its most recently used version, as in the
    # reference: the query above made it v1
    assert "latest=v1" in repr(sg) and sg.latest_version == v1
    sg.close()
    assert sg.closed and "closed" in repr(sg)
    for call in (lambda: sg.apply([(u, v, 1)]), sg.query,
                 lambda: sg.pin(5)):
        with pytest.raises(RuntimeError):
            call()


def test_stream_counters_and_spans():
    """The drain's and the stream's counters and spans land where JAX's
    do, under the same names."""
    edges = np.array([[0, 1], [1, 2]], np.int64)
    caps = np.array([5, 5], np.int64)
    TRACER.clear()
    TRACER.enable()
    try:
        sg = Solver(device="cpu").open_stream(MaxflowProblem(
            tgen.Graph(3, edges, caps), 0, 2))
        sg.apply([CapacityUpdate(0, 1, -3)])
        sg.query()
        h = sg.query().warm_start
        assert reroute.apply_signed(h.residual, *h.arrays(), 0, 2,
                                    [(1, 2, -4)], device="cpu").rerouted
        names = [ev["name"] for ev in TRACER.to_dict()["traceEvents"]]
    finally:
        TRACER.disable()
        TRACER.clear()
    for name in ("stream.apply", "stream.reroute", "stream.query",
                 "stream.reroute.pooled"):
        assert name in names, name
    keys = set(REGISTRY.snapshot()["counters"])
    for name in ("stream.applies", "stream.events", "stream.queries",
                 "stream.reroute.applies", "stream.reroute.overflow_units",
                 "stream.reroute.drained_units",
                 "stream.reroute.batched_dispatches"):
        assert any(k.startswith(name) for k in keys), name


def test_tracer_export_matches_jax(tmp_path):
    """The same spans, complete and instant events give the same Chrome
    trace as JAX's tracer, timestamps and ids aside."""

    def record(mod, tracer):
        with tracer.span("outer", a=1):
            with tracer.span("inner"):
                tracer.instant("tick", k="v")
        tracer.complete("req", 1.0, 1.5, id=3)
        tracer.complete("neg", 2.0, 1.0)

        @mod.traced("deco")
        def f(x):
            return x + 1

        assert f(1) == 2
        return tracer

    ours, theirs = Tracer(enabled=True), jtrace.Tracer(enabled=True)
    record(ttrace, ours)
    record(jtrace, theirs)

    def strip(d):
        return [{k: v for k, v in ev.items()
                 if k not in ("ts", "pid", "tid")} for ev in d["traceEvents"]]

    path = ours.export(str(tmp_path / "trace.json"))
    loaded = json.loads(open(path).read())
    assert strip(loaded) == strip(theirs.to_dict())
    assert loaded["displayTimeUnit"] == "ms" and len(ours) == len(theirs)
    assert [ev["dur"] for ev in loaded["traceEvents"] if ev["ph"] == "X"] \
        == [5e5, 0.0]
    off = Tracer()
    assert off.span("x").__enter__() is off.span("y")
    off.complete("x", 0.0, 1.0)
    off.instant("x")
    assert len(off) == 0
    ours.clear()
    assert len(ours) == 0


def test_stream_latest_is_the_chains_most_recent_use_as_in_jax():
    """A query of an older version makes it the chain's latest, so the
    next apply builds on it — the reference's behaviour (its
    ``VersionChain.latest`` is the most recently used record), which the
    port keeps: both streams end on the same versions and values."""
    gj, s, t = jgen.random_sparse(16, 40, seed=9)
    gt = tgen.random_sparse(16, 40, seed=9)[0]
    sg = Solver(device="cpu").open_stream(MaxflowProblem(gt, s, t))
    jsg = JSolver().open_stream(JMaxflowProblem(gj, s, t))
    r = sg.query().problem.residual()
    jsg.query()
    u, v = int(r.tails[0]), int(r.heads[0])
    for ups in ([(u, v, 3)], [(u, v, -2)]):
        assert sg.apply(ups) == jsg.apply(ups)
    assert sg.query(1).value == jsg.query(1).value
    assert sg.latest_version == jsg.latest_version == 1
    assert sg.apply([(u, v, 1)]) == jsg.apply([(u, v, 1)]) == 3
    assert sg.query().value == jsg.query().value
    assert sg.stats() == jsg.stats()
