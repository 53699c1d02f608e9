"""The port's batched core against the JAX package's, on the same numpy
inputs: packing, batched preflow and global relabel, and whole batched
solves (padded states, per-instance cycles and rounds, global relabels,
sweeps, values) in every ported mode and both layouts.

The JAX batched driver in ``vc`` is the reference of every mode (the
reference proves its modes equal; its kernel modes do not run on the
installed jax).  The port's ``vc_fused`` is also held against the JAX
``vc_fused`` driver run with the fused kernel emulated
(``test_torch_discharge.jax_kernels_emulated``).  Values are held
against ``dinic_maxflow``.  Tolerance: exact equality."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import batched as jb
from repro.core.csr import Graph as JGraph
from repro.core.csr import build_residual
from repro.core.ref_maxflow import dinic_maxflow
from repro.errors import BudgetExhausted as JBudgetExhausted
from repro_torch.api import MaxflowProblem, Solver
from repro_torch.core import batched as tb
from repro_torch.core import engine
from repro_torch.core import pushrelabel as tpr
from repro_torch.core.csr import residual_from_arrays
from repro_torch.errors import BudgetExhausted
from repro_torch.graphs import generators as tgen
from tests.conftest import random_graph
from tests.test_torch_discharge import jax_kernels_emulated

MODES = ("vc", "vc_kernel", "vc_kernel_bsearch", "vc_fused")


@functools.lru_cache(maxsize=None)
def _instances(seed, layout, k=3, trivial=False):
    """``k`` random instances (plus a trivial ``s == t`` lane) as
    ``((jax instances), (port instances), graphs)``."""
    rng = np.random.default_rng(seed)
    graphs = [random_graph(rng, n_lo=8, n_hi=30) for _ in range(k)]
    js = [(build_residual(g, layout), 0, g.n - 1) for g in graphs]
    if trivial:
        js.append((js[0][0], 2, 2))
    ts = [(residual_from_arrays(**dataclasses.asdict(r)), s, t)
          for r, s, t in js]
    return tuple(js), tuple(ts), tuple(graphs)


def _same(jx, tx, what):
    got = tx if isinstance(tx, np.ndarray) else tx.cpu().numpy()
    np.testing.assert_array_equal(got, np.asarray(jx), err_msg=what)


def _same_result(want, got, telemetry=False):
    for f in ("res", "h", "e"):
        _same(getattr(want.state, f), getattr(got.state, f), f)
    for f in ("maxflows", "cycles", "rounds", "converged", "trivial"):
        _same(getattr(want, f), getattr(got, f), f)
    assert (got.global_relabels, got.gr_sweeps) == (want.global_relabels,
                                                     want.gr_sweeps)
    if telemetry:
        for f in ("pushes", "relabels", "active_sum", "frontier_sum"):
            _same(getattr(want, f), getattr(got, f), f)


@pytest.mark.parametrize("layout", ["bcsr", "rcsr"])
def test_pack_instances_and_states_match(layout):
    js, ts, _ = _instances(0, layout, trivial=True)
    jbg, jmeta, jres0, jtriv = jb.pack_instances(list(js), n_pad=40)
    tbg, tmeta, tres0, ttriv = tb.pack_instances(list(ts), n_pad=40,
                                                 device="cpu")
    for f in jbg._fields:
        assert getattr(tbg, f).dtype == torch.int32, f
        _same(getattr(jbg, f), getattr(tbg, f), f)
    _same(jres0, tres0, "res0")
    _same(jtriv, ttriv, "trivial")
    assert (tmeta.n, tmeta.num_arcs, tmeta.deg_max, tmeta.layout) == (
        jmeta.n, jmeta.num_arcs, jmeta.deg_max, jmeta.layout)
    assert tbg.batch == jbg.batch == 4
    rng = np.random.default_rng(1)
    states = [(rng.integers(0, 9, r.num_arcs), rng.integers(0, 9, r.n),
               rng.integers(0, 9, r.n)) for r, _, _ in js]
    want = jb.pack_states(states, jmeta.n, jmeta.num_arcs)
    got = tb.pack_states(states, tmeta.n, tmeta.num_arcs, device="cpu")
    for f in ("res", "h", "e"):
        _same(getattr(want, f), getattr(got, f), f)
    states[1] = (states[1][0], np.full(js[1][0].n, 2**31, np.int64),
                 states[1][2])
    with pytest.raises(OverflowError, match="int32"):
        tb.pack_states(states, tmeta.n, tmeta.num_arcs, device="cpu")
    with pytest.raises(ValueError, match="bucket"):
        tb.pack_instances(list(ts), n_pad=4, device="cpu")


@pytest.mark.parametrize("minh", ["plain", "kernel"])
@pytest.mark.parametrize("layout", ["bcsr", "rcsr"])
def test_batched_preflow_and_global_relabel_match(layout, minh):
    js, ts, _ = _instances(2, layout, trivial=True)
    jbg, jmeta, jres0, _ = jb.pack_instances(list(js))
    tbg, tmeta, tres0, _ = tb.pack_instances(list(ts), device="cpu")
    jstate = jb.batched_preflow(jbg, jmeta, jres0)
    tstate = tb.batched_preflow(tbg, tmeta, tres0)
    for f in ("res", "h", "e"):
        _same(getattr(jstate, f), getattr(tstate, f), f"preflow {f}")
    fn = engine.resolve_minh_fn("vc_kernel" if minh == "kernel" else "vc")
    jnew, jn, jsw = jb.batched_global_relabel(jbg, jmeta, jstate)
    tnew, tn, tsw = tb.batched_global_relabel(tbg, tmeta, tstate,
                                              minh_fn=fn)
    for f in ("res", "h", "e"):
        _same(getattr(jnew, f), getattr(tnew, f), f"relabel {f}")
    _same(jn, tn, "nact")
    assert tn.dtype == torch.int32 and int(tsw) == int(jsw)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", ["bcsr", "rcsr"])
def test_batched_solve_matches_jax_batched_vc(layout, mode):
    """Every ported mode == the JAX batched ``vc`` driver, bit for bit
    (padded states, per-instance cycles and rounds, relabels, sweeps);
    ``vc_kernel_bsearch`` is refused on ``rcsr``."""
    js, ts, graphs = _instances(3, layout, trivial=True)
    if mode == "vc_kernel_bsearch" and layout == "rcsr":
        with pytest.raises(ValueError, match="bcsr"):
            tb.batched_solve_impl(list(ts), mode=mode, device="cpu")
        tbg, tmeta, tres0, _ = tb.pack_instances(list(ts), device="cpu")
        with pytest.raises(ValueError, match="bcsr"):
            tb.batched_run_cycles(tbg, tmeta,
                                  tb.batched_preflow(tbg, tmeta, tres0),
                                  mode=mode)
        return
    want = jb.batched_solve_impl(list(js), mode="vc", cycle_chunk=8)
    got = tb.batched_solve_impl(list(ts), mode=mode, cycle_chunk=8,
                                device="cpu")
    _same_result(want, got)
    assert got.converged.all()
    oracle = [dinic_maxflow(g, 0, g.n - 1) for g in graphs] + [0]
    assert got.maxflows.tolist() == oracle


@pytest.mark.parametrize("budget", [1, 4, 9])
def test_batched_bsearch_cycles_match_jax_vc(budget):
    """``budget`` batched ``vc_kernel_bsearch`` cycles, each one launch of
    the min search's rev entry over every row, == the JAX batched ``vc``
    driver's from the same post-relabel state: padded state and
    per-instance cycles."""
    js, ts, _ = _instances(9, "bcsr", k=3, trivial=True)
    jbg, jmeta, jres0, _ = jb.pack_instances(list(js))
    tbg, tmeta, tres0, _ = tb.pack_instances(list(ts), device="cpu")
    jstate = jb.batched_global_relabel(
        jbg, jmeta, jb.batched_preflow(jbg, jmeta, jres0))[0]
    tstate = tb.batched_global_relabel(
        tbg, tmeta, tb.batched_preflow(tbg, tmeta, tres0))[0]
    want, wcyc = jb.batched_run_cycles(jbg, jmeta, jstate, mode="vc",
                                       max_cycles=16, budget=budget)
    got, gcyc = tb.batched_run_cycles(tbg, tmeta, tstate,
                                      mode="vc_kernel_bsearch",
                                      max_cycles=16, budget=budget)
    assert 0 < int(gcyc.max()) <= budget
    _same(wcyc, gcyc, "cycles")
    for f in ("res", "h", "e"):
        _same(getattr(want, f), getattr(got, f), f)


def test_batched_bsearch_step_is_one_fused_search(monkeypatch):
    """A batched ``vc_kernel_bsearch`` cycle makes one call of the min
    search's rev entry for every row and none of the two-output min
    search or of the standalone ``bcsr_rev_search``, and equals the
    batched ``vc`` cycle."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import revsearch

    calls = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, tuple(args[0].shape)))
            return fn(*args, **kw)
        return wrapped

    for mod, name in ((kops, "tile_min_neighbor_gather"),
                      (kops, "tile_min_neighbor_gather_rev"),
                      (revsearch, "bcsr_rev_search")):
        monkeypatch.setattr(mod, name, spy(name, getattr(mod, name)))
    _, ts, _ = _instances(7, "bcsr", k=3)
    bg, meta, res0, _ = tb.pack_instances(list(ts), device="cpu")
    state = tb.batched_global_relabel(
        bg, meta, tb.batched_preflow(bg, meta, res0))[0]
    for _ in range(3):
        calls.clear()
        new = tb._kernel_batch_step(bg, meta, state, "vc_kernel_bsearch")
        assert calls == [("tile_min_neighbor_gather_rev", (3, meta.n))]
        want = tb._kernel_batch_step(bg, meta, state, "vc")
        for f in ("res", "h", "e"):
            assert torch.equal(getattr(new, f), getattr(want, f)), f
        state = new


@pytest.mark.parametrize("telemetry", [False, True])
def test_batched_vc_fused_matches_jax_fused_driver(telemetry, monkeypatch):
    """The port's batched ``vc_fused`` == the JAX batched ``vc_fused``
    driver with the fused kernel emulated, telemetry totals included; a
    cadence of 12 is no multiple of K = 8, so launches straddle the
    cycle cap."""
    js, ts, _ = _instances(4, "bcsr", k=4, trivial=True)
    with jax_kernels_emulated(monkeypatch):
        want = jb.batched_solve_impl(list(js), mode="vc_fused",
                                     cycle_chunk=12, telemetry=telemetry)
    got = tb.batched_solve_impl(list(ts), mode="vc_fused", cycle_chunk=12,
                                device="cpu", telemetry=telemetry)
    _same_result(want, got, telemetry)


@pytest.mark.parametrize("seed", [5, 6])
def test_batched_values_match_dinic(seed):
    """Heterogeneous sizes in one batch, through ``Solver.solve_many``."""
    rng = np.random.default_rng(seed)
    graphs = [random_graph(rng, n_lo=5, n_hi=40) for _ in range(3)]
    graphs.append(tgen.grid_road(12, 12, seed=seed)[0])
    probs = [MaxflowProblem(tgen.Graph(g.n, g.edges, g.cap), 0, g.n - 1)
             for g in graphs]
    want = [dinic_maxflow(JGraph(g.n, g.edges, g.cap), 0, g.n - 1)
            for g in graphs]
    for mode in ("vc", "vc_fused"):
        sols = Solver(backend="batched", mode=mode,
                      device="cpu").solve_many(probs)
        assert [s.value for s in sols] == want
        for p, s in zip(probs, sols):
            assert s.stats.backend == "batched"
            assert s.stats.batch_size == len(probs)
            r = p.residual("bcsr")
            assert s.state.res.shape == (r.num_arcs,)
            assert s.state.h.shape == s.state.e.shape == (r.n,)
            assert int(s.state.e[p.t]) == s.value


@pytest.mark.parametrize("mode", ["vc", "vc_fused"])
def test_batched_max_cycles_budget(mode, monkeypatch):
    """An exact total cycle budget: the same ``BudgetExhausted`` (cycles
    spent, limit) as the JAX batched driver; a budget that suffices
    changes nothing."""
    js, ts, _ = _instances(7, "bcsr", k=3)
    with jax_kernels_emulated(monkeypatch):
        with pytest.raises(JBudgetExhausted) as jexc:
            jb.batched_solve_impl(list(js), mode=mode, cycle_chunk=4,
                                  max_cycles=6)
        full = jb.batched_solve_impl(list(js), mode=mode, cycle_chunk=4)
    with pytest.raises(BudgetExhausted) as texc:
        tb.batched_solve_impl(list(ts), mode=mode, cycle_chunk=4,
                              max_cycles=6, device="cpu")
    assert (texc.value.cycles_spent, texc.value.limit) == (
        jexc.value.cycles_spent, jexc.value.limit)
    got = tb.batched_solve_impl(list(ts), mode=mode, cycle_chunk=4,
                                max_cycles=int(full.cycles.max()) + 8,
                                device="cpu")
    _same_result(full, got)


def test_batched_refusals():
    """An unknown mode and an empty batch are refused; ``phase2=True``
    and ``tc``, ported now, run (and ``tpr.ALL_MODES`` is every mode)."""
    _, ts, _ = _instances(8, "bcsr")
    assert tb.batched_solve_impl(list(ts), device="cpu",
                                 phase2=True).corrected
    assert not tb.batched_solve_impl(list(ts), mode="tc",
                                     device="cpu").corrected
    with pytest.raises(ValueError, match="batched mode"):
        tb.batched_solve_impl(list(ts), mode="fast", device="cpu")
    with pytest.raises(ValueError, match="empty"):
        tb.pack_instances([], device="cpu")
    assert tb.round_up_pow2(5) == 8 and tb.round_up_pow2(0, lo=2) == 2
    assert set(tpr.ALL_MODES) == {*MODES, "tc"}


@pytest.mark.parametrize("scan_chunk", [1, 3, 4])
def test_batched_vc_fused_chunks_match_jax_fused_driver(scan_chunk,
                                                        monkeypatch):
    """The batched in-place ``vc_fused`` loop at engine chunks of 1, 3 and
    4 with a cadence of 12 (no multiple of K = 8): the gate closes in the
    middle of chunks, and the result equals the JAX driver's with its
    kernel emulated."""
    js, ts, _ = _instances(4, "bcsr", k=3, trivial=True)
    with jax_kernels_emulated(monkeypatch):
        want = jb.batched_solve_impl(list(js), mode="vc_fused",
                                     cycle_chunk=12, scan_chunk=scan_chunk,
                                     telemetry=True)
    got = tb.batched_solve_impl(list(ts), mode="vc_fused", cycle_chunk=12,
                                scan_chunk=scan_chunk, device="cpu",
                                telemetry=True)
    _same_result(want, got, True)


@pytest.mark.parametrize("mode", ["vc", "vc_fused"])
def test_batched_run_cycles_leaves_the_callers_state(mode):
    """``batched_run_cycles`` works on its own copy: the caller's state
    tensors are unchanged after a loop that moved the state."""
    _, ts, _ = _instances(7, "bcsr", k=3)
    bg, meta, res0, _ = tb.pack_instances(list(ts), device="cpu")
    state = tb.batched_global_relabel(
        bg, meta, tb.batched_preflow(bg, meta, res0))[0]
    before = tb.BatchedPRState(*(x.clone() for x in state))
    out, cycles = tb.batched_run_cycles(bg, meta, state, mode=mode,
                                        max_cycles=16)
    assert int(cycles.max()) > 0 and not torch.equal(out.e, before.e)
    for f in ("res", "h", "e"):
        assert torch.equal(getattr(state, f), getattr(before, f)), f
