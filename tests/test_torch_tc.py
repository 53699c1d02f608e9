"""The port's thread-centric ``tc`` mode against the JAX package's, on
the same numpy inputs: the chunked scan ``_tc_scan_minh`` against the
reference's one-column-at-a-time loop (ties, empty segments, chunk
boundaries inside a segment), ``tc_step`` step by step, and whole ``tc``
solves, single and batched, against JAX ``tc``, JAX ``vc`` and Dinic.
Tolerance: exact equality."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as jb
from repro.core import globalrelabel as jgr
from repro.core import pushrelabel as jpr
from repro.core.csr import Graph as JGraph
from repro.core.csr import build_residual
from repro.core.ref_maxflow import dinic_maxflow
from repro.graphs import generators as jgen
from repro_torch.api import MaxflowProblem, Solver
from repro_torch.core import batched as tb
from repro_torch.core import pushrelabel as tpr
from repro_torch.core.csr import residual_from_arrays
from repro_torch.graphs import generators as tgen
from tests.conftest import random_graph

STEPS = 16
CASES = {
    "washington": ("washington_rlg", (8, 8)),
    "genrmf": ("genrmf", (3, 4)),
    "random_sparse": ("random_sparse", (300, 900)),
}


def _port(rj):
    return residual_from_arrays(**dataclasses.asdict(rj))


def _same(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


def _same_state(jstate, tstate):
    for f in ("res", "h", "e"):
        assert getattr(tstate, f).dtype == torch.int32, f
        _same(getattr(tstate, f), getattr(jstate, f), f)


def _tie_graph(layout):
    """Hubs with many arcs to vertices of equal height (ties), a vertex
    with an empty segment, and parallel arcs."""
    rng = np.random.default_rng(3)
    n = 60
    edges = [(0, v) for v in range(1, 40)] + [(1, v) for v in range(2, 30)]
    edges += [(v, 59) for v in range(2, 59)] + [(5, 6)] * 4
    edges += [tuple(x) for x in rng.integers(2, 58, size=(80, 2))]
    e = np.array(edges, np.int64)
    e = e[(e[:, 0] != 58) & (e[:, 1] != 58)]  # vertex 58: no arcs at all
    cap = rng.integers(1, 9, size=len(e)).astype(np.int64)
    return build_residual(JGraph(n, e, cap), layout)


@pytest.mark.parametrize("lanes", [1, 3, 7, None])
@pytest.mark.parametrize("layout", ["bcsr", "rcsr"])
def test_tc_scan_matches_jax(layout, lanes, monkeypatch):
    """Random heights with many ties, random residuals and activity, an
    empty segment; ``lanes`` columns per vertex per chunk (``None``: the
    default budget, one chunk here), so chunk boundaries fall inside the
    hubs' segments."""
    rj = _tie_graph(layout)
    rt = _port(rj)
    gj, mj, _ = jpr.to_device(rj)
    gt, mt, _ = tpr.to_device(rt, "cpu")
    assert mj.deg_max > 30 and np.diff(rj.indptr)[58] == 0
    if lanes is not None:
        monkeypatch.setattr(tpr, "TC_LANES", lanes * mt.n)
    rng = np.random.default_rng(lanes or 0)
    for trial in range(4):
        res = rng.integers(-1, 3, size=mj.num_arcs).astype(np.int32)
        h = rng.integers(0, 4, size=mj.n).astype(np.int32)
        h[rng.random(mj.n) < 0.2] = tpr.INF
        act = rng.random(mj.n) < 0.7
        act[58] = True
        zeros = np.zeros(mj.n, np.int32)
        want = jpr._tc_scan_minh(gj, mj, jpr.PRState(
            *(jnp.asarray(x) for x in (res, h, zeros))), jnp.asarray(act))
        got = tpr._tc_scan_minh(gt, mt, tpr.state_from_numpy(
            res, h, zeros, "cpu"), torch.from_numpy(act))
        assert int(got[0][58]) == tpr.INF and int(got[1][58]) == mt.num_arcs
        for g, w, what in zip(got, want, ("minh", "argarc")):
            assert g.dtype == torch.int32
            _same(g, w, what)


@functools.lru_cache(maxsize=None)
def _pair(seed):
    g = random_graph(np.random.default_rng(seed), n_lo=12, n_hi=40)
    rj = build_residual(g, "bcsr")
    return (rj, *jpr.to_device(rj)), (_port(rj), *tpr.to_device(_port(rj),
                                                                  "cpu"))


@pytest.mark.parametrize("lanes", [2, None])
@pytest.mark.parametrize("seed", [0, 1, 4])
def test_tc_step_trajectory_matches(seed, lanes, monkeypatch):
    """STEPS consecutive ``tc_step``s from the global-relabelled preflow
    equal the JAX ``tc_step``'s, state by state."""
    (rj, gj, mj, res0j), (rt, gt, mt, _) = _pair(seed)
    if lanes is not None:
        monkeypatch.setattr(tpr, "TC_LANES", lanes * mt.n)
    s, t = 0, mj.n - 1
    jstate = jgr.global_relabel(gj, mj, jpr.preflow(gj, mj, res0j, s), s,
                                t)[0]
    tstate = tpr.state_from_numpy(*(np.asarray(x) for x in jstate),
                                  device="cpu")
    jstep = jax.jit(jpr.tc_step, static_argnums=(1, 3, 4))
    moved = False
    for _ in range(STEPS):
        nxt = jstep(gj, mj, jstate, s, t)
        moved |= not np.array_equal(np.asarray(nxt.h), np.asarray(jstate.h))
        jstate = nxt
        tstate = tpr.tc_step(gt, mt, tstate, s, t)
        _same_state(jstate, tstate)
    assert moved


@pytest.mark.parametrize("layout", ["bcsr", "rcsr"])
@pytest.mark.parametrize("case", [*CASES, "seed4"])
def test_tc_solve_matches_jax_tc_and_vc(case, layout):
    """A whole ``tc`` solve through the facade == JAX ``tc`` and JAX
    ``vc`` in value, cycles, rounds, relabels, sweeps and final state;
    the value == Dinic."""
    if case.startswith("seed"):
        gj = random_graph(np.random.default_rng(int(case[4:])), n_lo=20,
                          n_hi=60)
        gt, s, t = tgen.Graph(gj.n, gj.edges, gj.cap), 0, gj.n - 1
    else:
        name, args = CASES[case]
        gj, s, t = getattr(jgen, name)(*args)
        gt = getattr(tgen, name)(*args)[0]
    rj = build_residual(gj, layout)
    want_tc = jpr.solve_impl(rj, s, t, mode="tc")
    want_vc = jpr.solve_impl(rj, s, t, mode="vc")
    sol = Solver(mode="tc", layout=layout, device="cpu").solve(
        MaxflowProblem(gt, s, t))
    assert sol.value == dinic_maxflow(gj, s, t) and sol.stats.cycles > 0
    for want in (want_tc, want_vc):
        assert sol.value == want.maxflow
        for f in ("cycles", "rounds", "global_relabels", "gr_sweeps"):
            assert getattr(sol.stats, f) == getattr(want, f), f
        _same_state(want.state, sol.state)


def test_tc_telemetry_matches_jax():
    """``tc`` with the device counters: the same pushes, relabels and
    per-cycle histories as the JAX ``tc`` solve's."""
    (rj, *_), (rt, *_) = _pair(4)
    s, t = 0, rj.n - 1
    want = jpr.solve_impl(rj, s, t, mode="tc", instrument=True)
    got = tpr.solve_impl(rt, s, t, mode="tc", instrument=True, device="cpu")
    for f in ("maxflow", "cycles", "pushes", "relabels"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("active_history", "frontier_history", "maxdeg_history"):
        _same(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("lanes", [3, None])
@pytest.mark.parametrize("layout", ["bcsr", "rcsr"])
def test_batched_tc_matches_jax(layout, lanes, monkeypatch):
    """The batched ``tc`` step over the flat graph of B disjoint parts ==
    the JAX batched ``tc`` (vmapped), padded states, per-row cycles and
    rounds, relabels and sweeps; values == Dinic."""
    rng = np.random.default_rng(11)
    graphs = [random_graph(rng, n_lo=8, n_hi=30) for _ in range(3)]
    js = [(build_residual(g, layout), 0, g.n - 1) for g in graphs]
    js.append((js[0][0], 2, 2))  # a trivial lane
    ts = [(_port(r), s, t) for r, s, t in js]
    if lanes is not None:  # chunks of `lanes` columns over B * n_pad rows
        n_pad = max(r.n for r, _, _ in js)
        monkeypatch.setattr(tpr, "TC_LANES", lanes * len(js) * n_pad)
    want = jb.batched_solve_impl(js, mode="tc", cycle_chunk=8)
    got = tb.batched_solve_impl(ts, mode="tc", cycle_chunk=8, device="cpu")
    for f in ("res", "h", "e"):
        _same(getattr(got.state, f), getattr(want.state, f), f)
    for f in ("maxflows", "cycles", "rounds", "converged", "trivial"):
        _same(getattr(got, f), getattr(want, f), f)
    assert (got.global_relabels, got.gr_sweeps) == (want.global_relabels,
                                                     want.gr_sweeps)
    assert got.maxflows.tolist() == [dinic_maxflow(g, 0, g.n - 1)
                                     for g in graphs] + [0]


def test_batched_tc_solve_many_matches_batched_vc():
    """``solve_many`` in ``tc`` == in ``vc``, row by row (values, cycles
    and the corrected states)."""
    probs = [MaxflowProblem(*tgen.washington_rlg(6, 5 + i, seed=i))
             for i in range(3)]
    tc = Solver(backend="batched", mode="tc", device="cpu").solve_many(probs)
    vc = Solver(backend="batched", mode="vc", device="cpu").solve_many(probs)
    for a, b in zip(tc, vc):
        assert a.value == b.value and a.stats.cycles == b.stats.cycles
        for f in ("res", "h", "e"):
            assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
