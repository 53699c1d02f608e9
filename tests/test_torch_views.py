"""The views that need phase 2, and warm re-solves, against the JAX
package's on the same numpy inputs: ``min_cut`` (source side, cut arcs,
value), ``extract_matching``, ``Solution.flows()``/``min_cut()``/
``matching()`` on single and batched solutions, ``WarmStartHandle``
(``validate``, ``arrays``, ``apply``) and ``Solver.resolve`` with
capacity increases against JAX ``Solver.resolve`` in mode ``vc`` (value,
cycles and the corrected residual), decreases that stay above the routed
flow (no solve) and one below it (which raises: its device drain is not
ported), and the warm-start host helpers.  Tolerance: exact equality."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import CapacityUpdate as JUpdate
from repro.api import MatchingProblem as JMatchingProblem
from repro.api import MaxflowProblem as JMaxflowProblem
from repro.api import Solver as JSolver
from repro.core import batched as jb
from repro.core import bipartite as jbip
from repro.core import mincut as jmc
from repro.core import pushrelabel as jpr
from repro.core.csr import Graph as JGraph
from repro.core.csr import build_residual
from repro.errors import HandleCorrupted as JHandleCorrupted
from repro.graphs import generators as jgen
from repro_torch.api import (CapacityUpdate, MatchingProblem,
                             MaxflowProblem, MinCutProblem, Solver)
from repro_torch.core import batched as tb
from repro_torch.core import bipartite as tbip
from repro_torch.core import mincut as tmc
from repro_torch.core import pushrelabel as tpr
from repro_torch.core.csr import residual_from_arrays
from repro_torch.errors import HandleCorrupted
from repro_torch.graphs import generators as tgen
from repro_torch.obs import REGISTRY
from repro_torch.streaming import reroute

CASES = {
    "washington": ("washington_rlg", (10, 10)),
    "genrmf": ("genrmf", (3, 5)),
    "random_sparse": ("random_sparse", (300, 1200)),
}


def _graphs(case):
    """``(jax graph, port graph, s, t)`` from the same seed."""
    name, args = CASES[case]
    gj, s, t = getattr(jgen, name)(*args)
    return gj, getattr(tgen, name)(*args)[0], s, t


def _port(rj):
    return residual_from_arrays(**dataclasses.asdict(rj))


def _same_cut(got, want):
    assert got.value == want.value
    np.testing.assert_array_equal(got.source_side, want.source_side)
    assert got.source_side.dtype == bool and got.cut_arcs.dtype == np.int64
    np.testing.assert_array_equal(got.cut_arcs, want.cut_arcs)


@pytest.mark.parametrize("layout", ["bcsr", "rcsr"])
@pytest.mark.parametrize("case", list(CASES))
def test_min_cut_matches_jax(case, layout):
    """On the preflow (phase 2 first) and on the corrected flow, with and
    without the kernel hook (its plain version on the CPU)."""
    gj, _, s, t = _graphs(case)
    rj = build_residual(gj, layout)
    rt = _port(rj)
    sol = jpr.solve_impl(rj, s, t)
    state = tpr.PRState(*(np.asarray(x) for x in sol.state))
    want = jmc.min_cut(rj, sol.state, s, t)
    assert want.value == sol.maxflow and want.cut_arcs.size > 0
    for use_kernel in (False, True):
        _same_cut(tmc.min_cut(rt, state, s, t, use_kernel=use_kernel,
                              device="cpu"), want)
    res = jpr.convert_preflow_to_flow(rj, sol.state, s, t)
    corrected = tpr.PRState(res, state.h, state.e)
    _same_cut(tmc.min_cut(rt, corrected, s, t, corrected=True,
                          device="cpu"),
              jmc.min_cut(rj, jpr.PRState(res, sol.state.h, sol.state.e), s,
                          t, corrected=True))
    value, cut = tmc.solve_min_cut(rt, s, t, device="cpu")
    assert value == want.value
    _same_cut(cut, want)


def test_min_cut_sink_reachable_raises():
    """A flow that is not maximal (none at all) has no min cut."""
    gj, _, s, t = _graphs("washington")
    rt = _port(build_residual(gj, "bcsr"))
    zero = tpr.PRState(rt.res0.astype(np.int32), np.zeros(rt.n, np.int32),
                       np.zeros(rt.n, np.int32))
    with pytest.raises(RuntimeError, match="reachable"):
        tmc.min_cut(rt, zero, s, t, corrected=True, device="cpu")


def _bipartite(seed=3):
    return (jgen.bipartite_random(40, 30, avg_deg=3.0, seed=seed),
            tgen.bipartite_random(40, 30, avg_deg=3.0, seed=seed))


@pytest.mark.parametrize("layout", ["bcsr", "rcsr"])
def test_extract_matching_matches_jax(layout):
    jp, tp = _bipartite()
    rj = build_residual(jp.graph, layout)
    sol = jbip.max_matching_impl(jp, layout=layout)
    want = jbip.extract_matching(jp, rj, sol.state)
    state = tpr.PRState(*(np.asarray(x) for x in sol.state))
    got = tbip.extract_matching(tp, _port(rj), state, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert len(got) == sol.maxflow > 0
    t_sol = tbip.max_matching_impl(tp, layout=layout, device="cpu")
    assert t_sol.maxflow == sol.maxflow


@pytest.mark.parametrize("backend", ["single", "batched"])
@pytest.mark.parametrize("mode", ["vc", "tc", "vc_kernel_bsearch"])
def test_solution_views_match_jax(mode, backend):
    """``flows()``, ``min_cut()`` and ``matching()`` of the port's
    solutions == the JAX ``vc`` solutions' (single: the lazy device
    phase 2 on the CPU; batched: the batch's corrected rows)."""
    gj, gt, s, t = _graphs("washington")
    jsol = JSolver(backend=backend).solve(JMaxflowProblem(gj, s, t))
    sol = Solver(mode=mode, backend=backend, device="cpu").solve(
        MinCutProblem(gt, s, t))
    assert sol.warm_start.corrected == (backend == "batched")
    assert sol.warm_start.device == torch.device("cpu")
    np.testing.assert_array_equal(sol.flows(), jsol.flows())
    _same_cut(sol.min_cut(), jsol.min_cut())
    assert sol.warm_start.corrected
    res, e = sol.warm_start.arrays()
    jres, je = jsol.warm_start.arrays()
    np.testing.assert_array_equal(res, jres)
    np.testing.assert_array_equal(e, je)
    assert res.dtype == e.dtype == np.int32
    with pytest.raises(TypeError, match="MatchingProblem"):
        sol.matching()
    jp, tp = _bipartite(5)
    jm = JSolver(backend=backend).solve(JMatchingProblem(jp))
    tm = Solver(mode=mode, backend=backend, device="cpu").solve(
        MatchingProblem(tp))
    np.testing.assert_array_equal(tm.matching(), jm.matching())
    assert len(tm.matching()) == tm.value == jm.value


def test_solve_many_state_is_the_corrected_row():
    """``Solution.state`` of ``solve_many`` is the row of the batch's
    corrected state: a flow whose only excess is ``e[t]``."""
    probs = [MaxflowProblem(*tgen.washington_rlg(8, 6 + i, seed=i))
             for i in range(3)]
    for sol, p in zip(Solver(backend="batched", device="cpu").solve_many(
            probs), probs):
        e = sol.state.e.clone()
        assert int(e[p.t]) == sol.value
        e[p.t] = 0
        assert not e.any()
        np.testing.assert_array_equal(sol.state.res.numpy(),
                                      sol.warm_start.arrays()[0])


def _handles(mode="vc"):
    gj, gt, s, t = _graphs("genrmf")
    return (JSolver().solve(JMaxflowProblem(gj, s, t)).warm_start,
            Solver(mode=mode, device="cpu").solve(
                MaxflowProblem(gt, s, t)).warm_start)


def test_handle_validate_arrays_apply_match_jax():
    jh, th = _handles()
    th.validate()  # the preflow passes
    assert not th.corrected
    for a, b in zip(th.arrays(), jh.arrays()):
        np.testing.assert_array_equal(a, b)
    th.validate()  # and the flow
    r = th.residual
    ups = [(int(r.tails[a]), int(r.heads[a]), 7)
           for a in np.nonzero(r.res0 > 0)[0][:3]]
    (r2, warm), (jr2, jwarm) = th.apply(ups), jh.apply(ups)
    np.testing.assert_array_equal(r2.res0, jr2.res0)
    for a, b in zip(warm, jwarm):
        np.testing.assert_array_equal(a, b)
    # corruption: every violation listed, as the reference lists them
    res, e = th.arrays()
    res[0] = -1
    e[3] = -5
    with pytest.raises(HandleCorrupted) as exc:
        th.validate()
    jres, je = jh.arrays()
    jres[0], je[3] = -1, -5
    with pytest.raises(JHandleCorrupted) as jexc:
        jh.validate()
    assert str(exc.value) == str(jexc.value)


def test_host_oracle_handle_matches_device():
    jh, th = _handles("vc_kernel")
    _, th2 = _handles()
    np.testing.assert_array_equal(th.arrays(reference=True)[0],
                                  jh.arrays(reference=True)[0])
    th2.arrays()
    th2.validate()


@pytest.mark.parametrize("mode", ["vc", "tc", "vc_kernel_bsearch",
                                  "vc_fused"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolve_increases_match_jax(seed, mode):
    """``Solver.resolve`` after capacity increases on random existing arcs
    and on every arc of the min cut (so that the flow grows) == JAX
    ``Solver.resolve`` in ``vc`` (value, cycles and the handle's
    corrected residual; ``vc_fused``, whose launches run K cycles, the
    value) and a cold solve of the updated graph."""
    gj, gt, s, t = _graphs(list(CASES)[seed])
    jsolver, solver = JSolver(), Solver(mode=mode, device="cpu")
    jsol = jsolver.solve(JMaxflowProblem(gj, s, t))
    sol = solver.solve(MaxflowProblem(gt, s, t))
    r = sol.warm_start.residual
    rng = np.random.default_rng(seed)
    picks = np.concatenate([
        rng.choice(np.nonzero(r.res0 > 0)[0], size=6, replace=False),
        sol.min_cut().cut_arcs])
    ups = [CapacityUpdate(int(r.tails[a]), int(r.heads[a]), 50)
           for a in picks]
    jups = [JUpdate(u.u, u.v, u.delta) for u in ups]
    want = jsolver.resolve(jsol.warm_start, jups)
    got = solver.resolve(sol.warm_start, ups)
    assert got.stats.warm and not got.stats.rerouted
    assert got.value == want.value > sol.value and got.stats.cycles > 0
    if mode != "vc_fused":  # K cycles a launch: its own trajectory
        assert got.stats.cycles == want.stats.cycles
        np.testing.assert_array_equal(got.warm_start.arrays()[0],
                                      want.warm_start.arrays()[0])
    r2 = got.warm_start.residual
    cold = Solver(mode=mode, device="cpu").solve(
        MaxflowProblem.from_residual(r2, s, t))
    assert got.value == cold.value


def test_resolve_decreases_and_refusals():
    """A decrease that stays above the routed flow is answered with no
    solve (``stream.noop_resolves`` + 1), as JAX answers it; one below
    the routed flow raises naming the streaming queue item; a missing
    arc, a capacity below zero and an empty set raise as in JAX."""
    g = tgen.Graph(4, np.array([[0, 1], [1, 3], [0, 2], [2, 3]], np.int64),
                   np.array([5, 9, 4, 4], np.int64))
    jg = JGraph(g.n, g.edges, g.cap)
    solver = Solver(device="cpu")
    sol = solver.solve(MaxflowProblem(g, 0, 3))
    jsol = JSolver().solve(JMaxflowProblem(jg, 0, 3))
    assert sol.value == 9
    before = REGISTRY.counter("stream.noop_resolves").value
    dec = solver.resolve(sol.warm_start, [CapacityUpdate(1, 3, -4)])
    jdec = JSolver().resolve(jsol.warm_start, [JUpdate(1, 3, -4)])
    assert REGISTRY.counter("stream.noop_resolves").value == before + 1
    assert dec.value == jdec.value == 9
    assert dec.stats.warm and dec.stats.rerouted and dec.stats.cycles == 0
    np.testing.assert_array_equal(dec.warm_start.arrays()[0],
                                  jdec.warm_start.arrays()[0])
    assert torch.equal(dec.state.res, torch.from_numpy(
        dec.warm_start.arrays()[0]))
    with pytest.raises(NotImplementedError, match="ROADMAP.*Streaming"):
        solver.resolve(sol.warm_start, [CapacityUpdate(0, 1, -2)])
    with pytest.raises(ValueError, match="negative"):
        solver.resolve(sol.warm_start, [CapacityUpdate(0, 1, -9)])
    with pytest.raises(KeyError):
        solver.resolve(sol.warm_start, [CapacityUpdate(0, 3, 1)])
    with pytest.raises(ValueError, match="empty"):
        solver.resolve(sol.warm_start, [])


def test_prepared_reroute_matches_jax():
    """The host half of the reroute: the same preparation as JAX's, and
    the same no-drain answer for increases and slack-only decreases."""
    from repro.streaming import reroute as jrr

    jh, th = _handles()
    r = th.residual
    fwd = np.nonzero(r.res0 > 0)[0]
    res, e = th.arrays()
    flow = r.res0 - res
    slack = [a for a in fwd if r.res0[a] - flow[a] >= 2][:2]
    ups = [(int(r.tails[a]), int(r.heads[a]), -1) for a in slack]
    ups.append((int(r.tails[fwd[-1]]), int(r.heads[fwd[-1]]), 3))
    prep = th.prepare_updates(ups)
    jprep = jh.prepare_updates(ups)
    assert prep.overflow == jprep.overflow == 0
    for f in ("res", "b", "e"):
        np.testing.assert_array_equal(getattr(prep, f), getattr(jprep, f))
    assert (prep.old_value, prep.inc_total) == (jprep.old_value,
                                                jprep.inc_total)
    got = reroute.drain_prepared([prep])[0]
    want = jrr.drain_prepared([jprep])[0]
    for f in ("value", "budget", "overflow", "rerouted", "ok"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.res, want.res)


def test_warm_start_host_helpers_match_jax():
    gj, _, s, t = _graphs("genrmf")
    for layout in ("bcsr", "rcsr"):
        rj = build_residual(gj, layout)
        rt = _port(rj)
        sol = jpr.solve_impl(rj, s, t)
        res = np.asarray(sol.state.res)
        e = np.asarray(sol.state.e)
        for budget in (None, 0, 3):
            for a, b in zip(tb.warm_start_arrays(rt, res, e, s, budget),
                            jb.warm_start_arrays(rj, res, e, s, budget)):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
        for a in range(0, rj.num_arcs, 7):
            u, v = int(rj.tails[a]), int(rj.heads[a])
            assert tb.find_arc(rt, u, v) == jb.find_arc(rj, u, v)
        with pytest.raises(KeyError):
            tb.find_arc(rt, rt.n, 0)
        ups = [(int(rj.tails[a]), int(rj.heads[a]), 2) for a in (0, 5)]
        r2, res2 = tb.apply_capacity_increases(rt, res, ups)
        jr2, jres2 = jb.apply_capacity_increases(rj, res, ups)
        np.testing.assert_array_equal(r2.res0, jr2.res0)
        np.testing.assert_array_equal(res2, jres2)
        with pytest.raises(ValueError, match="decreases"):
            tb.apply_capacity_increases(rt, res, [(ups[0][0], ups[0][1],
                                                   -1)])

