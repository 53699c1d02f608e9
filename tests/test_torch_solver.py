"""The port's facade end to end against the JAX package's solve: for every
ported mode on CPU, ``Solver(mode=m, device="cpu").solve(p)`` equals the
JAX ``vc`` solve in value, cycles, rounds, global relabels, sweeps and the
final ``res/h/e``, and the value equals Dinic.  Also: exact
``max_cycles`` budgets, the default device, what is not ported yet, and
the CLI.  Tolerance: exact equality."""
import numpy as np
import pytest
import torch

from repro.core import pushrelabel as jpr
from repro.core.csr import Graph as JGraph
from repro.core.csr import build_residual
from repro.core.ref_maxflow import dinic_maxflow
from repro.errors import BudgetExhausted as JBudgetExhausted
from repro.graphs import generators as jgen
from repro_torch.api import MaxflowProblem, MinCutProblem, Solver
from repro_torch.api import SolverOptions
from repro_torch.errors import BudgetExhausted
from repro_torch.graphs import generators as tgen
from repro_torch.launch import maxflow as tlaunch
from tests.conftest import random_graph

MODES = ("vc", "vc_kernel", "vc_kernel_bsearch")
CASES = {
    "washington": ("washington_rlg", (8, 8)),
    "genrmf": ("genrmf", (3, 4)),
    "grid": ("grid_road", (6, 6)),
    "powerlaw": ("powerlaw", (200,)),
}


def _instance(case):
    """``(jax graph, port graph, s, t)`` from the same seed."""
    if case.startswith("random"):
        g = random_graph(np.random.default_rng(int(case[6:])), n_lo=10,
                         n_hi=40)
        return g, tgen.Graph(g.n, g.edges.copy(), g.cap.copy()), 0, g.n - 1
    name, args = CASES[case]
    gj, s, t = getattr(jgen, name)(*args)
    gt, _, _ = getattr(tgen, name)(*args)
    return gj, gt, s, t


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", [*CASES, "random4", "random13"])
def test_solve_matches_jax_vc_bit_for_bit(case, mode):
    gj, gt, s, t = _instance(case)
    want = jpr.solve_impl(build_residual(gj, "bcsr"), s, t, mode="vc")
    sol = Solver(mode=mode, device="cpu").solve(MaxflowProblem(gt, s, t))
    assert sol.value == want.maxflow == dinic_maxflow(gj, s, t)
    for f in ("cycles", "rounds", "global_relabels", "gr_sweeps"):
        assert getattr(sol.stats, f) == getattr(want, f), f
    assert sol.stats.cycles > 0
    for f in ("res", "h", "e"):
        got = getattr(sol.state, f)
        assert got.device.type == "cpu" and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(want.state, f)),
                                      err_msg=f)


@pytest.mark.parametrize("mode", MODES)
def test_rcsr_layout_and_mincut_problem(mode):
    if mode == "vc_kernel_bsearch":
        with pytest.raises(ValueError, match="bcsr"):
            SolverOptions(mode=mode, layout="rcsr", device="cpu")
        return
    gj, gt, s, t = _instance("grid")
    want = jpr.solve_impl(build_residual(gj, "rcsr"), s, t, mode="vc")
    sol = Solver(mode=mode, layout="rcsr", device="cpu").solve(
        MinCutProblem(gt, s, t))
    assert sol.value == want.maxflow
    assert sol.stats.layout == "rcsr" and sol.stats.cycles == want.cycles


@pytest.mark.parametrize("max_cycles", [5, 21])
def test_budget_exhausted_matches(max_cycles):
    gj, gt, s, t = _instance("washington")
    with pytest.raises(JBudgetExhausted) as jexc:
        jpr.solve_impl(build_residual(gj, "bcsr"), s, t, mode="vc",
                       cycle_chunk=8, max_cycles=max_cycles)
    with pytest.raises(BudgetExhausted) as texc:
        Solver(mode="vc_kernel_bsearch", device="cpu",
               global_relabel_cadence=8, max_cycles=max_cycles).solve(
            MaxflowProblem(gt, s, t))
    assert texc.value.cycles_spent == jexc.value.cycles_spent == max_cycles
    assert texc.value.limit == max_cycles and texc.value.partial


def test_trivial_instances():
    g = tgen.Graph(3, np.array([[0, 1]], np.int64), np.array([4], np.int64))
    sol = Solver(device="cpu").solve(MaxflowProblem(g, 0, 2))
    assert sol.value == 0
    sol = Solver(device="cpu").solve(MaxflowProblem(g, 1, 1))
    assert sol.value == 0 and sol.stats.cycles == 0


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SolverOptions()
    with pytest.raises(RuntimeError, match="CUDA"):
        Solver(mode="vc_kernel")
    with pytest.raises(ValueError, match="device"):
        SolverOptions(device="meta")
    assert SolverOptions(device="cpu").device == "cpu"


def test_not_ported_yet_raises():
    """What stays unported raises, naming its ROADMAP entry:
    ``distributed``, ``open_stream`` and a capacity decrease below the
    routed flow (its device drain is the streaming item), on single and
    batched solutions."""
    _, gt, s, t = _instance("genrmf")
    p = MaxflowProblem(gt, s, t)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Solver(device="cpu", backend="distributed").solve(p)
    for backend in ("single", "batched"):
        solver = Solver(device="cpu", backend=backend)
        with pytest.raises(NotImplementedError, match="ROADMAP.*Streaming"):
            solver.open_stream(p)
        sol = solver.solve(p)
        res, _ = sol.warm_start.arrays()
        r = sol.warm_start.residual
        a = int(np.argmax(r.res0 - res))  # the arc carrying most flow
        with pytest.raises(NotImplementedError, match="ROADMAP.*Streaming"):
            solver.resolve(sol.warm_start,
                           [(int(r.tails[a]), int(r.heads[a]), -int(r.res0[a]))])
    with pytest.raises(ValueError, match="unknown mode"):
        SolverOptions(mode="fast", device="cpu")


def test_int32_narrowing_is_checked():
    g = JGraph(3, np.array([[0, 1], [1, 2]], np.int64),
               np.array([2**31, 1], np.int64))
    with pytest.raises(OverflowError, match="res0"):
        Solver(device="cpu").solve(MaxflowProblem(
            tgen.Graph(g.n, g.edges, g.cap), 0, 2))


@pytest.mark.parametrize("mode", MODES + ("vc_fused", "tc"))
def test_cli_smoke_verifies(mode, capsys):
    tlaunch.main(["--smoke", "--device", "cpu", "--verify", "--mode", mode,
                  "--generator", "grid"])
    out = capsys.readouterr().out
    assert "SMOKE PASS" in out and f"mode={mode}" in out


@pytest.mark.parametrize("mode", MODES + ("vc_fused", "tc"))
def test_cli_batched_smoke_verifies(mode, capsys):
    tlaunch.main(["--smoke", "--device", "cpu", "--verify", "--mode", mode,
                  "--generator", "grid", "--backend", "batched"])
    out = capsys.readouterr().out
    assert "SMOKE PASS" in out and "backend=batched" in out
