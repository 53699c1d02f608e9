"""The port's solver core against the JAX package's, step by step, on the
same numpy inputs: ``preflow``, ``global_relabel_impl`` and 24 consecutive
``vc_step``s of every ported mode, plus the sweep engine's chunking and
exact cycle budgets.  The port's kernel modes run their plain PyTorch
versions here; the JAX side is the XLA ``vc`` step, which the reference's
tests prove equal to its kernel modes.  Tolerance: exact equality."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import globalrelabel as jgr
from repro.core import pushrelabel as jpr
from repro.core.csr import build_residual
from repro_torch.core import engine
from repro_torch.core import globalrelabel as tgr
from repro_torch.core import pushrelabel as tpr
from repro_torch.core.csr import residual_from_arrays
from tests.conftest import random_graph

MODES = ("vc", "vc_kernel", "vc_kernel_bsearch")
STEPS = 24


@functools.lru_cache(maxsize=None)
def _pair(seed):
    """One random BCSR instance on both packages, built from the same
    bytes."""
    g = random_graph(np.random.default_rng(seed), n_lo=12, n_hi=40)
    rj = build_residual(g, "bcsr")
    rt = residual_from_arrays(**dataclasses.asdict(rj))
    return (rj, *jpr.to_device(rj)), (rt, *tpr.to_device(rt, "cpu"))


def _same_state(jstate, tstate):
    for f in ("res", "h", "e"):
        want = np.asarray(getattr(jstate, f))
        got = getattr(tstate, f)
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


@pytest.mark.parametrize("seed", range(3))
def test_preflow_and_global_relabel_match(seed):
    (rj, gj, mj, res0j), (rt, gt, mt, res0t) = _pair(seed)
    s, t = 0, mj.n - 1
    sj = jpr.preflow(gj, mj, res0j, s)
    st = tpr.preflow(gt, mt, res0t, s)
    _same_state(sj, st)
    for minh in (None, "kernel"):
        fn = engine.resolve_minh_fn("vc_kernel") if minh else None
        jnew, jn, jsw = jgr.global_relabel(gj, mj, sj, s, t)
        tnew, tn, tsw = tgr.global_relabel_impl(gt, mt, st, s, t,
                                                minh_fn=fn)
        _same_state(jnew, tnew)
        assert (int(tn), int(tsw)) == (int(jn), int(jsw))


@functools.lru_cache(maxsize=None)
def _jax_trajectory(seed):
    """The JAX ``vc`` states of STEPS steps from the global-relabelled
    preflow."""
    (rj, gj, mj, res0j), _ = _pair(seed)
    s, t = 0, mj.n - 1
    state = jgr.global_relabel(gj, mj, jpr.preflow(gj, mj, res0j, s), s,
                               t)[0]
    step = jax.jit(jpr.vc_step, static_argnums=(1, 3, 4))
    out = [state]
    for _ in range(STEPS):
        out.append(step(gj, mj, out[-1], s, t))
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1, 4, 8])  # seeds that push and relabel
def test_vc_step_trajectory_matches(seed, mode):
    _, (rt, gt, mt, _) = _pair(seed)
    s, t = 0, mt.n - 1
    traj = _jax_trajectory(seed)
    for f in ("res", "h"):  # the trajectory does push and relabel
        assert not np.array_equal(np.asarray(getattr(traj[0], f)),
                                  np.asarray(getattr(traj[-1], f)))
    state = tpr.state_from_numpy(*(np.asarray(x) for x in traj[0]),
                                 device="cpu")
    step = tpr._make_step(mode)
    for i in range(1, STEPS + 1):
        state = step(gt, mt, state, s, t)
        _same_state(traj[i], state)


@pytest.mark.parametrize("seed", [0, 4])
def test_missing_reverse_arc_is_dropped(seed):
    """A push whose reverse-arc lookup returns ``A`` (not found, as on a
    malformed residual) drops its reverse scatter, as the JAX
    ``_decide_apply`` does, and touches no other arc."""
    (rj, gj, mj, res0j), (rt, gt, mt, res0t) = _pair(seed)
    s, t = 0, mj.n - 1
    jstate = _jax_trajectory(seed)[0]
    tstate = tpr.state_from_numpy(*(np.asarray(x) for x in jstate),
                                  device="cpu")
    act = tpr.active_mask(tstate, mt.n, s, t)
    avq = torch.nonzero_static(act, size=mt.n,
                               fill_value=mt.n).view(-1).to(torch.int32)
    a = mt.num_arcs

    def t_rev(g, meta, arcs):  # every even push arc loses its reverse
        return torch.where(arcs % 2 == 0, a, g.rev[torch.clamp(arcs, 0,
                                                                a - 1)])

    def j_rev(g, meta, arcs):
        return jnp.where(arcs % 2 == 0, a, g.rev[jnp.clip(arcs, 0, a - 1)])

    avq_j = jnp.asarray(avq.numpy())
    jm = jpr._flat_frontier_minh(gj, mj, jstate, avq_j, avq_j < mj.n)
    tm = tpr._flat_frontier_minh(gt, mt, tstate, avq, avq < mt.n)
    want = jpr._decide_apply(gj, mj, jstate, avq_j, avq_j < mj.n, *jm,
                             rev_fn=j_rev)
    got = tpr._decide_apply(gt, mt, tstate, avq, avq < mt.n, *tm,
                            rev_fn=t_rev)
    _same_state(want, got)
    full = tpr._decide_apply(gt, mt, tstate, avq, avq < mt.n, *tm)
    assert not torch.equal(full.res, got.res)  # a reverse scatter dropped


def test_modes_not_ported_raise():
    """``tc`` is not ported; ``vc_fused`` is not a per-cycle step (the
    reference's ``_make_step`` refuses it too) but runs in
    ``run_cycles``."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpr._make_step("tc")
    with pytest.raises(ValueError, match="per-cycle"):
        tpr._make_step("vc_fused")
    with pytest.raises(ValueError, match="unknown mode"):
        tpr._make_step("nope")
    _, (rt, gt, mt, res0t) = _pair(0)
    state = tpr.preflow(gt, mt, res0t, 0)
    for telemetry in (False, True):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpr.run_cycles(gt, mt, state, 0, mt.n - 1, mode="tc",
                           telemetry=telemetry)


@pytest.mark.parametrize("chunk", [1, 3, 4, 7])
def test_engine_chunking_is_exact(chunk):
    """Gated chunks give the per-step loop's carry and step count, for
    chunks that do and do not divide the trip count."""
    def step(c):
        x, k = c
        return x * 2 + 1, k + 1

    def cond(c):
        return c[1] < 10

    x, k = engine.run_bulk_loop(step, (torch.tensor(0), torch.tensor(0)),
                                cond_fn=cond, chunk=chunk)
    assert (int(x), int(k)) == (1023, 10)


@pytest.mark.parametrize("budget", [1, 5, 6, 13])
def test_run_cycles_budget_is_exact(budget):
    """``run_cycles`` runs exactly ``min(max_cycles, budget)`` cycles (or
    converges first), the JAX package's count and state included."""
    (rj, gj, mj, res0j), (rt, gt, mt, res0t) = _pair(1)
    s, t = 0, mj.n - 1
    jstate, jc = jpr.run_cycles(gj, mj, jpr.preflow(gj, mj, res0j, s), s, t,
                                max_cycles=12, budget=budget)
    tstate, tc = tpr.run_cycles(gt, mt, tpr.preflow(gt, mt, res0t, s), s, t,
                                max_cycles=12, budget=budget)
    assert int(tc) == int(jc) <= min(12, budget)
    _same_state(jstate, tstate)


def test_fill_at_and_active_mask():
    x = torch.arange(5, dtype=torch.int32)
    assert engine.fill_at(x, 2, -1).tolist() == [0, 1, -1, 3, 4]
    st = tpr.PRState(res=torch.zeros(1, dtype=torch.int32),
                     h=torch.tensor([5, 0, 1, 0], dtype=torch.int32),
                     e=torch.tensor([3, 2, 0, 4], dtype=torch.int32))
    assert tpr.active_mask(st, 4, 0, 3).tolist() == [False, True, False,
                                                     False]


@pytest.mark.parametrize("budget", [1, 5, 8, 13])
def test_fused_run_cycles_matches_jax_fused_driver(budget, monkeypatch):
    """``run_cycles(mode="vc_fused")`` == the JAX ``vc_fused`` driver with
    its kernel emulated: state, cycle count (a budget that is no multiple
    of K overshoots by < K in both) and telemetry."""
    from tests.test_torch_discharge import jax_kernels_emulated

    (rj, gj, mj, res0j), (rt, gt, mt, res0t) = _pair(1)
    s, t = 0, mj.n - 1
    with jax_kernels_emulated(monkeypatch):
        jstate, jc, jtel = jpr.run_cycles(
            gj, mj, jpr.preflow(gj, mj, res0j, s), s, t, mode="vc_fused",
            max_cycles=12, budget=budget, telemetry=True)
    tstate, tc, ttel = tpr.run_cycles(
        gt, mt, tpr.preflow(gt, mt, res0t, s), s, t, mode="vc_fused",
        max_cycles=12, budget=budget, telemetry=True)
    assert int(tc) == int(jc) < min(12, budget) + 8
    _same_state(jstate, tstate)
    for f in jtel._fields:
        np.testing.assert_array_equal(getattr(ttel, f).numpy(),
                                      np.asarray(getattr(jtel, f)),
                                      err_msg=f)


@pytest.mark.parametrize("seed", [0, 2])
def test_fused_solve_matches_jax_fused_solve(seed, monkeypatch):
    """The whole ``vc_fused`` solve == the JAX ``vc_fused`` solve with its
    kernels emulated, at a cadence of 12 (launches straddle the cap) and
    at 16 (a multiple of K, where it also equals the plain ``vc``
    solve)."""
    from tests.test_torch_discharge import jax_kernels_emulated

    (rj, *_), (rt, *_) = _pair(seed)
    s, t = 0, rj.n - 1
    for cadence in (12, 16):
        with jax_kernels_emulated(monkeypatch):
            want = jpr.solve_impl(rj, s, t, mode="vc_fused",
                                  cycle_chunk=cadence)
        got = tpr.solve_impl(rt, s, t, mode="vc_fused", cycle_chunk=cadence,
                             device="cpu")
        for f in ("maxflow", "cycles", "rounds", "global_relabels",
                  "gr_sweeps"):
            assert getattr(got, f) == getattr(want, f), f
        _same_state(want.state, got.state)
    plain = tpr.solve_impl(rt, s, t, mode="vc", cycle_chunk=16, device="cpu")
    assert (plain.cycles, plain.gr_sweeps) == (got.cycles, got.gr_sweeps)
    for f in ("res", "h", "e"):
        assert torch.equal(getattr(plain.state, f), getattr(got.state, f))


@pytest.mark.parametrize("chunk", [1, 3, 4])
@pytest.mark.parametrize("budget", [3, 5, 13])
def test_fused_run_cycles_chunked_matches_jax_fused_driver(budget, chunk,
                                                           monkeypatch):
    """The in-place ``vc_fused`` loop at engine chunks of 1, 3 and 4 and
    budgets that are no multiple of K = 8, so that the gate closes in the
    middle of a chunk: state, cycles and telemetry equal the JAX driver's
    with its kernel emulated."""
    from tests.test_torch_discharge import jax_kernels_emulated

    (rj, gj, mj, res0j), (rt, gt, mt, res0t) = _pair(2)
    s, t = 0, mj.n - 1
    with jax_kernels_emulated(monkeypatch):
        jstate, jc, jtel = jpr.run_cycles(
            gj, mj, jpr.preflow(gj, mj, res0j, s), s, t, mode="vc_fused",
            max_cycles=16, budget=budget, telemetry=True, chunk=chunk)
    tstate, tc, ttel = tpr.run_cycles(
        gt, mt, tpr.preflow(gt, mt, res0t, s), s, t, mode="vc_fused",
        max_cycles=16, budget=budget, telemetry=True, chunk=chunk)
    assert int(tc) == int(jc)
    _same_state(jstate, tstate)
    for f in jtel._fields:
        np.testing.assert_array_equal(getattr(ttel, f).numpy(),
                                      np.asarray(getattr(jtel, f)),
                                      err_msg=f)


@pytest.mark.parametrize("mode", ["vc", "vc_fused"])
def test_run_cycles_leaves_the_callers_state(mode):
    """``run_cycles`` works on its own copy: the caller's state tensors
    are unchanged after a loop that moved the state (``vc_fused``'s
    kernel updates in place)."""
    _, (rt, gt, mt, res0t) = _pair(1)
    state = tpr.preflow(gt, mt, res0t, 0)
    before = tpr.PRState(*(x.clone() for x in state))
    out, cycles = tpr.run_cycles(gt, mt, state, 0, mt.n - 1, mode=mode,
                                 max_cycles=16)
    assert int(cycles) > 0 and not torch.equal(out.e, before.e)
    for f in ("res", "h", "e"):
        assert torch.equal(getattr(state, f), getattr(before, f)), f
        assert getattr(out, f).data_ptr() != getattr(state, f).data_ptr()


@pytest.mark.parametrize("live", [True, False])
def test_gate_identity_shortcut_equals_where(live):
    """``engine._gate`` keeps a leaf the step returned as it was given
    (an in-place update) without a select, which is what ``torch.where``
    gives for it, and selects every other leaf; ``None`` rides along."""
    gate = torch.tensor(live)
    shared = torch.arange(4, dtype=torch.int32)
    old = (tpr.PRState(shared, torch.zeros(3, dtype=torch.int32), None),
           torch.tensor(2))
    new = (tpr.PRState(shared, torch.ones(3, dtype=torch.int32), None),
           torch.tensor(7))
    got = engine._gate(gate, new, old)
    assert got[0].res is shared
    assert torch.equal(got[0].res, torch.where(gate, shared, shared))
    assert got[0].e is None and isinstance(got[0], tpr.PRState)
    for g, n, o in ((got[0].h, new[0].h, old[0].h), (got[1], new[1],
                                                     old[1])):
        assert torch.equal(g, torch.where(gate, n, o))
    assert engine._gate(gate, old, old) is old


@pytest.mark.parametrize("chunk", [1, 3, 4, 7])
def test_engine_passes_the_gate_to_an_in_place_step(chunk):
    """With ``pass_gate=True`` an in-place step that honours its gate
    gives the out-of-place step's carry and step count, for chunks that
    do and do not divide the trip count."""
    def step(c, gate):
        x, k = c
        x.copy_(torch.where(gate, x * 2 + 1, x))  # in place, under gate
        return x, k + 1

    def cond(c):
        return c[1] < 10

    carry = (torch.zeros(3, dtype=torch.int64), torch.tensor(0))
    x, k = engine.run_bulk_loop(step, carry, cond_fn=cond, chunk=chunk,
                                pass_gate=True)
    assert x is carry[0]
    assert x.tolist() == [1023] * 3 and int(k) == 10
