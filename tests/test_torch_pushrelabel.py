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
    for mode in ("tc", "vc_fused"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpr._make_step(mode)
    with pytest.raises(ValueError, match="unknown mode"):
        tpr._make_step("nope")
    _, (rt, gt, mt, res0t) = _pair(0)
    state = tpr.preflow(gt, mt, res0t, 0)
    with pytest.raises(NotImplementedError, match="telemetry"):
        tpr.run_cycles(gt, mt, state, 0, mt.n - 1, telemetry=True)


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
