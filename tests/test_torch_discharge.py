"""The port's fused discharge against the JAX package, on the same numpy
inputs.

The JAX package's own fused kernel is a Pallas TPU kernel that does not
run on the installed jax (``pl.load``/``pl.store`` are gone), so the
port is held against what its docstring promises it equals: ``k``
applications of the JAX ``pushrelabel.vc_step``, with the live-cycle
count, the any-push flag and the per-cycle counters of the JAX
``solvercounters.cycle_stats`` / ``count_relabels``.  On the CPU the
port's wrapper takes its plain version.  Tolerance: exact equality (all
of it is int32).

``jax_fused_emulation`` is also the stand-in for the JAX kernel in the
driver tests (``test_torch_pushrelabel``, ``test_torch_batched``,
``test_torch_obs``): a vmapped ``vc_step`` run ``k`` times with the same
outputs as ``fused_discharge_batched``.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as jbatched
from repro.core import globalrelabel as jgr
from repro.core import pushrelabel as jpr
from repro.core.csr import build_residual
from repro.obs import solvercounters as jsc
from repro_torch.core import pushrelabel as tpr
from repro_torch.core.csr import residual_from_arrays
from repro_torch.kernels import discharge as tdis
from tests.conftest import random_graph


def jax_fused_emulation(s, t, indptr, heads_p, rev_p, res, h, e, *, n,
                        k=8, interpret=None, counters=False):
    """``repro.kernels.discharge.fused_discharge_batched`` in plain jnp:
    ``k`` vmapped ``vc_step``s plus ``live``, ``pushed`` and the
    ``(B, k)`` counters.  ``heads_p``/``rev_p`` carry ``pad_arcs``'s
    tail, which is cut off."""
    a = res.shape[1]
    meta = jpr.GraphMeta(n=n, num_arcs=a, deg_max=1, layout="batched")

    def one(indptr, heads, rev, res, h, e, s, t):
        g = jpr.DeviceGraph(indptr, heads, heads, rev)
        state = jpr.PRState(res, h, e)
        cnt = []
        for _ in range(k):
            nact, fr, md = jsc.cycle_stats(g, meta, state, s, t)
            new = jpr.vc_step(g, meta, state, s, t)
            cnt.append((nact, nact - jsc.count_relabels(state.h, new.h),
                        fr, md))
            state = new
        act, psh, fr, md = (jnp.stack(c) for c in zip(*cnt))
        return (*state, jnp.sum(act > 0).astype(jnp.int32),
                jnp.any(psh > 0).astype(jnp.int32), act, psh, fr, md)

    out = jax.vmap(one)(indptr, heads_p[:, :a], rev_p[:, :a], res, h, e,
                        jnp.asarray(s, jnp.int32), jnp.asarray(t, jnp.int32))
    if counters:
        return (*out[:5], tuple(out[5:]))
    return out[:5]


@contextlib.contextmanager
def jax_kernels_emulated(monkeypatch):
    """Run the JAX drivers' ``vc_fused`` paths with the emulated fused
    kernel, and their global-relabel sweeps on the XLA ``segment_min``
    path (the Pallas min search does not run here either; the reference
    proves both paths equal).  Caches are cleared on the way in and out
    so that no patched trace outlives the block."""
    from repro.kernels import discharge as jdis
    from repro.kernels import ops as jops

    jax.clear_caches()
    try:
        with monkeypatch.context() as m:
            m.setattr(jdis, "fused_discharge_batched", jax_fused_emulation)
            m.setattr(jops, "min_neighbor_minh_fn", lambda interpret=None:
                      None)
            yield
    finally:
        jax.clear_caches()


@functools.lru_cache(maxsize=None)
def _pair(seed, n_lo=10, n_hi=30):
    g = random_graph(np.random.default_rng(seed), n_lo=n_lo, n_hi=n_hi)
    rj = build_residual(g, "bcsr")
    rt = residual_from_arrays(**dataclasses.asdict(rj))
    return (rj, *jpr.to_device(rj)), (rt, *tpr.to_device(rt, "cpu"))


def _t(x):
    return torch.from_numpy(np.array(x, np.int32))


def _states(seed, *size):
    """The post-preflow state (an all-relabel first cycle) and the state
    after a global relabel (push-heavy cycles), on both packages."""
    (rj, gj, mj, res0j), (rt, gt, mt, res0t) = _pair(seed, *size)
    s, t = 0, mj.n - 1
    pj = jpr.preflow(gj, mj, res0j, s)
    grj = jgr.global_relabel(gj, mj, pj, s, t)[0]
    return [(name, st, tpr.state_from_numpy(*map(np.asarray, st), "cpu"))
            for name, st in (("preflow", pj), ("global_relabel", grj))]


def _want(gj, mj, state, s, t, k):
    """``k`` JAX ``vc_step``s with the counters of each cycle."""
    cnt = []
    for _ in range(k):
        nact, fr, md = jsc.cycle_stats(gj, mj, state, s, t)
        new = jpr.vc_step(gj, mj, state, s, t)
        cnt.append([int(nact), int(nact - jsc.count_relabels(state.h, new.h)),
                    int(fr), int(md)])
        state = new
    cnt = np.asarray(cnt, np.int32).T  # (4, k)
    return state, int((cnt[0] > 0).sum()), int((cnt[1] > 0).any()), cnt


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("seed", [31, 5])
def test_fused_discharge_bit_for_bit_vs_vc_step(seed, k):
    """``k`` fused cycles == ``k`` JAX ``vc_step``s: state, live cycles,
    pushed flag and all four per-cycle counters."""
    (rj, gj, mj, _), (rt, gt, mt, _) = _pair(seed)
    s, t = 0, mj.n - 1
    for name, sj, st in _states(seed):
        want, live, pushed, cnt = _want(gj, mj, sj, s, t, k)
        res, h, e, glive, gpushed, gcnt = tdis.fused_discharge_batched(
            _t([s]), _t([t]), gt.indptr[None], gt.heads[None], gt.rev[None],
            st.res[None], st.h[None], st.e[None], n=mt.n, k=k,
            counters=True)
        for f, got in (("res", res), ("h", h), ("e", e)):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f"{name}: {f}")
        assert (int(glive[0]), int(gpushed[0])) == (live, pushed), name
        got_cnt = torch.stack(gcnt)[:, 0].numpy()
        np.testing.assert_array_equal(got_cnt, cnt, err_msg=name)
        # counters=False: the same state and flags
        plain = tdis.fused_discharge_batched(
            _t([s]), _t([t]), gt.indptr[None], gt.heads[None], gt.rev[None],
            st.res[None], st.h[None], st.e[None], n=mt.n, k=k)
        assert len(plain) == 5
        for a, b in zip(plain, (res, h, e, glive, gpushed)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("terminals", ["ints", "tensors"])
def test_fused_discharge_single_instance_wrapper(terminals):
    """``fused_discharge`` (the single-instance adapter, the JAX
    package's ``fused_discharge`` signature; no driver calls it) with
    ``counters=True`` == ``k`` JAX ``vc_step``s, whether ``s``/``t`` come
    as ints or as the ``(1,)`` tensors a loop builds once."""
    (rj, gj, mj, _), (rt, gt, mt, _) = _pair(5)
    s, t = 0, mj.n - 1
    _, sj, st = _states(5)[1]
    want, live, pushed, cnt = _want(gj, mj, sj, s, t, 3)
    ends = (s, t) if terminals == "ints" else (_t([s]), _t([t]))
    res, h, e, glive, gpushed, gcnt = tdis.fused_discharge(
        gt, mt, st, *ends, k=3, counters=True)
    for f, got in (("res", res), ("h", h), ("e", e)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(want, f)))
    assert (int(glive), int(gpushed)) == (live, pushed)
    np.testing.assert_array_equal(torch.stack(gcnt).numpy(), cnt)


def test_fused_discharge_batched_rows_with_padded_and_trivial_lanes():
    """B = 3 rows packed by the JAX batched core (different sizes, one
    trivial lane) == the JAX emulation on the same packed arrays."""
    insts = []
    for seed in (1, 2):
        g = random_graph(np.random.default_rng(seed), n_lo=8, n_hi=30)
        insts.append((build_residual(g, "bcsr"), 0, g.n - 1))
    insts.append((insts[0][0], 3, 3))  # s == t: trivial
    bg, meta, res0, _ = jbatched.pack_instances(insts)
    state = jbatched.batched_preflow(bg, meta, res0)
    state, _, _ = jbatched.batched_global_relabel(bg, meta, state)
    args = [np.asarray(x) for x in (bg.s, bg.t, bg.indptr, bg.heads, bg.rev,
                                    *state)]
    want = jax_fused_emulation(*args, n=meta.n, k=3, counters=True)
    got = tdis.fused_discharge_batched(*map(_t, args), n=meta.n, k=3,
                                       counters=True)
    for w, g in zip((*want[:5], *want[5]), (*got[:5], *got[5])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[3][2]) == 0  # the trivial lane never lives


def test_fused_discharge_empty_avq_is_noop():
    """A converged (or never-started) state passes through unchanged and
    reports zero live cycles and no push."""
    _, (rt, gt, mt, res0t) = _pair(32, 5, 40)
    zeros = torch.zeros(mt.n, dtype=torch.int32)
    idle = tpr.PRState(res=res0t, h=zeros, e=zeros.clone())
    res, h, e, live, pushed = tdis.fused_discharge(gt, mt, idle, 0,
                                                   mt.n - 1, k=4)
    assert (int(live), int(pushed)) == (0, 0)
    assert torch.equal(res, res0t) and torch.equal(h, zeros)
    assert torch.equal(e, zeros)
    assert res is not res0t  # outputs are new tensors


def test_fused_discharge_live_cycle_accounting():
    """``live`` at k = 64 counts exactly the cycles that began with an
    active vertex (stepping the JAX ``vc_step`` until the AVQ empties)."""
    (rj, gj, mj, _), (rt, gt, mt, _) = _pair(33, 8, 16)
    s, t = 0, mj.n - 1
    _, sj, st = _states(33, 8, 16)[1]
    want_live, ref = 0, sj
    for _ in range(64):
        if int(jnp.sum(jpr.active_mask(ref, mj.n, s, t))) == 0:
            break
        ref = jpr.vc_step(gj, mj, ref, s, t)
        want_live += 1
    *_, live, _ = tdis.fused_discharge(gt, mt, st, s, t, k=64)
    assert int(live) == want_live < 64


def test_fused_discharge_pushed_flag():
    """``pushed`` reflects pushes, not e-movement: the first cycle after
    preflow is all-relabel (every height is 0) -> pushed == 0 though the
    cycle was live; a launch spanning the discharge reports a push."""
    (rj, gj, mj, _), (rt, gt, mt, _) = _pair(35, 10, 20)
    s, t = 0, mj.n - 1
    _, _, st = _states(35, 10, 20)[0]
    *_, live, pushed = tdis.fused_discharge(gt, mt, st, s, t, k=1)
    assert (int(live), int(pushed)) == (1, 0)
    *_, live, pushed = tdis.fused_discharge(gt, mt, st, s, t, k=8)
    assert int(pushed) == 1


def test_jax_emulation_matches_the_kernel_contract():
    """The emulation the driver tests patch in is the docstring's
    contract: on the JAX side, ``k`` ``vc_step``s on one row."""
    (rj, gj, mj, _), _ = _pair(31)
    s, t = 0, mj.n - 1
    sj = _states(31)[1][1]
    want, live, pushed, cnt = _want(gj, mj, sj, s, t, 3)
    from repro.kernels.discharge import pad_arcs

    out = jax_fused_emulation(
        jnp.full((1,), s), jnp.full((1,), t), gj.indptr[None],
        pad_arcs(gj.heads[None]), pad_arcs(gj.rev[None]), sj.res[None],
        sj.h[None], sj.e[None], n=mj.n, k=3, counters=True)
    for f, got in zip(("res", "h", "e"), out[:3]):
        np.testing.assert_array_equal(np.asarray(got[0]),
                                      np.asarray(getattr(want, f)))
    assert (int(out[3][0]), int(out[4][0])) == (live, pushed)
    np.testing.assert_array_equal(np.stack([np.asarray(c[0])
                                            for c in out[5]]), cnt)


def test_cpu_wrapper_launches_nothing_and_checks_operands():
    _, (rt, gt, mt, res0t) = _pair(31)
    st = tpr.preflow(gt, mt, res0t, 0)
    before = tdis.fused_discharge_batched.launches
    tdis.fused_discharge(gt, mt, st, 0, mt.n - 1, k=2)
    assert tdis.fused_discharge_batched.launches == before == 0
    args = [_t([0]), _t([mt.n - 1]), gt.indptr[None], gt.heads[None],
            gt.rev[None], st.res[None], st.h[None], st.e[None]]
    with pytest.raises(ValueError, match="k must be"):
        tdis.fused_discharge_batched(*args, n=mt.n, k=0)
    bad = list(args)
    bad[5] = bad[5].long()
    with pytest.raises(TypeError, match="int32"):
        tdis.fused_discharge_batched(*bad, n=mt.n)
    with pytest.raises(ValueError, match="shape"):
        tdis.fused_discharge_batched(*args, n=mt.n + 1)
    bad = list(args)
    bad[3] = torch.cat([gt.heads, gt.heads])[None, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tdis.fused_discharge_batched(*bad, n=mt.n)


def _entry_args(seed, name):
    """The fused kernel's operands for one row of ``_states(seed)``'s
    ``name`` state (``idle``: the post-relabel state with no excess),
    and the JAX state they hold."""
    (rj, gj, mj, _), (rt, gt, mt, _) = _pair(seed)
    s, t = 0, mj.n - 1
    states = {nm: (sj, st) for nm, sj, st in _states(seed)}
    sj, st = states["global_relabel" if name == "idle" else name]
    if name == "idle":
        sj = jpr.PRState(sj.res, sj.h, jnp.zeros_like(sj.e))
        st = tpr.PRState(st.res, st.h, torch.zeros_like(st.e))
    graph = (_t([s]), _t([t]), gt.indptr[None], gt.heads[None],
             gt.rev[None])
    return (gj, mj, sj, s, t), graph, tuple(x[None] for x in st), mt.n


@pytest.mark.parametrize("gate", ["open", "none"])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("name", ["preflow", "global_relabel", "idle"])
def test_in_place_entry_with_gate_open_equals_plain(name, k, gate):
    """``fused_discharge_batched_`` with the gate open (a true 0-d tensor,
    or ``None``) leaves in ``res/h/e`` what the out-of-place plain version
    returns and what ``k`` JAX ``vc_step``s give, and returns its live
    cycles, pushed flag and per-cycle counters."""
    (gj, mj, sj, s, t), graph, state, n = _entry_args(5, name)
    want = tdis.fused_discharge_batched_plain(*graph, *state, n=n, k=k,
                                              counters=True)
    jstate, live, pushed, cnt = _want(gj, mj, sj, s, t, k)
    work = tuple(x.clone() for x in state)
    g = torch.tensor(True) if gate == "open" else None
    glive, gpushed, gcnt = tdis.fused_discharge_batched_(
        *graph, *work, n=n, k=k, gate=g, counters=True)
    for f, got, w in zip(("res", "h", "e"), work, want[:3]):
        assert torch.equal(got, w), f
        np.testing.assert_array_equal(got[0].numpy(),
                                      np.asarray(getattr(jstate, f)))
    assert torch.equal(glive, want[3]) and torch.equal(gpushed, want[4])
    assert (int(glive[0]), int(gpushed[0])) == (live, pushed)
    for a, b in zip(gcnt, want[5]):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    np.testing.assert_array_equal(torch.stack(gcnt)[:, 0].numpy(), cnt)


@pytest.mark.parametrize("counters", [False, True])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("name", ["preflow", "global_relabel", "idle"])
def test_in_place_entry_with_gate_closed_changes_nothing(name, k, counters):
    """A closed gate leaves ``res/h/e`` bit for bit as they were and
    reports 0 live cycles, no push and zero counters, also in a scratch
    that held the outputs of an earlier launch."""
    _, graph, state, n = _entry_args(31, name)
    work = tuple(x.clone() for x in state)
    scratch = tdis.discharge_scratch(1, n, k, "cpu")
    tdis.fused_discharge_batched_(*graph, *tuple(x.clone() for x in state),
                                  n=n, k=k, gate=None, scratch=scratch)
    out = tdis.fused_discharge_batched_(*graph, *work, n=n, k=k,
                                        gate=torch.tensor(False),
                                        scratch=scratch, counters=counters)
    for got, want in zip(work, state):
        assert torch.equal(got, want)
    assert len(out) == (3 if counters else 2)
    flat = (*out[:2], *(out[2] if counters else scratch.counts))
    assert all(not x.any() for x in flat)
    assert out[0].data_ptr() == scratch.live.data_ptr()  # views, no copy


def test_out_of_place_entry_leaves_its_inputs():
    """``fused_discharge_batched`` returns new tensors and leaves the
    state it was given as it was, on a state the launch changes."""
    _, graph, state, n = _entry_args(5, "global_relabel")
    before = tuple(x.clone() for x in state)
    res, h, e, *_ = tdis.fused_discharge_batched(*graph, *state, n=n, k=3)
    for got, old, new in zip(state, before, (res, h, e)):
        assert torch.equal(got, old)
        assert new.data_ptr() != got.data_ptr()
    assert not (torch.equal(res, state[0]) and torch.equal(e, state[2]))


def test_scratch_reused_across_launches_equals_fresh_scratch():
    """Launch after launch on one scratch (the drivers' loop) gives what
    a fresh scratch gives each time, every output written anew, and the
    accumulators ahead of the queue stay 0."""
    _, graph, state, n = _entry_args(5, "preflow")
    shared = tdis.discharge_scratch(1, n, 3, "cpu")
    a = tuple(x.clone() for x in state)
    b = tuple(x.clone() for x in state)
    for _ in range(4):
        got = tdis.fused_discharge_batched_(*graph, *a, n=n, k=3, gate=None,
                                            scratch=shared, counters=True)
        want = tdis.fused_discharge_batched_(*graph, *b, n=n, k=3, gate=None,
                                             counters=True)
        for x, y in zip((*a, *got[:2], *got[2]), (*b, *want[:2], *want[2])):
            assert torch.equal(x, y)
    assert not shared.queue[:, :tdis.N_ACC].any()


def test_in_place_entry_checks_gate_and_scratch():
    _, graph, state, n = _entry_args(31, "preflow")
    with pytest.raises(ValueError, match="gate"):
        tdis.fused_discharge_batched_(*graph, *state, n=n, k=2,
                                      gate=torch.tensor([True]))
    with pytest.raises(ValueError, match="gate"):
        tdis.fused_discharge_batched_(*graph, *state, n=n, k=2,
                                      gate=torch.tensor(1))
    with pytest.raises(ValueError, match="scratch.counts"):
        tdis.fused_discharge_batched_(
            *graph, *state, n=n, k=2, gate=None,
            scratch=tdis.discharge_scratch(1, n, 3, "cpu"))
    with pytest.raises(ValueError, match="scratch.queue"):
        tdis.fused_discharge_batched_(
            *graph, *state, n=n, k=2, gate=None,
            scratch=tdis.discharge_scratch(1, n + 1, 2, "cpu"))
