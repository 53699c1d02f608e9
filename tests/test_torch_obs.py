"""The port's device telemetry against the JAX package's: the counter
functions of ``solvercounters`` on the same states, single-instance
telemetry solves against the JAX ``solve_impl(instrument=True)`` (totals
and per-cycle histories), batched telemetry against the JAX
``batched_solve_impl(telemetry=True)``, in every ported mode; the
``vc_fused`` drivers against the JAX ones with the fused kernel emulated
(``test_torch_discharge.jax_kernels_emulated``).  Every solve also gives
``pushes + relabels == active``.  Tolerance: exact equality."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import batched as jb
from repro.core import pushrelabel as jpr
from repro.core.csr import build_residual
from repro.graphs import generators as jgen
from repro.obs import solvercounters as jsc
from repro_torch.api import MaxflowProblem, Solver
from repro_torch.core import batched as tb
from repro_torch.core import pushrelabel as tpr
from repro_torch.core.csr import residual_from_arrays
from repro_torch.graphs import generators as tgen
from repro_torch.obs import solvercounters as tsc
from tests.conftest import random_graph
from tests.test_torch_discharge import jax_kernels_emulated

MODES = ("vc", "vc_kernel", "vc_kernel_bsearch", "vc_fused")
HISTS = ("active_history", "frontier_history", "maxdeg_history")


def _residuals(seed):
    if seed == "grid":
        gj, s, t = jgen.grid_road(12, 12)
    else:
        gj = random_graph(np.random.default_rng(seed), n_lo=10, n_hi=40)
        s, t = 0, gj.n - 1
    rj = build_residual(gj, "bcsr")
    return rj, residual_from_arrays(**dataclasses.asdict(rj)), s, t


def test_counter_functions_match():
    rj, rt, s, t = _residuals(3)
    gj, mj, res0j = jpr.to_device(rj)
    gt, mt, res0t = tpr.to_device(rt, "cpu")
    sj = jpr.preflow(gj, mj, res0j, s)
    st = tpr.preflow(gt, mt, res0t, s)
    for _ in range(3):
        want = jsc.cycle_stats(gj, mj, sj, s, t)
        got = tsc.cycle_stats(gt, mt, st, s, t)
        for w, g in zip(want, got):
            assert g.dtype == torch.int32 and g.ndim == 0
            assert int(g) == int(w)
        nj = jpr.vc_step(gj, mj, sj, s, t)
        nt = tpr.vc_step(gt, mt, st, s, t)
        assert int(tsc.count_relabels(st.h, nt.h)) == int(
            jsc.count_relabels(sj.h, nj.h))
        sj, st = nj, nt
    tel = tsc.telemetry_init(hist=5, device="cpu")
    assert tel.active.shape == () and tel.active_hist.shape == (5,)
    tel = tsc.telemetry_init(batch=3, device="cpu")
    assert tel.pushes.shape == (3,) and tel.active_hist is None
    assert all(x.dtype == torch.int32 for x in tel[:4])
    with pytest.raises(ValueError, match="single-instance"):
        tsc.telemetry_init(batch=2, hist=4)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", ["grid", 4])
def test_single_telemetry_matches_jax_instrumented_solve(seed, mode,
                                                         monkeypatch):
    """Totals and per-cycle histories of a telemetry solve == the JAX
    ``solve_impl(instrument=True)`` (``vc`` for the one-cycle modes, the
    emulated ``vc_fused`` for the fused mode; a cadence of 12 is no
    multiple of K = 8)."""
    rj, rt, s, t = _residuals(seed)
    with jax_kernels_emulated(monkeypatch):
        want = jpr.solve_impl(rj, s, t,
                              mode="vc_fused" if mode == "vc_fused" else "vc",
                              cycle_chunk=12, instrument=True)
    got = tpr.solve_impl(rt, s, t, mode=mode, cycle_chunk=12,
                         instrument=True, device="cpu")
    for f in ("maxflow", "cycles", "rounds", "gr_sweeps", "pushes",
              "relabels"):
        assert getattr(got, f) == getattr(want, f), f
    for f in HISTS:
        h = getattr(got, f)
        assert h.dtype == np.int64 and h.shape == (got.cycles,)
        np.testing.assert_array_equal(h, getattr(want, f), err_msg=f)
    assert got.pushes + got.relabels == int(got.active_history.sum())
    assert got.pushes > 0 and got.relabels > 0


@pytest.mark.parametrize("mode", MODES)
def test_batched_telemetry_matches_jax(mode, monkeypatch):
    rng = np.random.default_rng(11)
    js = [(build_residual(random_graph(rng, n_lo=8, n_hi=30), "bcsr"), 0,
           None) for _ in range(3)]
    js = [(r, 0, r.n - 1) for r, _, _ in js]
    ts = [(residual_from_arrays(**dataclasses.asdict(r)), s, t)
          for r, s, t in js]
    with jax_kernels_emulated(monkeypatch):
        want = jb.batched_solve_impl(
            js, mode="vc_fused" if mode == "vc_fused" else "vc",
            telemetry=True)
    got = tb.batched_solve_impl(ts, mode=mode, telemetry=True, device="cpu")
    for f in ("pushes", "relabels", "active_sum", "frontier_sum", "cycles",
              "maxflows"):
        w, g = getattr(want, f), getattr(got, f)
        assert g.dtype == np.int64, f
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f)
    np.testing.assert_array_equal(got.pushes + got.relabels, got.active_sum)


@pytest.mark.parametrize("backend", ["single", "batched"])
def test_api_telemetry_stats(backend):
    """``SolverOptions(telemetry=True)`` fills ``SolveStats``: totals on
    both backends, per-cycle histories on the single one; without it the
    counters stay zero and the histories ``None``."""
    g, s, t = tgen.grid_road(12, 12, seed=2)
    p = MaxflowProblem(g, s, t)
    on = Solver(backend=backend, mode="vc_fused", telemetry=True,
                device="cpu").solve(p)
    off = Solver(backend=backend, mode="vc_fused", device="cpu").solve(p)
    assert on.value == off.value and on.stats.cycles == off.stats.cycles
    assert on.stats.pushes > 0 and on.stats.relabels > 0
    assert (off.stats.pushes, off.stats.relabels) == (0, 0)
    assert off.stats.active_history is None
    if backend == "single":
        assert on.stats.active_history.shape == (on.stats.cycles,)
        assert (on.stats.pushes + on.stats.relabels
                == int(on.stats.active_history.sum()))
    else:
        assert on.stats.active_history is None
        assert on.stats.batch_size == 1
