"""The port's device phase 2 (preflow -> flow) against the JAX package's,
on the same numpy inputs: ``phase2_impl`` and ``batched_phase2_impl``
(flat-frontier and ``scan=True`` selectors, and the kernel hook, which on
the CPU runs its plain version) bit for bit in ``res``, ``e`` and the
leftover; the host BFS oracle against JAX's; ``flows_from_state``;
``batched_solve_impl(phase2=True)``; and invalid preflows, which raise
naming the lanes.  The inputs are the final preflows of JAX ``vc``
solves, which strand excess.  Tolerance: exact equality."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as jb
from repro.core import phase2 as jp2
from repro.core import pushrelabel as jpr
from repro.core.csr import Graph as JGraph
from repro.core.csr import build_residual
from repro.graphs import generators as jgen
from repro_torch.core import batched as tb
from repro_torch.core import engine
from repro_torch.core import phase2 as tp2
from repro_torch.core import pushrelabel as tpr
from repro_torch.core.csr import residual_from_arrays

CASES = {
    "washington": ("washington_rlg", (10, 10)),
    "genrmf": ("genrmf", (3, 5)),
    "random_sparse": ("random_sparse", (300, 1200)),
}


def _messy_graph(seed, n_lo=6, n_hi=30):
    """A random graph with parallel arcs and self-loops."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(n_lo, n_hi))
    m = int(rng.integers(n, 5 * n))
    edges = rng.integers(0, n, size=(m, 2)).astype(np.int64)
    dup = edges[rng.integers(m, size=max(2, m // 4))]
    loops = np.stack([v := rng.integers(0, n, size=2), v], axis=1)
    edges = np.concatenate([edges, dup, loops.astype(np.int64)])
    caps = rng.integers(1, 20, size=len(edges)).astype(np.int64)
    return JGraph(n, edges, caps), 0, n - 1


def _graph(case):
    if case.startswith("messy"):
        return _messy_graph(int(case[5:]))
    name, args = CASES[case]
    return getattr(jgen, name)(*args)


def _port(rj):
    return residual_from_arrays(**dataclasses.asdict(rj))


@functools.lru_cache(maxsize=None)
def _preflow(case, layout):
    """``(rj, s, t, JAX vc solve)`` of a case."""
    g, s, t = _graph(case)
    rj = build_residual(g, layout)
    return rj, s, t, jpr.solve_impl(rj, s, t, mode="vc")


def _stranded(e, s, t):
    e = np.asarray(e).copy()
    e[[s, t]] = 0
    return int(e.sum())


def _same(got, want, what=""):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


def _hook(kernel):
    return engine.resolve_minh_fn("vc_kernel") if kernel else None


@pytest.mark.parametrize("sel", ["flat", "scan", "kernel"])
@pytest.mark.parametrize("layout", ["bcsr", "rcsr"])
@pytest.mark.parametrize("case", [*CASES, "messy1", "messy5"])
def test_phase2_impl_matches_jax(case, layout, sel):
    rj, s, t, sol = _preflow(case, layout)
    gj, mj, res0j = jpr.to_device(rj)
    want = jp2.phase2_run(gj, mj, res0j, sol.state.res, sol.state.e,
                          jnp.int32(s), jnp.int32(t), scan=sel == "scan")
    gt, mt, res0t = tpr.to_device(_port(rj), "cpu")
    st = tpr.state_from_numpy(*(np.asarray(x) for x in sol.state),
                              device="cpu")
    got = tp2.phase2_impl(gt, mt, res0t, st.res, st.e, s, t,
                          minh_fn=_hook(sel == "kernel"), scan=sel == "scan")
    for g, w, what in zip(got, want, ("res", "e", "leftover")):
        assert g.dtype == torch.int32, what
        _same(g, w, what)
    assert int(got[2]) == 0


def test_the_cases_strand_excess():
    """Phase 2 has work to do on the cases above."""
    stranded = [_stranded(_preflow(c, "bcsr")[3].state.e,
                          *_preflow(c, "bcsr")[1:3])
                for c in (*CASES, "messy1", "messy5")]
    assert sum(x > 0 for x in stranded) >= 4, stranded


@pytest.mark.parametrize("layout", ["bcsr", "rcsr"])
@pytest.mark.parametrize("case", [*CASES, "messy3"])
def test_convert_and_host_oracle_match_jax(case, layout):
    """``convert_preflow_to_flow`` on the device path and the host BFS
    oracle each equal JAX's; ``flows_from_state`` too."""
    rj, s, t, sol = _preflow(case, layout)
    rt = _port(rj)
    state = tpr.PRState(*(np.asarray(x) for x in sol.state))
    for ref in (False, True):
        want = jpr.convert_preflow_to_flow(rj, sol.state, s, t,
                                           reference=ref)
        got = tpr.convert_preflow_to_flow(rt, state, s, t, reference=ref,
                                          device="cpu")
        assert got.dtype == np.int64
        _same(got, want, f"reference={ref}")
        _same(tpr.flows_from_state(rt, state, s, t, reference=ref,
                                   device="cpu"),
              jpr.flows_from_state(rj, sol.state, s, t, reference=ref))
    _same(tpr.flows_from_state(rt, state), jpr.flows_from_state(rj,
                                                                  sol.state))
    # a tensor state gives the same, and the kernel hook too
    tstate = tpr.state_from_numpy(*state, device="cpu")
    _same(tpr.convert_preflow_to_flow(rt, tstate, s, t, use_kernel=True,
                                      device="cpu"),
          jpr.convert_preflow_to_flow(rj, sol.state, s, t))


def _batch(layout, seeds=(2, 3, 4, 6)):
    """JAX and port packs of messy instances (and a trivial lane), the
    JAX batched ``vc`` solve's final preflow."""
    js = [(build_residual(g, layout), s, t)
          for g, s, t in (_messy_graph(x, 6, 16) for x in seeds)]
    js.append((js[0][0], 1, 1))
    ts = [(_port(r), s, t) for r, s, t in js]
    jbg, jmeta, jres0, jtriv = jb.pack_instances(js)
    out = jb.batched_resolve(jbg, jmeta, jb.batched_preflow(jbg, jmeta,
                                                            jres0),
                             trivial=jtriv)
    return js, ts, (jbg, jmeta, jres0), out


@pytest.mark.parametrize("sel", ["flat", "scan", "kernel"])
@pytest.mark.parametrize("layout", ["bcsr", "rcsr"])
def test_batched_phase2_matches_jax(layout, sel):
    js, ts, (jbg, jmeta, jres0), out = _batch(layout)
    assert sum(_stranded(out.state.e[i], s, t)
               for i, (_, s, t) in enumerate(js)) > 0
    want, wleft = jb.batched_phase2(jbg, jmeta, jres0, out.state,
                                    scan=sel == "scan")
    bg, meta, res0, _ = tb.pack_instances(ts, device="cpu")
    state = tb.BatchedPRState(*(torch.from_numpy(np.array(x))
                                for x in out.state))
    got, left = tb.batched_phase2(bg, meta, res0, state, scan=sel == "scan",
                                  minh_fn=_hook(sel == "kernel"))
    for f in ("res", "h", "e"):
        assert getattr(got, f).dtype == torch.int32, f
        _same(getattr(got, f), getattr(want, f), f)
    _same(left, wleft, "leftover")
    tb.check_phase2_leftover(left)
    # each row == the single-instance phase 2 of that row
    for i, (r, s, t) in enumerate(ts):
        if s == t:
            continue
        single = tpr.convert_preflow_to_flow(
            r, tpr.PRState(out.state.res[i, :r.num_arcs], None,
                           out.state.e[i, :r.n]), s, t, device="cpu")
        _same(got.res[i, :r.num_arcs], single, f"row {i}")


@pytest.mark.parametrize("mode", ["vc", "tc", "vc_kernel_bsearch"])
def test_batched_solve_phase2_matches_jax(mode):
    """``batched_solve_impl(phase2=True)`` == JAX's in ``vc``: the kernel
    modes correct on the hook (its plain version here), ``tc`` on the
    flat frontier."""
    js, ts, _, _ = _batch("bcsr", seeds=(7, 8, 9))
    want = jb.batched_solve_impl(js, mode="vc", phase2=True)
    got = tb.batched_solve_impl(ts, mode=mode, phase2=True, device="cpu")
    assert got.corrected and want.corrected
    for f in ("res", "h", "e"):
        _same(getattr(got.state, f), getattr(want.state, f), f)
    _same(got.maxflows, want.maxflows)


def _invalid(layout="bcsr"):
    """Vertex 2 holds excess that no flow brought: not a valid preflow."""
    g = JGraph(4, np.array([[0, 1], [2, 3]], np.int64),
               np.array([5, 5], np.int64))
    rj = build_residual(g, layout)
    e = np.zeros(4, np.int32)
    e[2] = 3
    return rj, tpr.PRState(res=rj.res0.astype(np.int32).copy(),
                           h=np.zeros(4, np.int32), e=e)


def test_invalid_preflow_raises():
    rj, bad = _invalid()
    rt = _port(rj)
    for ref in (False, True):
        with pytest.raises(RuntimeError, match="preflow"):
            tpr.convert_preflow_to_flow(rt, bad, 0, 3, reference=ref,
                                        device="cpu")
    gt, mt, res0t = tpr.to_device(rt, "cpu")
    st = tpr.state_from_numpy(*bad, device="cpu")
    _, _, left = tp2.phase2_impl(gt, mt, res0t, st.res, st.e, 0, 3)
    assert int(left) == 3
    # batched: the bad lane is named, the good one drains
    good = _preflow("messy1", "bcsr")
    insts = [(_port(good[0]), good[1], good[2]), (rt, 0, 3)]
    bg, meta, res0, _ = tb.pack_instances(insts, device="cpu")
    state = tb.pack_states(
        [tuple(np.asarray(x) for x in good[3].state), tuple(bad)],
        meta.n, meta.num_arcs, device="cpu")
    for scan in (False, True):
        _, left = tb.batched_phase2(bg, meta, res0, state, scan=scan)
        assert left.tolist() == [0, 3]
        with pytest.raises(RuntimeError, match=r"lanes \[1\]"):
            tb.check_phase2_leftover(left)
