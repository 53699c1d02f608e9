"""The port's host modules against the JAX package's: graph generators,
residual layouts, DIMACS I/O, the Dinic oracle, and the carry-across
functions for graph data and solver state.  Exact equality: the same seed
must give the same bytes."""
import dataclasses

import numpy as np
import pytest

from repro.core import csr as jcsr
from repro.core import ref_maxflow as jref
from repro.graphs import dimacs as jdimacs
from repro.graphs import generators as jgen
from repro_torch.core import csr as tcsr
from repro_torch.core import pushrelabel as tpr
from repro_torch.core import ref_maxflow as tref
from repro_torch.graphs import dimacs as tdimacs
from repro_torch.graphs import generators as tgen
from tests.conftest import random_graph

GENERATORS = [
    ("washington_rlg", (8, 6), {"seed": 3}),
    ("genrmf", (3, 4), {"seed": 1}),
    ("powerlaw", (200,), {"seed": 2}),
    ("powerlaw", (120, 3), {"max_cap": 9, "seed": 5, "directed": False}),
    ("grid_road", (6, 7), {"seed": 4}),
    ("random_sparse", (50, 200), {"seed": 6}),
]


def _same_graph(a, b):
    assert a.n == b.n
    np.testing.assert_array_equal(a.edges, b.edges)
    np.testing.assert_array_equal(a.cap, b.cap)
    assert a.edges.dtype == b.edges.dtype and a.cap.dtype == b.cap.dtype


def _same_residual(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name,args,kw", GENERATORS)
def test_generators_and_residuals_byte_identical(name, args, kw):
    gj, sj, tj = getattr(jgen, name)(*args, **kw)
    gt, st, tt = getattr(tgen, name)(*args, **kw)
    assert (sj, tj) == (st, tt)
    _same_graph(gj, gt)
    for layout in ("bcsr", "rcsr"):
        rj = jcsr.build_residual(gj, layout)
        rt = tcsr.build_residual(gt, layout)
        tcsr.validate_residual(rt)
        _same_residual(rj, rt)


def test_bipartite_generator_byte_identical():
    bj = jgen.bipartite_random(12, 9, seed=8)
    bt = tgen.bipartite_random(12, 9, seed=8)
    _same_graph(bj.graph, bt.graph)
    np.testing.assert_array_equal(bj.lr_edges, bt.lr_edges)
    assert (bj.s, bj.t, bj.n_left, bj.n_right) == \
        (bt.s, bt.t, bt.n_left, bt.n_right)


@pytest.mark.parametrize("trial", range(3))
def test_random_graph_residuals_and_dinic(trial):
    g = random_graph(np.random.default_rng(40 + trial))
    gt = tcsr.Graph(g.n, g.edges.copy(), g.cap.copy())
    for layout in ("bcsr", "rcsr"):
        _same_residual(jcsr.build_residual(g, layout),
                       tcsr.build_residual(gt, layout))
    assert tref.dinic_maxflow(gt, 0, g.n - 1) == \
        jref.dinic_maxflow(g, 0, g.n - 1)


def test_dimacs_round_trip_matches(tmp_path):
    g, s, t = tgen.grid_road(4, 5, seed=2)
    path = str(tmp_path / "g.max")
    tdimacs.write_dimacs(path, g, s, t, comment="grid")
    gt, st, tt = tdimacs.read_dimacs(path)
    gj, sj, tj = jdimacs.read_dimacs(path)
    assert (st, tt) == (sj, tj) == (s, t)
    _same_graph(gt, gj)
    with open(path, "a") as f:
        f.write("a 1 99 3\n")
    with pytest.raises(ValueError, match="outside"):
        tdimacs.read_dimacs(path)


def test_residual_from_arrays_round_trip():
    g, _, _ = jgen.genrmf(3, 3, seed=0)
    rj = jcsr.build_residual(g, "bcsr")
    rt = tcsr.residual_from_arrays(**dataclasses.asdict(rj))
    _same_residual(rj, rt)
    with pytest.raises(ValueError, match="fields"):
        tcsr.residual_from_arrays(layout="bcsr", n=1)
    bad = dataclasses.asdict(rj)
    bad["rev"] = np.zeros_like(bad["rev"])
    with pytest.raises(ValueError, match="involution"):
        tcsr.residual_from_arrays(**bad)


def test_state_from_numpy_round_trip():
    rng = np.random.default_rng(9)
    res = rng.integers(0, 50, size=30).astype(np.int32)
    h = rng.integers(0, 12, size=10).astype(np.int32)
    e = rng.integers(0, 7, size=10).astype(np.int64)
    st = tpr.state_from_numpy(res, h, e, device="cpu")
    for got, want in zip(st, (res, h, e)):
        assert got.dtype.is_floating_point is False
        assert str(got.dtype) == "torch.int32"
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(OverflowError, match="excess"):
        tpr.state_from_numpy(res, h, np.array([2**31], np.int64),
                             device="cpu")
