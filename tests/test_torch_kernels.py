"""The port's two kernels, through their wrappers, against the JAX
package's oracles on the same numpy inputs: ``tile_min_neighbor`` (AVQ and
dense forms, 1-D and ``(B, ·)``) against ``repro.kernels.ref.
min_neighbor_ref`` and the XLA ``_flat_frontier_minh``, ``bcsr_rev_search``
against the build-time ``rev`` table.  The reference's own Pallas kernels do
not run on this jax; its tests prove these oracles equal to them.  On the
CPU each wrapper takes its plain PyTorch version and launches nothing.
Tolerance: exact equality (int32 throughout).  The CUDA kernels against
their plain versions on the card: ``tests/test_torch_cuda.py``."""
import dataclasses
import functools
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pushrelabel as jpr
from repro.core.csr import Graph, build_residual
from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels.revsearch import bcsr_rev_search
from repro_torch.kernels.segmin import tile_min_neighbor
from tests.conftest import random_graph

INF = int(jref.INF)


def _t(x):
    return torch.from_numpy(np.array(x, np.int32))


def _np(x):
    return np.asarray(x)


@functools.lru_cache(maxsize=None)
def _instance(seed, **kw):
    """A BCSR residual with preflow residuals and random heights, and its
    active queue (as ``tests/test_kernels.py`` builds them).  Cached: the
    tests share instances so that JAX compiles each shape once."""
    rng = np.random.default_rng(seed)
    g = random_graph(rng, **kw)
    r = build_residual(g, "bcsr")
    dg, meta, res0 = jpr.to_device(r)
    state = jpr.preflow(dg, meta, res0, 0)
    h = jnp.asarray(rng.integers(0, meta.n + 2, size=meta.n), jnp.int32)
    state = jpr.PRState(res=state.res, h=h, e=state.e)
    act = jpr.active_mask(state, meta.n, 0, meta.n - 1)
    avq = jnp.nonzero(act, size=meta.n, fill_value=meta.n)[0].astype(
        jnp.int32)
    key = jnp.where(state.res > 0, state.h[dg.heads], jref.INF).astype(
        jnp.int32)
    return r, dg, meta, state, avq, key


def _check_minh(avq, indptr, key, n):
    want = jref.min_neighbor_ref(avq, indptr, key, n=n)
    got = tile_min_neighbor(_t(avq), _t(indptr), _t(key), n=n)
    for g_, w in zip(got, want):
        assert g_.dtype == torch.int32
        np.testing.assert_array_equal(g_.numpy(), _np(w))


@pytest.mark.parametrize("seed", range(3))
def test_segmin_avq_matches_ref_and_flat_frontier(seed):
    r, dg, meta, state, avq, key = _instance(seed)
    _check_minh(avq, dg.indptr, key, meta.n)
    fm, fa = jpr._flat_frontier_minh(dg, meta, state, avq, avq < meta.n)
    got = tile_min_neighbor(_t(avq), _t(r.indptr), _t(key), n=meta.n)
    np.testing.assert_array_equal(got[0].numpy(), _np(fm))
    np.testing.assert_array_equal(got[1].numpy(), _np(fa))


def test_segmin_sentinels():
    """Empty AVQ, all-INF keys (the ``(INF, A)`` pair), empty segments and a
    star vertex of degree >> 128."""
    r, dg, meta, _, _, _ = _instance(0)
    rng = np.random.default_rng(3)
    n, a = meta.n, meta.num_arcs
    _check_minh(jnp.full(n, n, jnp.int32), dg.indptr,
                jnp.full(a, INF, jnp.int32), n)
    one = jnp.concatenate([jnp.zeros(1, jnp.int32),
                           jnp.full(n - 1, n, jnp.int32)])
    got = tile_min_neighbor(_t(one), _t(r.indptr),
                            _t(np.full(a, INF)), n=n)
    assert int(got[0][0]) == INF and int(got[1][0]) == a

    n = 600
    star = Graph(n, np.array([[0, i] for i in range(1, n)], np.int64),
                 np.ones(n - 1, np.int64))
    rs = build_residual(star, "bcsr")
    h = rng.integers(0, 8, size=n)
    res = rng.integers(0, 2, size=rs.num_arcs)
    key = np.where(res > 0, h[rs.heads], INF).astype(np.int32)
    avq = np.concatenate([[0, 5], np.full(n - 2, n)]).astype(np.int32)
    _check_minh(jnp.asarray(avq), jnp.asarray(rs.indptr), jnp.asarray(key),
                n)
    # vertex n-1 of a path graph owns an empty segment in this residual
    empty = np.array([0, 0, 2, 2], np.int32)  # segments: [], [0:2], []
    _check_minh(jnp.asarray([0, 1, 2], jnp.int32), jnp.asarray(empty),
                jnp.asarray([4, 4], jnp.int32), 3)


@pytest.mark.parametrize("seed", range(3))
def test_segmin_dense_equals_arange_avq(seed):
    r, dg, meta, _, _, key = _instance(seed)
    arange = jnp.arange(meta.n, dtype=jnp.int32)
    want = jref.min_neighbor_ref(arange, dg.indptr, key, n=meta.n)
    got = tile_min_neighbor(None, _t(r.indptr), _t(key), n=meta.n)
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), _np(w))


def test_segmin_batch_rows_match_single_rows():
    """``(B, ·)`` inputs, AVQ and dense, equal the oracle row by row."""
    rng = np.random.default_rng(31)
    n, b = 30, 3
    indptr, keys, avqs = [], [], []
    for _ in range(b):
        deg = rng.integers(0, 6, size=n)
        indptr.append(np.concatenate([[0], np.cumsum(deg)]))
        keys.append(rng.integers(0, n + 2, size=int(deg.sum())))
    a = max(k.shape[0] for k in keys)
    keys = [np.pad(k, (0, a - k.shape[0]), constant_values=INF)
            for k in keys]
    for _ in range(b):
        live = np.sort(rng.choice(n, size=12, replace=False))
        avqs.append(np.concatenate([live, np.full(n - 12, n)]))
    ind_t, key_t, avq_t = (_t(np.stack(x)) for x in (indptr, keys, avqs))
    for avq in (avq_t, None):
        bm, ba = tile_min_neighbor(avq, ind_t, key_t, n=n)
        assert bm.shape == (b, n)
        for i in range(b):
            q = jnp.arange(n, dtype=jnp.int32) if avq is None \
                else jnp.asarray(avqs[i], jnp.int32)
            wm, wa = jref.min_neighbor_ref(q, jnp.asarray(indptr[i],
                                                          jnp.int32),
                                           jnp.asarray(keys[i], jnp.int32),
                                           n=n)
            np.testing.assert_array_equal(bm[i].numpy(), _np(wm))
            np.testing.assert_array_equal(ba[i].numpy(), _np(wa))


@pytest.mark.parametrize("seed", range(3))
def test_revsearch_matches_rev_table(seed):
    rng = np.random.default_rng(100 + seed)
    r, dg, meta, _, _, _ = _instance(seed)
    a = meta.num_arcs
    arcs = rng.integers(0, a + 4, size=2 * a).astype(np.int32)  # >= A too
    got = bcsr_rev_search(_t(arcs), _t(r.indptr), _t(r.heads), _t(r.tails),
                          deg_max=meta.deg_max)
    want = jref.rev_search_ref(jnp.asarray(arcs), dg.rev, a)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_revsearch_batch_rows_and_deep_segments():
    """``(B, ·)`` rows (padded to one arc count) and a hub segment of
    degree > 1024, i.e. 11 halvings."""
    rows = []
    for b in range(3):
        rng = np.random.default_rng(200 + b)
        e = rng.integers(0, 1500, size=(3000, 2))
        hub = np.stack([np.zeros(1100, np.int64), np.arange(1, 1101)], 1)
        g = Graph(1500, np.concatenate([e, hub]), np.ones(4100, np.int64))
        rows.append(build_residual(g, "bcsr"))
    a = max(r.num_arcs for r in rows)
    deg_max = max(r.deg_max for r in rows)
    assert deg_max > 1024

    def pad(f):
        return _t(np.stack([np.pad(getattr(r, f), (0, a - r.num_arcs))
                            for r in rows]))

    rng = np.random.default_rng(7)
    arcs = np.stack([np.where(q < r.num_arcs, q, a) for r, q in
                     ((r, rng.integers(0, a + 8, size=2 * a)) for r in rows)])
    got = bcsr_rev_search(_t(arcs), _t(np.stack([r.indptr for r in rows])),
                          pad("heads"), pad("tails"), deg_max=deg_max)
    for i, r in enumerate(rows):
        want = jref.rev_search_ref(jnp.asarray(arcs[i], jnp.int32),
                                   jnp.asarray(r.rev), a)
        np.testing.assert_array_equal(got[i].numpy(), _np(want))


def test_cpu_wrappers_launch_nothing():
    r, _, meta, _, avq, key = _instance(1)
    before = (tile_min_neighbor.launches, tile_min_neighbor.dense_launches,
              bcsr_rev_search.launches)
    tile_min_neighbor(_t(avq), _t(r.indptr), _t(key), n=meta.n)
    tile_min_neighbor(None, _t(r.indptr), _t(key), n=meta.n)
    bcsr_rev_search(_t(np.arange(4)), _t(r.indptr), _t(r.heads),
                    _t(r.tails), deg_max=meta.deg_max)
    assert (tile_min_neighbor.launches, tile_min_neighbor.dense_launches,
            bcsr_rev_search.launches) == before == (0, 0, 0)


def test_wrappers_reject_bad_operands():
    ind = _t([0, 1, 2])
    key = _t([1, 2])
    with pytest.raises(TypeError, match="int32"):
        tile_min_neighbor(None, ind, key.long(), n=2)
    with pytest.raises(ValueError, match="shape"):
        tile_min_neighbor(None, ind, key, n=3)
    with pytest.raises(ValueError, match="contiguous"):
        tile_min_neighbor(_t([[0, 0], [1, 1]]).t()[0], ind, key, n=2)
    with pytest.raises(ValueError, match="shape"):
        bcsr_rev_search(_t([0]), ind, key, _t([0, 1, 2]), deg_max=1)


def test_frontier_rows_is_truncated_repeat():
    """``frontier_rows`` is ``jnp.repeat(..., total_repeat_length=size)``
    on every position the callers read (before the tail)."""
    for deg, size in (([2, 0, 3], 7), ([2, 4, 3], 7), ([0, 0], 3)):
        got = tref.frontier_rows(_t(deg), size).numpy()
        want = _np(jnp.repeat(jnp.arange(len(deg)), jnp.asarray(deg),
                              total_repeat_length=size))
        k = min(size, sum(deg))
        np.testing.assert_array_equal(got[:k], want[:k])
        assert (got[k:] == len(deg)).all()


@pytest.mark.parametrize("layout", ["bcsr", "rcsr"])
def test_rev_lookup_hooks(layout):
    """``ops.rev_lookup_bsearch`` (BCSR only) and ``ops.rev_lookup_table``
    both give the JAX package's ``rev`` table, ``A`` for arcs >= A."""
    from repro_torch.core import pushrelabel as tpr
    from repro_torch.core.csr import residual_from_arrays
    from repro_torch.kernels import ops as kops

    g = random_graph(np.random.default_rng(77), n_lo=20, n_hi=40)
    rj = build_residual(g, layout)
    gt, meta, _ = tpr.to_device(
        residual_from_arrays(**dataclasses.asdict(rj)), "cpu")
    a = meta.num_arcs
    arcs = np.random.default_rng(5).integers(0, a + 4, size=2 * a)
    want = _np(jref.rev_search_ref(jnp.asarray(arcs, jnp.int32),
                                   jnp.asarray(rj.rev), a))
    np.testing.assert_array_equal(
        kops.rev_lookup_table(gt, meta, _t(arcs)).numpy(), want)
    if layout == "bcsr":
        np.testing.assert_array_equal(
            kops.rev_lookup_bsearch(gt, meta, _t(arcs)).numpy(), want)
    else:
        with pytest.raises(ValueError, match="bcsr"):
            kops.rev_lookup_bsearch(gt, meta, _t(arcs))


def test_build_dir_is_the_checkout_else_a_user_cache(tmp_path, monkeypatch):
    """Kernel libraries build into the checkout's ``build/repro_torch/``;
    an installed package, which has no checkout, builds into a per-user
    cache instead of a directory beside its installation."""
    from repro_torch.kernels import build

    root = pathlib.Path(__file__).resolve().parents[1]
    assert build.BUILD_DIR == root / "build" / "repro_torch"
    installed = (tmp_path / "lib" / "python3.12" / "site-packages"
                 / "repro_torch" / "kernels" / "build.py")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert build.build_dir(installed) == tmp_path / "cache" / "repro_torch"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert build.build_dir(installed) == (tmp_path / "home" / ".cache"
                                          / "repro_torch")
