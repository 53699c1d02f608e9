"""The port's two kernels, through their wrappers, against the JAX
package's oracles on the same numpy inputs: ``tile_min_neighbor`` (AVQ and
dense forms, 1-D and ``(B, ·)``) and its key-gathering entry
``tile_min_neighbor_gather`` against ``repro.kernels.ref.
min_neighbor_ref`` and the XLA ``_flat_frontier_minh``, ``bcsr_rev_search``
against the build-time ``rev`` table, and the rev entry
``tile_min_neighbor_gather_rev`` against the composition of the JAX min
search, the JAX push decision and the reverse search.  The reference's own
Pallas kernels do not run on this jax; its tests prove these oracles equal
to them.  On the CPU each wrapper takes its plain PyTorch version and
launches nothing.
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
from repro_torch.kernels.revsearch import bcsr_rev_search, search_steps
from repro_torch.kernels.segmin import (tile_min_neighbor,
                                        tile_min_neighbor_gather,
                                        tile_min_neighbor_gather_rev)
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
def test_segmin_gather_avq_matches_flat_frontier(seed):
    """The gather entry's AVQ form, its key formed from ``res``, ``heads``
    and ``h``, equals the reference's XLA min search."""
    r, dg, meta, state, avq, _ = _instance(seed)
    fm, fa = jpr._flat_frontier_minh(dg, meta, state, avq, avq < meta.n)
    got = tile_min_neighbor_gather(_t(avq), _t(r.indptr), _t(r.heads),
                                   _t(state.res), _t(state.h), n=meta.n)
    np.testing.assert_array_equal(got[0].numpy(), _np(fm))
    np.testing.assert_array_equal(got[1].numpy(), _np(fa))


@pytest.mark.parametrize("batched", [False, True])
def test_segmin_gather_dense_matches_ref(batched):
    """The gather entry's dense form equals ``min_neighbor_ref`` with
    ``avq = arange(n)`` on the key built in numpy; batched rows have padded
    arcs (and a few heads inside segments) out of range, which the key
    clamps to ``[0, n-1]``."""
    rng = np.random.default_rng(41 + batched)
    n, b = 50, 3 if batched else 1
    indptr = [np.concatenate([[0], np.cumsum(rng.integers(0, 7, size=n))])
              for _ in range(b)]
    a = max(int(x[-1]) for x in indptr) + 5
    heads = rng.integers(0, n, size=(b, a))
    heads[rng.random((b, a)) < 0.05] = n + 4
    for i, ip in enumerate(indptr):
        heads[i, ip[-1]:] = rng.integers(-9, 2 * n, size=a - ip[-1])
    res = rng.integers(-2, 4, size=(b, a))
    h = rng.integers(0, n + 3, size=(b, n))
    h[rng.random((b, n)) < 0.1] = INF
    key = np.where(res > 0, np.take_along_axis(h, np.clip(heads, 0, n - 1),
                                               axis=1), INF)
    args = [_t(np.stack(indptr)), _t(heads), _t(res), _t(h)]
    if not batched:
        args = [x[0] for x in args]
    got = tile_min_neighbor_gather(None, *args, n=n)
    arange = jnp.arange(n, dtype=jnp.int32)
    for i in range(b):
        want = jref.min_neighbor_ref(arange, jnp.asarray(indptr[i], jnp.int32),
                                     jnp.asarray(key[i], jnp.int32), n=n)
        for g_, w in zip(got, want):
            np.testing.assert_array_equal((g_[i] if batched else g_).numpy(),
                                          _np(w))


def test_segmin_negative_entries_are_sentinels():
    """A queue entry ``u < 0`` gives ``(INF, A)``, as ``u >= n`` does, in
    both entries (the kernel's ballot takes ``0 <= u < n`` only)."""
    r, _, meta, state, _, key = _instance(2)
    n, a = meta.n, meta.num_arcs
    avq = _t([0, -1, n, 1, -7, 2])
    want = tile_min_neighbor(_t([0, n, n, 1, n, 2]), _t(r.indptr), _t(key),
                             n=n)
    for got in (tile_min_neighbor(avq, _t(r.indptr), _t(key), n=n),
                tile_min_neighbor_gather(avq, _t(r.indptr), _t(r.heads),
                                         _t(state.res), _t(state.h), n=n)):
        for g_, w in zip(got, want):
            assert torch.equal(g_, w)
        assert got[0][[1, 4]].tolist() == [INF, INF]
        assert got[1][[1, 4]].tolist() == [a, a]


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
    r, _, meta, state, avq, key = _instance(1)

    def counts():
        return (tile_min_neighbor.launches, tile_min_neighbor.dense_launches,
                tile_min_neighbor_gather.launches,
                tile_min_neighbor_gather.dense_launches,
                tile_min_neighbor_gather_rev.launches,
                bcsr_rev_search.launches)

    before = counts()
    for q in (_t(avq), None):
        tile_min_neighbor(q, _t(r.indptr), _t(key), n=meta.n)
        tile_min_neighbor_gather(q, _t(r.indptr), _t(r.heads),
                                 _t(state.res), _t(state.h), n=meta.n)
    tile_min_neighbor_gather_rev(_t(avq), _t(r.indptr), _t(r.heads),
                                 _t(r.tails), _t(state.res), _t(state.h),
                                 n=meta.n, deg_max=meta.deg_max)
    bcsr_rev_search(_t(np.arange(4)), _t(r.indptr), _t(r.heads),
                    _t(r.tails), deg_max=meta.deg_max)
    assert counts() == before == (0,) * 6


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


def test_gather_wrapper_rejects_bad_operands():
    """``tile_min_neighbor_gather`` checks every operand: types, shapes
    (``h`` has ``n`` entries a row, ``heads``/``res`` the arcs'),
    contiguity and rank."""
    ind, heads, res, h = _t([0, 1, 2]), _t([1, 0]), _t([1, 1]), _t([3, 4])
    with pytest.raises(TypeError, match="int32"):
        tile_min_neighbor_gather(None, ind, heads.long(), res, h, n=2)
    with pytest.raises(TypeError, match="int32"):
        tile_min_neighbor_gather(None, ind, heads, res, h.float(), n=2)
    with pytest.raises(ValueError, match="h has shape"):
        tile_min_neighbor_gather(None, ind, heads, res, _t([3, 4, 5]), n=2)
    with pytest.raises(ValueError, match="heads has shape"):
        tile_min_neighbor_gather(None, ind, _t([1, 0, 1]), res, h, n=2)
    with pytest.raises(ValueError, match="avq has shape"):
        tile_min_neighbor_gather(_t([[0, 1]]), ind, heads, res, h, n=2)
    with pytest.raises(ValueError, match="indptr has shape"):
        tile_min_neighbor_gather(None, _t([[0, 1, 2]]), _t([[1, 0]]),
                                 _t([[1, 1]]), _t([[3, 4]]), n=3)
    with pytest.raises(ValueError, match="contiguous"):
        tile_min_neighbor_gather(None, ind, heads, _t([[1, 0], [1, 0]]).t()[0],
                                 h, n=2)
    with pytest.raises(ValueError, match=r"\(A,\) or \(B, A\)"):
        tile_min_neighbor_gather(None, ind, heads, _t(np.ones((1, 1, 2))),
                                 h, n=2)


def test_build_signatures_cover_every_entry_point():
    """Every ``extern "C"`` entry point of each ``csrc/<name>.cu`` is
    declared in ``build.SIGNATURES`` under its library with ctypes
    argtypes, one per C parameter (pointers and the stream as
    ``c_void_p``, ints as ``c_int``), and nothing else is declared."""
    import ctypes
    import re

    from repro_torch.kernels import build

    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert sorted(build.SIGNATURES) == sources
    for name in sources:
        text = (build.CSRC / f"{name}.cu").read_text()
        decls = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text))
        assert set(build.SIGNATURES[name]) == set(decls), name
        for symbol, params in decls.items():
            params = [" ".join(x.split()) for x in params.split(",")]
            want = tuple(ctypes.c_void_p if "*" in x else ctypes.c_int
                         for x in params)
            assert tuple(build.SIGNATURES[name][symbol]) == want, symbol


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
    """The reverse lookup's hook, ``ops.min_neighbor_rev_kernel`` (BCSR
    only): its ``(minh, argarc)`` are ``ops.min_neighbor_kernel``'s, and
    its ``rev`` is the JAX package's ``rev`` table at each entry that
    pushes and ``A`` at every other slot."""
    from repro_torch.core import pushrelabel as tpr
    from repro_torch.core.csr import residual_from_arrays
    from repro_torch.kernels import ops as kops

    g = random_graph(np.random.default_rng(77), n_lo=20, n_hi=40)
    rj = build_residual(g, layout)
    gt, meta, res0 = tpr.to_device(
        residual_from_arrays(**dataclasses.asdict(rj)), "cpu")
    n, a = meta.n, meta.num_arcs
    st = tpr.preflow(gt, meta, res0, 0)
    h = np.random.default_rng(5).integers(0, n + 2, size=n)
    st = tpr.PRState(st.res, _t(h), st.e)
    avq = torch.nonzero_static(tpr.active_mask(st, n, 0, n - 1), size=n,
                               fill_value=n).view(-1).to(torch.int32)
    if layout == "rcsr":
        with pytest.raises(ValueError, match="bcsr"):
            kops.min_neighbor_rev_kernel(gt, meta, st, avq, avq < n)
        return
    minh, argarc, rev = kops.min_neighbor_rev_kernel(gt, meta, st, avq,
                                                     avq < n)
    for g_, w in zip((minh, argarc),
                     kops.min_neighbor_kernel(gt, meta, st, avq, avq < n)):
        assert torch.equal(g_, w)
    _, push = tpr._push_decision(st.h, torch.clamp(avq, max=n - 1), avq < n,
                                 minh)
    assert bool(push.any())
    want = _np(jref.rev_search_ref(
        jnp.asarray(torch.where(push, argarc, a).numpy()),
        jnp.asarray(rj.rev), a))
    np.testing.assert_array_equal(rev.numpy(), want)


def _rev_case(seed: int):
    """A BCSR residual of a random graph with a hub (vertex 1, 3000 arcs:
    12 halvings, probes far apart) and a vertex of 60 arcs (vertex 2:
    wider than a warp), then tampered: runs of duplicate heads
    in both their segments, and in vertex 2's the head of the arc back to
    vertex 3100 moved away, so that 3100's push to 2 finds no reverse arc.
    Returns ``(residual, heads, n)``, ``heads`` the tampered copy."""
    rng = np.random.default_rng(seed)
    n = 3200
    edges = np.concatenate([
        rng.integers(3, 3100, size=(3000, 2)),
        np.stack([np.ones(3000, np.int64), np.arange(100, 3100)], 1),
        np.stack([np.full(60, 2), np.arange(3100, 3160)], 1)])
    r = build_residual(Graph(n, edges, np.ones(len(edges), np.int64)),
                       "bcsr")
    heads = r.heads.copy()
    for v, at in ((1, 500), (1, 2500), (2, 20)):
        lo = r.indptr[v]
        heads[lo + at:lo + at + 6] = heads[lo + at]
    heads[r.indptr[2]] = n - 1  # the arc 2 -> 3100, the segment's first
    assert r.heads[r.indptr[2]] == 3100
    return r, heads, n


def _rev_state(r, heads, n, seed):
    """A residual, heights and queue that push into the hub, into vertex 2
    and out of both: ``h`` is 0 at vertices 1 and 2 and every arc into
    them has residual; the queue holds the hub, vertex 2, their spokes and
    random vertices, padded with ``n``."""
    rng = np.random.default_rng(seed)
    res = rng.integers(-1, 3, size=r.num_arcs)
    res[np.isin(heads, (1, 2))] = 1
    h = rng.integers(1, 12, size=n)
    h[[1, 2]] = 0
    live = np.unique(np.concatenate([
        [1, 2, 3100], rng.choice(np.arange(100, 3100), 400, replace=False),
        np.arange(3101, 3160), rng.choice(np.arange(3, 100), 50)]))
    avq = np.full(n, n)
    avq[:live.size] = rng.permutation(live)
    return res, h, avq


@pytest.mark.parametrize("batched", [False, True])
def test_segmin_gather_rev_matches_composition(batched):
    """The rev entry (its plain version on the CPU) == the JAX min search
    and push decision followed by the reverse search on the push arcs
    (``A`` where an entry does not push), on a hub of 3000 arcs, a
    segment wider than a warp, duplicate heads and a push whose reverse
    arc is absent (``A``); where the segments are untouched, ``rev`` is
    the build-time table's."""
    r, heads, n = _rev_case(3)
    a = r.num_arcs
    steps = search_steps(r.deg_max)
    rows = [_rev_state(r, heads, n, 30 + b) for b in range(3 if batched
                                                             else 1)]
    res, h, avq = (np.stack(x) for x in zip(*rows))
    graph = [np.stack([x] * len(rows)) for x in (r.indptr, heads, r.tails)]
    args = [_t(x if batched else x[0]) for x in (avq, *graph)]
    got = tile_min_neighbor_gather_rev(
        args[0], *args[1:3], args[3], _t(res if batched else res[0]),
        _t(h if batched else h[0]), n=n, deg_max=r.deg_max)
    pushes_into = set()
    for b in range(len(rows)):
        key = np.where(res[b] > 0, h[b][np.clip(heads, 0, n - 1)], INF)
        jm, ja = jref.min_neighbor_ref(jnp.asarray(avq[b], jnp.int32),
                                       jnp.asarray(r.indptr),
                                       jnp.asarray(key, jnp.int32), n=n)
        _, push = jpr._push_decision(jnp.asarray(h[b], jnp.int32),
                                     jnp.minimum(jnp.asarray(avq[b]), n - 1),
                                     jnp.asarray(avq[b] < n), jm)
        arcs = np.where(_np(push), np.clip(_np(ja), 0, a - 1), a)
        want = tref.rev_search_bsearch_ref(_t(arcs), _t(r.indptr), _t(heads),
                                           _t(r.tails), steps=steps)
        row = [x[b] if batched else x for x in got]
        for g_, w in zip(row, (_np(jm), _np(ja), want.numpy())):
            np.testing.assert_array_equal(_np(g_), w)
        p_arcs = arcs[_np(push)]
        v = heads[p_arcs]
        pushes_into |= set(v[np.isin(v, (1, 2))].tolist())
        clean = ~np.isin(v, (1, 2))
        np.testing.assert_array_equal(row[2].numpy()[_np(push)][clean],
                                      r.rev[p_arcs[clean]])
        # 3100's push into vertex 2 finds no reverse arc
        at = np.flatnonzero(avq[b] == 3100)[0]
        assert bool(push[at]) and heads[int(ja[at])] == 2
        assert int(row[2][at]) == a
    assert pushes_into == {1, 2}


@pytest.mark.parametrize("seed", range(3))
def test_segmin_gather_rev_random_instances(seed):
    """On random BCSR instances (preflow residuals, random heights) the
    rev entry's ``(minh, argarc)`` are the XLA min search's, and ``rev``
    is the build-time table at each push arc, ``A`` elsewhere."""
    r, dg, meta, state, avq, _ = _instance(seed)
    n, a = meta.n, meta.num_arcs
    fm, fa = jpr._flat_frontier_minh(dg, meta, state, avq, avq < n)
    _, push = jpr._push_decision(state.h, jnp.minimum(avq, n - 1), avq < n,
                                 fm)
    got = tile_min_neighbor_gather_rev(_t(avq), _t(r.indptr), _t(r.heads),
                                       _t(r.tails), _t(state.res),
                                       _t(state.h), n=n, deg_max=r.deg_max)
    want = jref.rev_search_ref(jnp.where(push, fa, a), dg.rev, a)
    for g_, w in zip(got, (fm, fa, want)):
        np.testing.assert_array_equal(g_.numpy(), _np(w))


def test_gather_rev_wrapper_rejects_bad_operands():
    """The rev entry has no dense form and checks ``tails`` like the
    other arc arrays."""
    ind, heads, res, h = _t([0, 1, 2]), _t([1, 0]), _t([1, 1]), _t([3, 4])
    with pytest.raises(ValueError, match="no dense form"):
        tile_min_neighbor_gather_rev(None, ind, heads, heads, res, h, n=2,
                                     deg_max=1)
    with pytest.raises(ValueError, match="tails has shape"):
        tile_min_neighbor_gather_rev(_t([0, 1]), ind, heads, _t([0]), res,
                                     h, n=2, deg_max=1)
    with pytest.raises(TypeError, match="int32"):
        tile_min_neighbor_gather_rev(_t([0, 1]), ind, heads, heads.long(),
                                     res, h, n=2, deg_max=1)


def test_rev_entry_is_in_signatures():
    """``build.SIGNATURES`` declares the rev entry of ``csrc/segmin.cu``:
    nine pointers, five ints (batch, q, n, a, steps) and the stream."""
    import ctypes

    from repro_torch.kernels import build

    p, i = ctypes.c_void_p, ctypes.c_int
    assert build.SIGNATURES["segmin"]["tile_min_neighbor_gather_rev_launch"] \
        == (p,) * 9 + (i,) * 5 + (p,)


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """A library's name covers its source and every ``csrc`` header it
    includes, directly or through another header: an edit to either
    names a new library, an edit to a header it does not include does
    not."""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n #include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "c.cuh").write_text("// c\n")
    assert sorted(build.sources("k")) == ["a.cuh", "b.cuh", "k.cu"]
    seen = {build.library_path("k")}
    (tmp_path / "c.cuh").write_text("// c, edited\n")
    assert build.library_path("k") in seen
    for f in ("b.cuh", "a.cuh", "k.cu"):
        (tmp_path / f).write_text((tmp_path / f).read_text() + "// edit\n")
        path = build.library_path("k")
        assert path not in seen, f
        seen.add(path)


def test_library_path_covers_the_shared_search(tmp_path, monkeypatch):
    """``segmin.cu`` and ``revsearch.cu`` include ``revsearch.cuh``: an
    edit to it names new libraries for both, and not for
    ``discharge.cu``."""
    import shutil

    from repro_torch.kernels import build

    for f in build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {name: build.library_path(name) for name in build.SIGNATURES}
    with open(tmp_path / "revsearch.cuh", "a") as f:
        f.write("// edit\n")
    changed = {name for name in build.SIGNATURES
               if build.library_path(name) != before[name]}
    assert changed == {"segmin", "revsearch"}


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
