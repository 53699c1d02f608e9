"""The port's CUDA kernels and its solve on the card, against the plain
PyTorch versions on the same inputs.  Every test here needs a CUDA card and
skips without one; the file imports neither ``jax`` nor ``repro``, so it
runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: exact equality (int32 throughout; integer adds commute)."""
import numpy as np
import pytest
import torch

from repro_torch.api import MaxflowProblem, Solver
from repro_torch.core import batched as tb
from repro_torch.core.csr import Graph, build_residual
from repro_torch.core.ref_maxflow import dinic_maxflow
from repro_torch.graphs.generators import random_sparse, washington_rlg
from repro_torch.kernels import discharge as tdis
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.core import pushrelabel as tpr
from repro_torch.kernels.revsearch import bcsr_rev_search, search_steps
from repro_torch.kernels.segmin import (tile_min_neighbor,
                                        tile_min_neighbor_gather,
                                        tile_min_neighbor_gather_plain,
                                        tile_min_neighbor_gather_rev,
                                        tile_min_neighbor_gather_rev_plain,
                                        tile_min_neighbor_plain)

INF = kref.INF
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _t(x, dev):
    return torch.tensor(np.asarray(x), dtype=torch.int32, device=dev)


def _rows(b: int, seed: int):
    """``b`` BCSR residuals of random graphs with a hub vertex of degree
    > 1024, padded to one arc count: ``(indptr, heads, tails, rev)`` as
    ``(b, ·)`` numpy arrays, the arc count and ``deg_max``."""
    rows = []
    for i in range(b):
        rng = np.random.default_rng(seed + i)
        e = rng.integers(0, 1500, size=(3000, 2))
        hub = np.stack([np.zeros(1100, np.int64), np.arange(1, 1101)], 1)
        rows.append(build_residual(
            Graph(1500, np.concatenate([e, hub]), np.ones(4100, np.int64)),
            "bcsr"))
    a = max(r.num_arcs for r in rows)
    fields = [np.stack([r.indptr for r in rows])] + [
        np.stack([np.pad(getattr(r, f), (0, a - r.num_arcs)) for r in rows])
        for f in ("heads", "tails", "rev")]
    return fields, a, max(r.deg_max for r in rows)


def _same(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype == torch.int32
        assert torch.equal(g, w)


@pytest.mark.parametrize("batched", [False, True])
def test_segmin_kernel_matches_plain(cuda, batched):
    """AVQ and dense forms; ``u >= n`` padding, empty and all-INF segments
    and a segment longer than 1024 arcs."""
    rng = np.random.default_rng(5)
    n, b = 300, 3
    deg = rng.integers(0, 9, size=n)
    deg[[4, 40]] = 0
    deg[7] = 2500
    indptr = np.concatenate([[0], np.cumsum(deg)])
    a = int(indptr[-1])
    key = rng.integers(0, n + 2, size=(b, a))
    key[:, rng.random(a) < 0.3] = INF
    key[:, indptr[11]:indptr[12]] = INF
    avq = np.full((b, n), n)
    special = [4, 7, 11, 40]  # empty, long, all-INF, empty
    others = np.setdiff1d(np.arange(n), special)
    for i in range(b):  # distinct entries, as an AVQ holds
        live = np.sort(rng.choice(others, size=120, replace=False))
        avq[i, :124] = np.concatenate([special, live])
    if not batched:
        avq, key = avq[0], key[0]
    ip = indptr if not batched else np.tile(indptr, (b, 1))
    ip, key, avq = _t(ip, cuda), _t(key, cuda), _t(avq, cuda)
    before = tile_min_neighbor.launches
    for q in (avq, None):
        _same(tile_min_neighbor(q, ip, key, n=n),
              tile_min_neighbor_plain(q, ip, key, n=n))
    assert tile_min_neighbor.launches == before + 2


def _segmin_rows(b: int, seed: int):
    """``b`` rows of 600 vertices (not a multiple of the dense form's tile
    of 256) in numpy: a hub of 3000 arcs (vertex 7), a tile of empty
    segments only (vertices 256..511), empty segments (4, 40), an all-INF
    segment (11, ``res <= 0``), heads out of range inside segments and on
    the padded arcs past each row's last segment (with ``res > 0``), and
    heights with INF among them.  Returns ``(indptr, heads, res, h,
    key)``, ``key`` the gather entry's key built in numpy."""
    rng = np.random.default_rng(seed)
    n = 600
    rows = []
    for _ in range(b):
        deg = rng.integers(0, 10, size=n)
        deg[[4, 40]] = 0
        deg[256:512] = 0
        deg[7] = 3000
        rows.append(np.concatenate([[0], np.cumsum(deg)]))
    a = max(int(r[-1]) for r in rows) + 17  # every row has padded arcs
    heads = rng.integers(-3, n + 3, size=(b, a))
    res = rng.integers(-1, 3, size=(b, a))
    for i, ip in enumerate(rows):
        res[i, ip[11]:ip[12]] = 0
        res[i, ip[-1]:] = 1
    h = rng.integers(0, n + 2, size=(b, n))
    h[rng.random((b, n)) < 0.1] = INF
    hh = np.take_along_axis(h, np.clip(heads, 0, n - 1), axis=1)
    key = np.where(res > 0, hh, INF)
    return np.stack(rows), heads, res, h, key


def _segmin_queues(b: int, q: int, seed: int):
    """``(b, q)`` queues of distinct vertices of :func:`_segmin_rows`
    (the hub, an empty, an all-INF and an empty-tile vertex among them)
    mixed with ``u >= n`` and ``u < 0`` sentinels: the valid entries are
    not a prefix."""
    rng = np.random.default_rng(seed)
    n = 600
    special = [7, 4, 11, 300]
    others = np.setdiff1d(np.arange(n), special)
    out = np.empty((b, q), np.int64)
    for i in range(b):
        live = min(q // 2, n - len(special))
        row = np.concatenate([
            special[:live], rng.choice(others, size=live - min(live, 4),
                                       replace=False),
            rng.choice([n, n + 7, -1, -5], size=q - live)])
        out[i] = rng.permutation(row)
    return out


@pytest.mark.parametrize("entry", ["key", "gather"])
@pytest.mark.parametrize("batched", [False, True])
def test_segmin_redesign_edge_cases(cuda, entry, batched):
    """Both entries, both forms, against their plain versions: a hub of
    3000 arcs, a tile of empty segments only, ``n`` not a multiple of the
    tile, queues whose valid entries are not a prefix, ``Q`` below, at
    and above ``n``, ``u < 0``, all-INF segments, heads out of range, B = 3
    rows with padded arcs; and the gather entry equal to the key entry on
    its key."""
    n, b = 600, 3
    indptr, heads, res, h, key = (_t(x, cuda) for x in _segmin_rows(b, 11))
    sl = slice(None) if batched else 0
    queues = [_t(_segmin_queues(b, q, 12 + q)[sl], cuda)
              for q in (40, n, 2 * n + 13)] + [None]
    for avq in queues:
        ip = indptr[sl]
        if entry == "key":
            got = tile_min_neighbor(avq, ip, key[sl], n=n)
            want = tile_min_neighbor_plain(avq, ip, key[sl], n=n)
        else:
            args = (avq, ip, heads[sl], res[sl], h[sl])
            before = (tile_min_neighbor.launches,
                      tile_min_neighbor_gather.launches)
            got = tile_min_neighbor_gather(*args, n=n)
            assert (tile_min_neighbor.launches,
                    tile_min_neighbor_gather.launches) == (
                        before[0], before[1] + 1)
            want = tile_min_neighbor_gather_plain(*args, n=n)
            _same(got, tile_min_neighbor(avq, ip, key[sl], n=n))
        _same(got, want)


@pytest.mark.parametrize("batched", [False, True])
def test_segmin_gather_matches_plain(cuda, batched):
    """The gather entry on the sentinel cases of
    :func:`test_segmin_kernel_matches_plain`, its key built from random
    heads, residuals and heights."""
    rng = np.random.default_rng(5)
    n, b = 300, 3
    deg = rng.integers(0, 9, size=n)
    deg[[4, 40]] = 0
    deg[7] = 2500
    indptr = np.concatenate([[0], np.cumsum(deg)])
    a = int(indptr[-1])
    heads = rng.integers(0, n, size=(b, a))
    res = rng.integers(-1, 3, size=(b, a))
    res[:, indptr[11]:indptr[12]] = 0
    h = rng.integers(0, n + 2, size=(b, n))
    avq = np.full((b, n), n)
    special = [4, 7, 11, 40]  # empty, long, all-INF, empty
    others = np.setdiff1d(np.arange(n), special)
    for i in range(b):
        live = np.sort(rng.choice(others, size=120, replace=False))
        avq[i, :124] = np.concatenate([special, live])
    ip = np.tile(indptr, (b, 1))
    sl = slice(None) if batched else 0
    ip, heads, res, h, avq = (_t(x[sl], cuda)
                              for x in (ip, heads, res, h, avq))
    for q in (avq, None):
        _same(tile_min_neighbor_gather(q, ip, heads, res, h, n=n),
              tile_min_neighbor_gather_plain(q, ip, heads, res, h, n=n))


@pytest.mark.parametrize("batched", [False, True])
def test_revsearch_kernel_matches_plain_and_rev_table(cuda, batched):
    (indptr, heads, tails, rev), a, deg_max = _rows(3, 50)
    rng = np.random.default_rng(9)
    arcs = rng.integers(0, a + 8, size=(3, 2 * a))  # arcs >= A included
    sl = slice(None) if batched else 0
    args = [_t(x[sl], cuda) for x in (arcs, indptr, heads, tails)]
    got = bcsr_rev_search(*args, deg_max=deg_max)
    _same(got, kref.rev_search_bsearch_ref(*args, steps=search_steps(deg_max)))
    if not batched:  # the build-time rev table, on row 0's real arcs
        real = (args[0] < int(indptr[0, -1])) | (args[0] >= a)
        want = kref.rev_search_ref(args[0], _t(rev[0], cuda), a)
        torch.cuda.synchronize()
        assert torch.equal(got[real], want[real])


def _rev_case():
    """A BCSR residual with a hub (vertex 1, 3000 arcs: 12 halvings,
    probes far apart) and a vertex of 60 arcs (vertex 2, wider than a
    warp), with runs of duplicate heads in both segments and, in vertex
    2's, the arc back to 3100 moved away (its reverse is absent); with three
    states (rows) that push into and out of both.  Each queue starts with
    the 59 other spokes of vertex 2, so that a warp's searches share one
    segment.  Returns numpy ``(indptr, heads, tails, res, h, avq)`` of
    ``(3, ·)`` rows, ``n`` and ``deg_max``."""
    rng = np.random.default_rng(3)
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
    heads[r.indptr[2]] = n - 1  # the arc 2 -> 3100
    rows = []
    for b in range(3):
        res = rng.integers(-1, 3, size=r.num_arcs)
        res[np.isin(heads, (1, 2))] = 1
        h = rng.integers(1, 12, size=n)
        h[[1, 2]] = 0
        rest = np.unique(np.concatenate([
            [1, 2, 3100], rng.choice(np.arange(100, 3100), 400,
                                     replace=False),
            rng.choice(np.arange(3, 100), 50)]))
        avq = np.full(n, n)
        avq[:59] = np.arange(3101, 3160)
        avq[59:59 + rest.size] = rng.permutation(rest)
        rows.append((res, h, avq))
    res, h, avq = (np.stack(x) for x in zip(*rows))
    graph = [np.stack([x] * 3) for x in (r.indptr, heads, r.tails)]
    return (*graph, res, h, avq), n, r.deg_max


def _random_rev_rows(dev):
    """:func:`_rows`' graphs (a hub of 1100 arcs) with random residuals,
    heights and queues of distinct vertices padded with ``n``, on ``dev``:
    ``(indptr, heads, tails, rev, res, h, avq)``, ``n`` and ``deg_max``."""
    (indptr, heads, tails, rev), a, deg_max = _rows(3, 60)
    rng = np.random.default_rng(61)
    n = indptr.shape[1] - 1
    res = rng.integers(-1, 3, size=(3, a))
    h = rng.integers(0, 9, size=(3, n))
    avq = np.full((3, n), n)
    for b in range(3):
        avq[b, :900] = rng.choice(n, 900, replace=False)
    return ([_t(x, dev) for x in (indptr, heads, tails, rev, res, h, avq)],
            n, deg_max)


@pytest.mark.parametrize("batched", [False, True])
def test_gather_rev_kernel_matches_plain(cuda, batched):
    """The min search's rev entry against its plain version, one launch a
    call and none of the other entries: a hub of 3000 arcs, duplicate
    heads, a missing reverse arc, a warp whose searches share one segment,
    and random graphs; on well-formed rows ``rev`` is
    the ``rev`` table at each push."""
    sl = slice(None) if batched else 0
    arrays, n, deg_max = _rev_case()
    indptr, heads, tails, res, h, avq = (_t(x[sl], cuda) for x in arrays)
    cases = [((avq, indptr, heads, tails, res, h), n, deg_max, None)]
    (ip2, hd2, tl2, rv2, res2, h2, avq2), n2, dm2 = _random_rev_rows(cuda)
    cases.append(((avq2[sl], ip2[sl], hd2[sl], tl2[sl], res2[sl], h2[sl]),
                  n2, dm2, rv2[sl]))
    for args, n_, dm, rev in cases:
        before = (tile_min_neighbor_gather_rev.launches,
                  tile_min_neighbor_gather.launches, bcsr_rev_search.launches)
        got = tile_min_neighbor_gather_rev(*args, n=n_, deg_max=dm)
        assert (tile_min_neighbor_gather_rev.launches,
                tile_min_neighbor_gather.launches,
                bcsr_rev_search.launches) == (before[0] + 1, *before[1:])
        want = tile_min_neighbor_gather_rev_plain(*args, n=n_,
                                                  steps=search_steps(dm))
        _same(tuple(got), tuple(want))
        a = args[2].shape[-1]
        pushes = got[2] < a
        assert bool(pushes.any())
        if rev is not None:  # well-formed: every push finds its reverse
            hu = torch.gather(args[5], -1,
                              torch.clamp(args[0], 0, n_ - 1).long())
            push = (args[0] < n_) & (got[0] < INF) & (hu > got[0])
            assert torch.equal(push, pushes)
            assert torch.equal(got[2][push], torch.gather(
                rev, -1, torch.clamp(got[1], 0, a - 1).long())[push])


@pytest.mark.parametrize("batched", [False, True])
def test_revsearch_redesign_edge_cases(cuda, batched):
    """The standalone reverse search against its plain version on the
    rev entry's edge cases (the push arcs of :func:`_rev_case` among
    random arcs, ``< 0`` and ``>= A`` sentinels): rows of ``P`` lanes with
    ``P`` a multiple of the block and not, and rows that start off any
    alignment."""
    arrays, n, deg_max = _rev_case()
    indptr, heads, tails, res, h, avq = (_t(x, cuda) for x in arrays)
    _, argarc, rev = tile_min_neighbor_gather_rev(avq, indptr, heads, tails,
                                                  res, h, n=n,
                                                  deg_max=deg_max)
    a = heads.shape[-1]
    rng = np.random.default_rng(71)
    steps = search_steps(deg_max)
    for p in (4096, 4099):
        arcs = _t(rng.integers(-3, a + 3, size=(3, p)), cuda)
        arcs[:, :n // 2] = torch.where(rev < a, argarc, a)[:, :n // 2]
        for rows in ((slice(None),) if batched else (0, 1)):
            args = (arcs[rows], indptr[rows], heads[rows], tails[rows])
            before = bcsr_rev_search.launches
            got = bcsr_rev_search(*args, deg_max=deg_max)
            assert bcsr_rev_search.launches == before + 1
            _same(got, kref.rev_search_bsearch_ref(*args, steps=steps))


@pytest.mark.parametrize("backend", ["single", "batched"])
def test_bsearch_cycle_launches_the_rev_entry_once(cuda, backend):
    """A ``vc_kernel_bsearch`` cycle is one launch of the min search's
    rev entry, with no launch of the two-output entry or of
    ``bcsr_rev_search``, and equals the plain ``vc`` cycle on the CPU."""
    probs = [MaxflowProblem(*washington_rlg(24, 24, seed=s)) for s in (3, 4)]
    states = {}
    for dev in ("cuda", "cpu"):
        if backend == "single":
            r = probs[0].residual("bcsr")
            g, meta, res0 = tpr.to_device(r, dev)
            st = tpr.preflow(g, meta, res0, probs[0].s)
            states[dev] = (g, meta, st)
        else:
            bg, meta, res0, _ = tb.pack_instances(
                [(p.residual("bcsr"), p.s, p.t) for p in probs], device=dev)
            states[dev] = (bg, meta, tb.batched_preflow(bg, meta, res0))
    g, meta, st = states["cuda"]
    gc, metac, stc = states["cpu"]
    for _ in range(4):
        before = (tile_min_neighbor_gather_rev.launches,
                  tile_min_neighbor_gather.launches, bcsr_rev_search.launches)
        if backend == "single":
            s, t = probs[0].s, probs[0].t
            st = tpr._make_step("vc_kernel_bsearch")(g, meta, st, s, t)
            stc = tpr.vc_step(gc, metac, stc, s, t)
        else:
            st = tb._kernel_batch_step(g, meta, st, "vc_kernel_bsearch")
            stc = tb._kernel_batch_step(gc, metac, stc, "vc")
        assert (tile_min_neighbor_gather_rev.launches,
                tile_min_neighbor_gather.launches,
                bcsr_rev_search.launches) == (before[0] + 1, *before[1:])
        for x, y in zip(st, stc):
            assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("backend", ["single", "batched"])
@pytest.mark.parametrize("mode", ["vc_kernel", "vc_kernel_bsearch"])
def test_kernel_mode_solve_matches_cpu(cuda, mode, backend):
    """A kernel mode on the card (the gather entry in every cycle and
    sweep) equals the plain ``vc`` solve on the CPU; batched: two rows of
    different sizes through ``solve_many``."""
    probs = [MaxflowProblem(*washington_rlg(24, 24, seed=3))]
    if backend == "batched":
        probs.append(MaxflowProblem(*washington_rlg(17, 29, seed=4)))
    before = (tile_min_neighbor.launches, tile_min_neighbor_gather.launches)

    def run(m, device):
        solver = Solver(mode=m, backend=backend, device=device)
        if backend == "batched":
            return solver.solve_many(probs)
        return [solver.solve(p) for p in probs]

    before_rev = (tile_min_neighbor_gather_rev.launches,
                  bcsr_rev_search.launches)
    on_card, on_cpu = run(mode, "cuda"), run("vc", "cpu")
    # the solver's hook builds no key: the key-in entry never launches;
    # bsearch's cycles launch the rev entry, and no solve the standalone
    # reverse search
    assert tile_min_neighbor.launches == before[0]
    assert tile_min_neighbor_gather.launches > before[1]
    assert (tile_min_neighbor_gather_rev.launches > before_rev[0]) == (
        mode == "vc_kernel_bsearch")
    assert bcsr_rev_search.launches == before_rev[1]
    for a, b in zip(on_card, on_cpu):
        assert a.value == b.value
        for f in ("cycles", "rounds", "global_relabels", "gr_sweeps"):
            assert getattr(a.stats, f) == getattr(b.stats, f), f
        for f in ("res", "h", "e"):
            assert torch.equal(getattr(a.state, f).cpu(),
                               getattr(b.state, f)), f


def _fused_batch(dev):
    """Three washington rows of different sizes, the last one trivial,
    packed: the state right after preflow (an all-relabel first cycle)
    and after the first global relabel."""
    insts = []
    for i, (rows, cols) in enumerate(((12, 12), (9, 14), (12, 12))):
        g, s, t = washington_rlg(rows, cols, seed=20 + i)
        insts.append((build_residual(g, "bcsr"), s, s if i == 2 else t))
    bg, meta, res0, _ = tb.pack_instances(insts, device=dev)
    pre = tb.batched_preflow(bg, meta, res0)
    return bg, meta, (pre, tb.batched_global_relabel(bg, meta, pre)[0])


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("counters", [False, True])
def test_fused_discharge_kernel_matches_plain(cuda, k, counters):
    """B = 3 rows with padded and trivial lanes, after preflow (an
    all-relabel first cycle) and after a global relabel."""
    bg, meta, states = _fused_batch(cuda)
    for st in states:
        args = (bg.s, bg.t, bg.indptr, bg.heads, bg.rev, *st)
        before = tdis.fused_discharge_batched.launches
        got = tdis.fused_discharge_batched(*args, n=meta.n, k=k,
                                           counters=counters)
        assert tdis.fused_discharge_batched.launches == before + 1
        want = tdis.fused_discharge_batched_plain(*args, n=meta.n, k=k,
                                                  counters=counters)
        if counters:
            got, want = got[:5] + got[5], want[:5] + want[5]
        _same(tuple(got), tuple(want))
        torch.cuda.synchronize()
        assert int(got[3][2]) == 0  # the trivial lane never lives


def test_fused_discharge_kernel_idle_state(cuda):
    bg, meta, (state, _) = _fused_batch(cuda)
    state = tb.BatchedPRState(state.res, state.h, torch.zeros_like(state.e))
    res, h, e, live, pushed = tdis.fused_discharge_batched(
        bg.s, bg.t, bg.indptr, bg.heads, bg.rev, *state, n=meta.n, k=8)
    torch.cuda.synchronize()
    assert int(live.sum()) == 0 and int(pushed.sum()) == 0
    _same((res, h, e), tuple(state))


def _hub_batch(dev):
    """One instance whose vertex 1 has 3000 arcs (the source feeds it;
    it feeds 3000 spokes that all reach the sink), packed: the states
    after preflow and after the first global relabel."""
    g0, _, _ = random_sparse(3500, 6000, seed=8)
    spokes = np.arange(2, 3002)
    edges = np.concatenate([
        g0.edges, [[0, 1]], np.stack([np.ones_like(spokes), spokes], 1),
        np.stack([spokes, np.full_like(spokes, 3499)], 1)])
    cap = np.concatenate([g0.cap, [200], np.ones(6000, np.int64)])
    r = build_residual(Graph(3500, edges, cap), "bcsr")
    assert int(np.diff(r.indptr)[1]) >= 3000
    bg, meta, res0, _ = tb.pack_instances([(r, 0, 3499)], device=dev)
    pre = tb.batched_preflow(bg, meta, res0)
    return bg, meta, (pre, tb.batched_global_relabel(bg, meta, pre)[0])


def _in_place_matches_plain(args, n, k, counters, want=None):
    """The in-place entry on copies of ``args``' state, gate open then
    closed, one launch a call: open, the plain version's state and
    outputs (``want``, else computed on the card); closed, the state
    untouched and every output 0."""
    want = want or tdis.fused_discharge_batched_plain(*args, n=n, k=k,
                                                      counters=True)
    dev = args[0].device
    for gate in (True, False):
        st = [x.clone() for x in args[5:]]
        before = tdis.fused_discharge_batched.launches
        out = tdis.fused_discharge_batched_(
            *args[:5], *st, n=n, k=k, counters=counters,
            gate=torch.tensor(gate, device=dev))
        assert tdis.fused_discharge_batched.launches == before + 1
        outs = (*out[:2], *(out[2] if counters else ()))
        torch.cuda.synchronize()
        if gate:
            wants = (*want[:5], *(want[5] if counters else ()))
            for g, w in zip((*st, *outs), wants):
                assert torch.equal(g.cpu(), w.cpu())
        else:
            for g, w in zip(st, args[5:]):
                assert torch.equal(g, w)
            assert not any(bool(x.any()) for x in outs)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("counters", [False, True])
def test_fused_in_place_kernel_gate_open_and_closed(cuda, k, counters):
    """The in-place entry against the plain version, gate open and
    closed: B = 3 rows with padded and trivial lanes and a hub of 3000
    arcs, after preflow, after a global relabel and idle (no excess)."""
    for bg, meta, (pre, post) in (_fused_batch(cuda), _hub_batch(cuda)):
        idle = tb.BatchedPRState(post.res, post.h, torch.zeros_like(post.e))
        for st in (pre, post, idle):
            _in_place_matches_plain(
                (bg.s, bg.t, bg.indptr, bg.heads, bg.rev, *st), meta.n, k,
                counters)


def test_fused_in_place_kernel_scratch_reuse(cuda):
    """Eight launches on one scratch, the drivers' way, equal eight on
    fresh scratch and leave the scratch's accumulators (the queue's first
    ``N_ACC`` words) at 0."""
    bg, meta, (pre, _) = _fused_batch(cuda)
    args = (bg.s, bg.t, bg.indptr, bg.heads, bg.rev)
    shared = tdis.discharge_scratch(bg.batch, meta.n, 4, cuda)
    a = [x.clone() for x in pre]
    b = [x.clone() for x in pre]
    for _ in range(8):
        got = tdis.fused_discharge_batched_(*args, *a, n=meta.n, k=4,
                                            gate=None, scratch=shared,
                                            counters=True)
        want = tdis.fused_discharge_batched_(*args, *b, n=meta.n, k=4,
                                             gate=None, counters=True)
        _same((*a, *got[:2], *got[2]), (*b, *want[:2], *want[2]))
    torch.cuda.synchronize()
    assert not bool(shared.queue[:, :tdis.N_ACC].any())


def _most_resident_blocks(dev) -> int:
    """Blocks of 256 threads the card can hold resident at once: at least
    as many as the fused kernel's grid holds in any of its builds."""
    props = torch.cuda.get_device_properties(dev)
    return (getattr(props, "max_threads_per_multi_processor", 2048) // 256
            * props.multi_processor_count)


def test_fused_discharge_kernel_more_rows_than_resident_blocks(cuda):
    """A batch with more rows than resident blocks runs its rows in rounds
    of one cooperative launch, equal to the plain version (run on the CPU
    for speed)."""
    bg, meta, (_, st) = _fused_batch(cuda)
    reps = _most_resident_blocks(cuda) // 3 + 1
    many = tuple(x.repeat(reps, *([1] * (x.ndim - 1))) for x in
                 (bg.s, bg.t, bg.indptr, bg.heads, bg.rev, *st))
    got = tdis.fused_discharge_batched(*many, n=meta.n, k=3, counters=True)
    want = tdis.fused_discharge_batched_plain(*(x.cpu() for x in many),
                                              n=meta.n, k=3, counters=True)
    torch.cuda.synchronize()
    for g, w in zip((*got[:5], *got[5]), (*want[:5], *want[5])):
        assert torch.equal(g.cpu(), w)
    _in_place_matches_plain(many, meta.n, 3, True, want)


def test_fused_solve_many_more_rows_than_resident_blocks(cuda):
    """``solve_many`` in ``vc_fused`` on a batch larger than the card's
    resident blocks: every value equals the batched ``vc`` solve's and
    the host's Dinic."""
    probs = [MaxflowProblem(*washington_rlg(3, 3, seed=s))
             for s in range(_most_resident_blocks(cuda) + 8)]
    fused = Solver(backend="batched", mode="vc_fused").solve_many(probs)
    plain = Solver(backend="batched", mode="vc").solve_many(probs)
    want = [dinic_maxflow(p.graph, p.s, p.t) for p in probs]
    assert [x.value for x in fused] == [x.value for x in plain] == want


@pytest.mark.parametrize("backend", ["single", "batched"])
def test_fused_solve_matches_cpu(cuda, backend):
    """``vc_fused`` on the card, with telemetry, == on the CPU the plain
    ``vc`` solve (single: a cadence of 64 is a multiple of K = 8) or the
    batched ``vc_fused`` solve through the kernel's plain version
    (batched: its pushed-flag early exit looks at whole launches, so it
    may run up to K-1 cycles more than one-cycle modes)."""
    probs = [MaxflowProblem(*washington_rlg(16, 16, seed=s)) for s in (3, 4)]

    def run(mode, device):
        solver = Solver(mode=mode, backend=backend, device=device,
                        global_relabel_cadence=64, telemetry=True)
        if backend == "batched":
            return solver.solve_many(probs)
        return [solver.solve(p) for p in probs]

    on_card = run("vc_fused", "cuda")
    on_cpu = run("vc" if backend == "single" else "vc_fused", "cpu")
    for a, b in zip(on_card, on_cpu):
        assert a.value == b.value
        for f in ("cycles", "rounds", "global_relabels", "gr_sweeps",
                  "pushes", "relabels"):
            assert getattr(a.stats, f) == getattr(b.stats, f), f
        for f in ("res", "h", "e"):
            assert torch.equal(getattr(a.state, f).cpu(),
                               getattr(b.state, f)), f


def _stranded_preflow(rows=40, cols=40, seed=7):
    """A ``vc_kernel_bsearch`` solve on the card of a washington graph
    whose final preflow strands excess: ``(residual, s, t, solution)``."""
    p = MaxflowProblem(*washington_rlg(rows, cols, seed=seed))
    sol = Solver(mode="vc_kernel_bsearch").solve(p)
    e = sol.state.e.clone()
    e[[p.s, p.t]] = 0
    assert int(e.sum()) > 0, "no stranded excess: phase 2 would be idle"
    return p.residual("bcsr"), p.s, p.t, sol


def test_kernel_phase2_matches_plain(cuda):
    """Phase 2 on the min-search kernel (dense sweeps, AVQ cancellation
    selection) == the plain phase 2 on the card and on the CPU, bit for
    bit; it launches both gather forms and nothing else of the kernels."""
    r, s, t, sol = _stranded_preflow()
    before = (tile_min_neighbor_gather.launches,
              tile_min_neighbor_gather.dense_launches,
              tile_min_neighbor.launches, tile_min_neighbor_gather_rev.launches,
              bcsr_rev_search.launches)
    kern = tpr.convert_preflow_to_flow(r, sol.state, s, t, use_kernel=True)
    after = (tile_min_neighbor_gather.launches,
             tile_min_neighbor_gather.dense_launches,
             tile_min_neighbor.launches,
             tile_min_neighbor_gather_rev.launches, bcsr_rev_search.launches)
    assert after[1] > before[1] and after[0] - after[1] > before[0] - before[1]
    assert after[2:] == before[2:]
    plain = tpr.convert_preflow_to_flow(r, sol.state, s, t)
    cpu = tpr.convert_preflow_to_flow(r, sol.state, s, t, device="cpu")
    np.testing.assert_array_equal(kern, plain)
    np.testing.assert_array_equal(kern, cpu)
    host = sol.warm_start
    assert host.device.type == "cuda" and not host.corrected
    np.testing.assert_array_equal(host.arrays()[0], kern)
    host.validate()


@pytest.mark.parametrize("scan", [False, True])
def test_batched_kernel_phase2_matches_plain(cuda, scan):
    """The batched phase 2 with the kernel hook (each sweep and selection
    one launch spanning the batch) == without, on the card, and == the
    CPU's, rows of different sizes."""
    insts = []
    for i, (rows, cols) in enumerate(((20, 20), (13, 27), (24, 16))):
        g, s, t = washington_rlg(rows, cols, seed=30 + i)
        insts.append((build_residual(g, "bcsr"), s, t))
    bg, meta, res0, triv = tb.pack_instances(insts)
    out = tb.batched_resolve(bg, meta, tb.batched_preflow(bg, meta, res0),
                             trivial=triv, mode="vc_kernel_bsearch")
    hook = kops.min_neighbor_minh_fn()
    got, left = tb.batched_phase2(bg, meta, res0, out.state, scan=scan,
                                  minh_fn=hook)
    want, wleft = tb.batched_phase2(bg, meta, res0, out.state, scan=scan)
    tb.check_phase2_leftover(left)
    cbg, cmeta, cres0, _ = tb.pack_instances(insts, device="cpu")
    cpu, _ = tb.batched_phase2(cbg, cmeta, cres0, tb.BatchedPRState(
        *(x.cpu() for x in out.state)), scan=scan)
    assert torch.equal(left, wleft)
    for f in ("res", "e"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert torch.equal(getattr(got, f).cpu(), getattr(cpu, f)), f


def _bfs_source_side(r, res, s):
    """The reference's min-cut BFS, in numpy: the vertices reachable from
    ``s`` over arcs with residual, level by level."""
    reach = np.zeros(r.n, bool)
    reach[s] = True
    while True:
        out = (res > 0) & reach[r.tails] & ~reach[r.heads]
        nxt = np.unique(r.heads[out])
        if nxt.size == 0:
            return reach
        reach[nxt] = True


def test_device_min_cut_matches_numpy_bfs(cuda):
    """``Solution.min_cut()`` of a card solve (its reach sweeps on the
    kernel's dense form) == a numpy BFS over the corrected flow: the
    source side, the crossing arcs, their capacity == the max flow ==
    Dinic; every cut arc saturated."""
    r, s, t, sol = _stranded_preflow()
    cut = sol.min_cut()
    res, _ = sol.warm_start.arrays()
    reach = _bfs_source_side(r, res.astype(np.int64), s)
    np.testing.assert_array_equal(cut.source_side, reach)
    crossing = np.nonzero(reach[r.tails] & ~reach[r.heads])[0]
    np.testing.assert_array_equal(cut.cut_arcs, crossing)
    assert (res[crossing] == 0).all()
    g = sol.problem.graph
    assert cut.value == sol.value == dinic_maxflow(g, s, t)
    assert cut.source_side[s] and not cut.source_side[t]


@pytest.mark.parametrize("backend", ["single", "batched"])
def test_tc_on_the_card_matches_vc(cuda, backend):
    """``tc`` on the card (plain PyTorch ops, no kernel) == ``vc`` on the
    card: value, counts and final (single) or corrected (batched)
    states."""
    probs = [MaxflowProblem(*washington_rlg(24, 24, seed=3))]
    if backend == "batched":
        probs.append(MaxflowProblem(*washington_rlg(17, 29, seed=4)))

    def run(mode):
        solver = Solver(mode=mode, backend=backend)
        if backend == "batched":
            return solver.solve_many(probs)
        return [solver.solve(p) for p in probs]

    before = (tile_min_neighbor_gather.launches,
              tile_min_neighbor_gather_rev.launches)
    tc = run("tc")
    assert (tile_min_neighbor_gather.launches,
            tile_min_neighbor_gather_rev.launches) == before
    for a, b in zip(tc, run("vc")):
        assert a.value == b.value
        for f in ("cycles", "rounds", "global_relabels", "gr_sweeps"):
            assert getattr(a.stats, f) == getattr(b.stats, f), f
        for f in ("res", "h", "e"):
            assert a.state.res.device.type == "cuda"
            assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


def _drain_items(seeds):
    """Corrected flows of card solves of washington graphs, each with
    decreases that take two flow-carrying source arcs below their flow
    and an increase: ``[(residual, res, e, s, t, ups), ...]``."""
    items = []
    for i, seed in enumerate(seeds):
        p = MaxflowProblem(*washington_rlg(12 + 5 * i, 20, seed=seed))
        sol = Solver(mode="vc_kernel_bsearch").solve(p)
        res, e = sol.warm_start.arrays()
        r = p.residual("bcsr")
        flow = r.res0 - res
        out = np.arange(r.indptr[p.s], r.indptr[p.s + 1])
        hot = out[flow[out] > 0][:2]
        ups = [(p.s, int(r.heads[a]), -int(r.res0[a])) for a in hot]
        ups.append((int(r.tails[-1]), int(r.heads[-1]), 3))
        items.append((r, res, e, p.s, p.t, ups))
    return items


def _same_drain(a, b):
    for f in ("value", "budget", "overflow", "rerouted", "ok"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.res, b.res)
    np.testing.assert_array_equal(a.e, b.e)


def test_drain_kernel_matches_plain(cuda):
    """The streaming drain on the min-search kernel (dense sweeps toward
    the sink set, AVQ deficit and excess cancellations) == the plain
    drain on the card == the drain on the CPU, bit for bit; only the
    kernel run launches the gather entry, in both forms."""
    from repro_torch.streaming import reroute

    for item in _drain_items((3, 4)):
        before = (tile_min_neighbor_gather.launches,
                  tile_min_neighbor_gather.dense_launches)
        kern = reroute.apply_signed(*item, use_kernel=True)
        mid = (tile_min_neighbor_gather.launches,
               tile_min_neighbor_gather.dense_launches)
        plain = reroute.apply_signed(*item)
        assert (tile_min_neighbor_gather.launches,
                tile_min_neighbor_gather.dense_launches) == mid
        assert mid[1] > before[1] and mid[0] - mid[1] > before[0] - before[1]
        assert kern.rerouted and kern.ok
        _same_drain(kern, plain)
        _same_drain(kern, reroute.apply_signed(*item, device="cpu"))


def test_pooled_drain_kernel_matches_plain(cuda):
    """The pooled drain of rows of different sizes, on the kernel (each
    sweep step and each selection one launch spanning the pool) == the
    plain pooled drain == each row's own drain on the card, bit for
    bit."""
    from repro_torch.obs import REGISTRY
    from repro_torch.streaming import reroute

    items = _drain_items((5, 6, 7))
    disp = REGISTRY.counter("stream.reroute.batched_dispatches")
    before = disp.value
    kern = reroute.apply_signed_batched(items, use_kernel=True)
    assert disp.value == before + 1
    plain = reroute.apply_signed_batched(items)
    for k, p, item in zip(kern, plain, items):
        assert k.rerouted
        _same_drain(k, p)
        _same_drain(k, reroute.apply_signed(*item, use_kernel=True))


def test_stream_on_the_card_matches_cpu(cuda):
    """A stream opened on the card in ``vc_kernel_bsearch`` (drains and
    phase 2 on the kernel) == the same stream on the CPU in ``vc``: the
    value and the corrected arrays at every version, a structural insert
    included."""
    from repro_torch.graphs.generators import apply_events_to_graph
    from repro_torch.graphs.generators import update_trace

    g, s, t = washington_rlg(16, 16, seed=7)
    batches = update_trace(g, s, t, n_batches=3, batch_size=4,
                           adversarial=True, seed=7)
    batches += update_trace(g, s, t, n_batches=1, batch_size=4,
                            p_insert=0.5, p_delete=0.0, seed=7)
    card = Solver(mode="vc_kernel_bsearch").open_stream(
        MaxflowProblem(g, s, t))
    cpu = Solver(device="cpu").open_stream(MaxflowProblem(g, s, t))
    for batch in batches:
        got, want = card.query(card.apply(batch)), cpu.query(cpu.apply(batch))
        assert got.value == want.value
        assert got.state.res.device.type == "cuda"
        for a, b in zip(got.warm_start.arrays(), want.warm_start.arrays()):
            np.testing.assert_array_equal(a, b)
        assert got.min_cut().value == got.value
    assert card.stats()["structural_rebuilds"] == 1
    assert got.value == Solver(mode="vc_kernel_bsearch").solve(
        MaxflowProblem(apply_events_to_graph(g, batches), s, t)).value


def _served(device, mode):
    """``synthesize(24, seed=0)`` through a service on ``device``: every
    request's result (or error type), and the service."""
    from repro_torch.serving import MaxflowService, ServiceConfig
    from repro_torch.serving.workload import drive, synthesize

    svc = MaxflowService(ServiceConfig(mode=mode, max_batch=4,
                                       cycle_chunk=16, device=device))
    recs = drive(svc, synthesize(24, seed=0, matching_frac=0.3,
                                 repeat_frac=0.15, resubmit_frac=0.2))
    return svc, [(type(r["error"]).__name__, r["result"] and (
        r["result"].graph_id, r["result"].maxflow, r["result"].cycles,
        r["result"].rounds, r["result"].warm, r["result"].cached,
        r["result"].batch_size, r["result"].version)) for r in recs]


def test_fused_service_on_the_card_matches_cpu(cuda):
    """A ``vc_fused`` service on the card (the fused kernel, the gather
    entry in its relabels and pooled corrections) serves the workload
    request for request as on the CPU, and the values of ``vc`` there;
    every cached handle corrects to the CPU's arrays."""
    card, got = _served(None, "vc_fused")
    cpu, want = _served("cpu", "vc_fused")
    _, plain = _served("cpu", "vc")
    assert card.device.type == "cuda"
    assert got == want
    assert [(e, r and (*r[:2], *r[4:])) for e, r in got] \
        == [(e, r and (*r[:2], *r[4:])) for e, r in plain]
    assert list(card.results._entries) == list(cpu.results._entries)
    for k in cpu.results._entries:
        for x, y in zip(card.results.peek(k).handle.arrays(),
                        cpu.results.peek(k).handle.arrays()):
            np.testing.assert_array_equal(x, y)
    rb = card.stats()["robustness"]
    assert not any(v for k, v in rb.items()
                   if k not in ("ladders", "faults_injected"))


def test_pooled_correction_kernel_matches_plain(cuda):
    """The service's pooled phase 2 on the gather entry (one launch a step
    for the whole group) against the plain scan selector, both on the
    card: bit-equal corrected arrays, valid handles."""
    from repro_torch.kernels.segmin import tile_min_neighbor_gather
    from repro_torch.serving import MaxflowService, ServiceConfig

    insts = [washington_rlg(24, 24, seed=i) for i in range(6)]
    got = {}
    for kernel in (True, False):
        svc = MaxflowService(ServiceConfig(mode="vc", max_batch=4,
                                           phase2_kernel=kernel))
        futs = [svc.submit(*x) for x in insts]
        svc.flush()
        tile_min_neighbor_gather.launches = 0
        tile_min_neighbor_gather.dense_launches = 0
        got[kernel] = [svc.results.peek(f.result().graph_id).handle.arrays()
                       for f in futs]
        dense = tile_min_neighbor_gather.dense_launches
        avq = tile_min_neighbor_gather.launches - dense
        assert (dense > 0 and avq > 0) == kernel
        for f in futs:
            svc.results.peek(f.result().graph_id).handle.validate()
    for a, b in zip(got[True], got[False]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_only_typed_faults_take_the_ladder_on_the_card(cuda, monkeypatch):
    """On the card a dispatch error that is not an injected fault (a
    kernel that fails to build or launch) propagates: the flush's
    requests fail with ``DispatchFailed`` and no plain mode or host solve
    serves them.  An ``InjectedFault`` still walks the ladder."""
    from repro_torch.errors import DispatchFailed
    from repro_torch.runtime.fault import FaultPlan
    from repro_torch.serving import MaxflowService, ServiceConfig
    from repro_torch.serving import maxflow_service

    insts = [washington_rlg(12, 12, seed=i) for i in range(4)]
    solve = maxflow_service.batched.batched_resolve

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(maxflow_service.batched, "batched_resolve", broken)
    svc = MaxflowService(ServiceConfig(mode="vc_fused", max_batch=4))
    futs = [svc.submit(*x) for x in insts]
    with pytest.raises(RuntimeError, match="illegal memory access"):
        svc.flush()
    for f in futs:
        with pytest.raises(DispatchFailed):
            f.result()
    rb = svc.stats()["robustness"]
    assert rb["dispatch_failed"] == 4
    assert rb["retries"] == rb["transient_demotions"] == 0
    assert rb["host_fallbacks"] == 0
    monkeypatch.setattr(maxflow_service.batched, "batched_resolve", solve)
    svc = MaxflowService(ServiceConfig(mode="vc_fused", max_batch=4,
                                       retry_base_s=0),
                         faults=FaultPlan(seed=0, fail_modes=("vc_fused",)))
    got = [svc.submit(*x) for x in insts]
    svc.flush()
    assert [f.result().maxflow for f in got] == [
        dinic_maxflow(*x) for x in insts]
    assert svc.stats()["robustness"]["transient_demotions"] >= 1


def test_distributed_nccl_matches_gloo(cuda, tmp_path):
    """A one-rank NCCL ``solve_distributed`` on the card ends in the same
    final ``res``/``h``/``e``, superstep count and value as the same solve
    under gloo on the CPU, in each exchange mode, and the value is
    Dinic's."""
    import torch.distributed as dist

    from repro_torch.core import distributed as D

    g, s, t = washington_rlg(24, 24, seed=3)
    r = build_residual(g, "bcsr")
    want = dinic_maxflow(g, s, t)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        gloo = dist.new_group(backend="gloo")
        for mode in D.MODES:
            got = D.distributed_solve_impl(r, s, t, mode=mode, cycles=16)
            ref = D.distributed_solve_impl(r, s, t, gloo, mode=mode,
                                           cycles=16, device="cpu")
            assert got.res.is_cuda and not ref.res.is_cuda
            assert got.value == ref.value == want
            assert (got.supersteps, got.gr_sweeps) == (ref.supersteps,
                                                      ref.gr_sweeps)
            for a, b in zip(got[1:4], ref[1:4]):
                assert a.dtype == b.dtype == torch.int32
                assert torch.equal(a.cpu(), b)
        with pytest.raises(ValueError, match="does not carry"):
            D.solve_distributed(r, s, t, gloo)  # gloo with the card
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def card_analysis():
    """One run of the contract analyzer on the card, shared by the tests
    below."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import pathlib

    from repro_torch.launch.analyze import run_analysis

    root = pathlib.Path(__file__).resolve().parents[1]
    return run_analysis(repo_root=root, device="cuda")


def test_analyzer_on_the_card_is_clean(card_analysis):
    """Every surface's census under sync-debug "error" breaks no rule, and
    the port's tree has no lint finding."""
    s = card_analysis["summary"]
    bad = {name: rec["violations"]
           for name, rec in card_analysis["surfaces"].items()
           if not rec["ok"]}
    assert not bad
    assert (s["surfaces_traced"], s["surfaces_clean"], s["rule_violations"],
            s["lint_findings"]) == (25, 25, 0, 0)


def test_census_launches_equal_the_counters(card_analysis):
    """On every surface, and every kernel surface launching something,
    the census's kernel launches equal the wrappers' ``.launches``
    deltas."""
    launched = 0
    for name, rec in card_analysis["surfaces"].items():
        counts = rec["launch_counts"]
        assert counts["census"] == counts["counters"], name
        if rec["tags"].get("kernel") == "True" or rec["tags"].get(
                "mode", "vc") not in ("vc", "tc"):
            assert counts["census"], f"{name} launched no kernel"
            launched += 1
    assert launched == 13


def test_lm_serve_on_the_card_matches_cpu(cuda):
    """The dense LM's prefill and a decode chain on the card against the
    same float32 weights and tokens on the CPU (max |diff| within 1e-4 of
    the logits' rms), the decode loop under sync-debug "error" (no host
    read), and the launcher's card branch (events, peak bytes)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.training.train_step import (make_decode_step,
                                                 make_prefill_step)

    cfg = dataclasses.replace(registry.get_smoke_config("qwen2.5-14b"),
                              dtype=torch.float32, attn_chunk=8)
    params, toks, _ = serve.inputs(cfg, 2, 24, device=cuda)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        p = T.tree_map(lambda a: a.to(dev), params)
        t = toks.to(dev)
        last, cache = make_prefill_step(cfg, max_len=32)(p, t[:, :16])
        logits = [last]
        decode = make_decode_step(cfg)
        with serve.no_host_sync(dev):
            for i in range(16, 24):
                _, lg, cache = decode(p, cache, t[:, i:i + 1])
                logits.append(lg)
        outs[dev.type] = torch.stack(logits, 1).cpu()
    rms = outs["cpu"].pow(2).mean().sqrt()
    assert (outs["cuda"] - outs["cpu"]).abs().max() <= 1e-4 * rms
    rec = serve.main(["--arch", "qwen3-4b", "--smoke", "--census"])
    assert rec["device"] == "cuda" and rec["peak_allocated_bytes"] > 0
    assert rec["decode_step_host_reads"] == 0
    assert len(rec["decode_step_ms"]) == 15


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "mixtral-8x7b", "grok-1-314b",
                                  "jamba-1.5-large-398b", "whisper-tiny",
                                  "llama-3.2-vision-90b"])
def test_family_smoke_serve_on_the_card_matches_cpu(cuda, arch):
    """Each family the other mixers unlock, at its SMOKE size in float32
    (at unit gain: ``lm_serve_checks.unit_gain``): the prefill and a
    decode chain on the card against the same weights,
    tokens and external embeddings on the CPU (max |diff| within 1e-4 of
    the logits' rms; an MoE arch at a capacity that drops nothing), the
    decode loop under sync-debug "error"; then the launcher serving the
    SMOKE config on the card with no host read in a decode step."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch import lm_serve_checks, serve
    from repro_torch.models import transformer as T
    from repro_torch.training.train_step import (make_decode_step,
                                                 make_prefill_step)

    cfg = lm_serve_checks.nodrop(dataclasses.replace(
        registry.get_smoke_config(arch), dtype=torch.float32))
    params, toks, ext = serve.inputs(cfg, 2, 40, device=cuda)
    lm_serve_checks.unit_gain(cfg, params)  # as the card checks draw it
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        p = T.tree_map(lambda a: a.to(dev), params)
        t = toks.to(dev)
        e = None if ext is None else ext.to(dev)
        last, cache = make_prefill_step(cfg, max_len=40)(p, t[:, :32], e)
        logits = [last]
        decode = make_decode_step(cfg)
        with serve.no_host_sync(dev):
            for i in range(32, 40):
                _, lg, cache = decode(p, cache, t[:, i:i + 1])
                logits.append(lg)
        outs[dev.type] = torch.stack(logits, 1).cpu()
    rms = outs["cpu"].pow(2).mean().sqrt()
    assert (outs["cuda"] - outs["cpu"]).abs().max() <= 1e-4 * rms
    rec = serve.main(["--arch", arch, "--smoke", "--census", "--tokens", "8"])
    assert rec["device"] == "cuda" and rec["decode_step_host_reads"] == 0
    assert len(rec["decode_step_ms"]) == 7


def test_smoke_train_step_on_the_card_reads_nothing_back(cuda):
    """A qwen3-4b SMOKE train step (AdamW) on the card under sync-debug
    "error" with no host read under the census, its metrics finite and its
    loss falling over steps on one batch; and the same step in float32 on
    the card against the CPU (loss within 1e-5, each gradient leaf within
    1e-4 of its rms, TF32 off)."""
    import dataclasses

    from repro_torch.analysis import ir
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as S

    cfg = registry.get_smoke_config("qwen3-4b")
    params = T.init_params(cfg, 0, device=cuda)
    opt = O.make_optimizer("adamw", lr=3e-3)
    state = opt.init(params)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in TokenPipeline(
        cfg.vocab, 4, 32, seed=0).next().items()}
    step = S.make_train_step(cfg, opt)
    # the first step on a device copies the rope frequencies there once
    params, state, m = step(params, state, batch)
    losses = [m["loss"]]
    for _ in range(10):
        with serve.no_host_sync(cuda):
            params, state, m = step(params, state, batch)
        losses.append(m["loss"])
    c = ir.census(step, params, state, batch)
    assert c.host_reads == 0 and c.op_count > 0
    losses = [float(x) for x in losses]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.5
    assert int(state["count"]) == 12 and state["count"].is_cuda
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = T.init_params(cfg32, 1, device=cuda)
    grad_fn = S.value_and_grad(S.make_loss_fn(cfg32))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        (lc, _), gc = grad_fn(p32, batch)
        (lh, _), gh = grad_fn(T.tree_map(lambda a: a.cpu(), p32),
                              {k: v.cpu() for k, v in batch.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert abs(float(lc) - float(lh)) <= 1e-5 * abs(float(lh))
    want = dict(T.tree_leaves(gh))
    for path, g in T.tree_leaves(gc):
        rms = want[path].pow(2).mean().sqrt()
        assert (g.cpu() - want[path]).abs().max() <= 1e-4 * rms, path


def test_bf16_checkpoint_from_the_card_is_bit_equal(cuda, tmp_path):
    """Params and AdamW state written from the card (bf16, float32, the
    int32 count) restore on the card and on the CPU with the same bits."""
    from repro_torch.checkpoint import checkpoint as C
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O

    cfg = registry.get_smoke_config("qwen3-4b")
    params = T.init_params(cfg, 3, device=cuda)
    state = O.make_optimizer("adamw").init(params)
    state["mu"]["embed"].normal_()
    tree = {"params": params, "opt_state": state}
    C.save(tmp_path, 1, tree, extra={"step": 1})
    want = {p: t.cpu() for p, t in T.tree_leaves(tree)}
    for dev in (cuda, torch.device("cpu")):
        got, extra = C.restore(tmp_path, device=dev)
        assert extra == {"step": 1}
        flat = dict(T.tree_leaves(got))
        assert flat.keys() == want.keys()
        for path, w in want.items():
            g = flat[path]
            assert g.device.type == dev.type and g.dtype == w.dtype, path
            if w.dtype == torch.bfloat16:
                g, w = g.view(torch.int16), w.view(torch.int16)
            assert torch.equal(g.cpu(), w), path
