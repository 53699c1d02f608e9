"""Workload-balanced push-relabel (WBPR) in PyTorch — the paper's core.
Port of the JAX package's ``repro.core.pushrelabel`` for one instance.

Implements the bulk-synchronous form of He–Hong's lock-free push-relabel
(paper Alg. 1) with the paper's **vertex-centric** approach, ``vc_step``
(paper Alg. 2): compact the active vertices into the AVQ (prefix-sum
compaction — the deterministic analogue of the paper's ``atomic_add``
append), gather all their residual arcs into a flat, contiguous
*frontier*, and find each vertex's minimum-height neighbour with a
segmented min reduction.  Work is O(sum deg(active)) — balanced.

Each synchronous iteration applies *one* push-or-relabel per active vertex.
Pushes on distinct arcs are owned by their tail vertices (no write conflict
on ``res``), excess updates are scatter-adds (the commutative analogue of
``atomicAdd``), so this is a legal schedule of the lock-free algorithm and
inherits its correctness proof [Hong 2008].  Integer adds commute, so the
result is bit-for-bit the JAX package's.

``tc_step`` is the paper's **thread-centric** baseline: every vertex
walks its own segment to ``deg_max`` (O(V * deg_max) per cycle, the
imbalance the paper's cost model identifies); its scan runs as chunks of
columns, which gives the reference's one-column-at-a-time loop bit for
bit.

The kernel modes run the min search on the CUDA min-search kernel
(``repro_torch.kernels.segmin``); in ``vc_kernel_bsearch`` the same launch
also finds each push's reverse arc by the BCSR binary search
(``segmin.tile_min_neighbor_gather_rev``); ``vc_fused`` runs K whole
cycles per launch of the fused discharge kernel
(``repro_torch.kernels.discharge``).
The plain ``vc`` mode below is the reference semantics.  Nothing inside
a cycle reads the device from the host: every shape is static and every
scatter that the reference drops lands in a sentinel slot that is sliced
off.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import globalrelabel
from repro_torch.core.csr import ResidualCSR
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ref import INF
from repro_torch.kernels.runtime import resolve_device
from repro_torch.obs import solvercounters as sc

_I32 = torch.int32

#: the most (vertex, column) lanes one chunk of the thread-centric scan
#: gathers at once; it bounds the scan's temporaries (a few int32/int64
#: tensors of this many elements) and fixes its chunk width per graph
TC_LANES = 1 << 24


class DeviceGraph(NamedTuple):
    """Device-resident residual-graph arrays (layout-agnostic flat arc form)."""

    indptr: torch.Tensor  # (n+1,) int32
    heads: torch.Tensor  # (A,) int32
    tails: torch.Tensor  # (A,) int32
    rev: torch.Tensor  # (A,) int32


@dataclasses.dataclass(frozen=True)
class GraphMeta:
    n: int
    num_arcs: int
    deg_max: int
    layout: str


def as_int32(x, what: str) -> np.ndarray:
    """Checked narrowing to the int32 state dtype: raises
    ``OverflowError`` on values outside int32 instead of wrapping."""
    arr = np.asarray(x)
    if arr.size and (arr.min() < np.iinfo(np.int32).min
                     or arr.max() > np.iinfo(np.int32).max):
        raise OverflowError(f"{what} holds values outside int32")
    return arr.astype(np.int32)


#: the largest value of the int32 state lattice
INT32_MAX = int(np.iinfo(np.int32).max)


def check_arc_pairs(r: ResidualCSR) -> None:
    """Refuse a negative capacity (``ValueError``), or an arc pair whose
    forward plus backward capacity (``res0[a] + res0[rev[a]]``, which
    bounds every residual of the pair) exceeds ``2**31 - 1``
    (``OverflowError``).  Host int64 work; the half of
    :func:`check_capacity_range` that needs no source."""
    res0 = np.asarray(r.res0, np.int64)  # lint-ok: int64-state-cast (host)
    if not res0.size:
        return
    if res0.min() < 0:
        a = int(np.argmin(res0))
        raise ValueError(
            f"res0: negative capacity {int(res0[a])} on arc "
            f"{int(r.tails[a])}->{int(r.heads[a])}: capacities must be >= 0")
    # one arc past the bound already breaks its pair's; checked first so
    # that the pair sums below cannot overflow int64
    if res0.max() > INT32_MAX:
        a = int(np.argmax(res0))
    else:
        pair = res0 + res0[np.asarray(r.rev)]
        a = int(np.argmax(pair)) if pair.max() > INT32_MAX else -1
    if a >= 0:
        b = int(r.rev[a])
        raise OverflowError(
            f"res0: arc pair {int(r.tails[a])}<->{int(r.heads[a])} holds "
            f"capacity {int(res0[a]) + int(res0[b])} in its two directions, "
            f"above the int32 bound {INT32_MAX} on every residual")


def check_capacity_range(r: ResidualCSR, s: int) -> None:
    """Refuse, at admission, capacities the int32 state lattice cannot
    hold for the whole solve (the README's dtype contract).

    Works in int64 on the host, before anything is packed.  Raises what
    :func:`check_arc_pairs` raises, and ``OverflowError`` when the
    source's out-capacity (which bounds every excess and the value)
    exceeds ``2**31 - 1``.  The reference wraps such values silently; the
    port refuses them on every backend."""
    check_arc_pairs(r)
    res0 = np.asarray(r.res0, np.int64)  # lint-ok: int64-state-cast (host)
    out = int(res0[np.asarray(r.tails) == s].sum())
    if out > INT32_MAX:
        raise OverflowError(
            f"res0: the source {s} has out-capacity {out}, above the int32 "
            f"bound {INT32_MAX} on every excess and the max-flow value")


def to_device(r: ResidualCSR, device=None
              ) -> tuple[DeviceGraph, GraphMeta, torch.Tensor]:
    """The residual's arrays as int32 tensors on ``device`` (``None`` = the
    card), its static metadata, and the initial residual ``res0``."""
    dev = resolve_device(device)

    def put(x, what):
        return torch.from_numpy(as_int32(x, what)).to(dev)

    g = DeviceGraph(indptr=put(r.indptr, "indptr"), heads=put(r.heads, "heads"),
                    tails=put(r.tails, "tails"), rev=put(r.rev, "rev"))
    meta = GraphMeta(n=r.n, num_arcs=r.num_arcs, deg_max=r.deg_max,
                     layout=r.layout)
    return g, meta, put(r.res0, "res0")


class PRState(NamedTuple):
    res: torch.Tensor  # (A,) int32 residual capacities
    h: torch.Tensor  # (n,) int32 heights
    e: torch.Tensor  # (n,) int32 excess


def state_from_numpy(res, h, e, device=None) -> PRState:
    """A ``PRState`` on ``device`` from numpy arrays, e.g. those of the JAX
    package's ``PRState``: the carry-across function for solver state."""
    dev = resolve_device(device)
    return PRState(*(torch.from_numpy(as_int32(x, name)).to(dev)
                     for x, name in ((res, "residual"), (h, "heights"),
                                     (e, "excess"))))


def preflow(g: DeviceGraph, meta: GraphMeta, res0: torch.Tensor,
            s: int) -> PRState:
    """Paper Alg. 1 step 0: saturate every arc out of the source."""
    n = meta.n
    d = torch.where(g.tails == s, res0, 0)
    res = (res0 - d).index_add_(0, g.rev, d)
    e = torch.zeros(n, dtype=_I32, device=res0.device).index_add_(
        0, g.heads, d)
    h = torch.zeros(n, dtype=_I32, device=res0.device)
    return PRState(res=res, h=engine.fill_at(h, s, n),
                   e=engine.fill_at(e, s, 0))


def active_mask(state: PRState, n: int, s: int, t: int) -> torch.Tensor:
    act = (state.e > 0) & (state.h < n)
    return engine.fill_at(engine.fill_at(act, s, False), t, False)


# ---------------------------------------------------------------------------
# min-height neighbour search
# ---------------------------------------------------------------------------

def _flat_frontier_minh(g: DeviceGraph, meta: GraphMeta, state: PRState,
                        avq: torch.Tensor, q_valid: torch.Tensor):
    """Flat-frontier segmented min (workload-balanced: O(sum deg(active))):
    the plain version of the min-search kernel over the residual's keys."""
    key = torch.where(state.res > 0, state.h[g.heads], INF)
    return kref.min_neighbor_ref(avq, g.indptr, key, n=meta.n)


def tc_scan(starts: torch.Tensor, deg: torch.Tensor, heads: torch.Tensor,
            res: torch.Tensor, h: torch.Tensor, act: torch.Tensor,
            deg_max: int):
    """Thread-centric scan over segments ``starts[v]:starts[v] + deg[v]``
    (``deg[v] <= deg_max``): for every vertex the min of ``h[heads[a]]``
    over its arcs with ``res > 0`` (only where ``act``) and the first arc
    attaining it, ``(INF, A)`` where none exists.

    The reference walks the columns ``j < deg_max`` one at a time with a
    strict ``<``, so the earliest column attaining the min wins.  Here a
    chunk of ``C`` columns is one ``(V, C)`` gather, reduced to its min
    and its first column attaining it; chunks combine with the same
    strict ``<``, so an earlier chunk wins a tie: bit for bit the
    reference's loop.  ``C`` keeps ``V * C`` within ``TC_LANES``, and
    every chunk has the same static shape (columns past ``deg`` are
    masked like the reference's)."""
    nv, a = starts.shape[0], heads.shape[0]
    dev = starts.device
    minh = torch.full((nv,), INF, dtype=_I32, device=dev)
    argarc = torch.full((nv,), a, dtype=_I32, device=dev)
    if deg_max <= 0 or nv == 0:
        return minh, argarc
    width = max(1, min(deg_max, TC_LANES // nv))
    cols = torch.arange(width, dtype=_I32, device=dev)
    for j0 in range(0, deg_max, width):
        j = cols + j0
        arc = torch.clamp(starts[:, None] + j, 0, a - 1)
        ok = (j < deg[:, None]) & act[:, None] & (res[arc] > 0)
        key = torch.where(ok, h[heads[arc]], INF)
        cmin = key.amin(dim=1)
        # the first column attaining the chunk's min (some column does)
        first = torch.where(key == cmin[:, None], cols, width).amin(dim=1)
        carc = torch.gather(arc, 1, first.long()[:, None]).view(-1)
        better = cmin < minh
        minh = torch.where(better, cmin, minh)
        argarc = torch.where(better, carc, argarc)
    return minh, argarc


def _tc_scan_minh(g: DeviceGraph, meta: GraphMeta, state: PRState,
                  act: torch.Tensor):
    """Thread-centric scan: every vertex-lane walks its own segment to
    ``deg_max`` (masked) — the paper's imbalanced baseline."""
    return tc_scan(g.indptr[:-1], g.indptr[1:] - g.indptr[:-1], g.heads,
                   state.res, state.h, act, meta.deg_max)


# ---------------------------------------------------------------------------
# push / relabel decision + bulk-synchronous apply
# ---------------------------------------------------------------------------

def _push_decision(h: torch.Tensor, u_c: torch.Tensor, q_valid: torch.Tensor,
                   minh: torch.Tensor):
    """The push-or-relabel predicate pair: ``can`` = an admissible arc
    exists, ``do_push`` = it is height-decreasing."""
    can = q_valid & (minh < INF)
    do_push = can & (h[u_c] > minh)
    return can, do_push


def _decide_apply(g: DeviceGraph, meta: GraphMeta, state: PRState,
                  u: torch.Tensor, q_valid: torch.Tensor,
                  minh: torch.Tensor, argarc: torch.Tensor,
                  rev: torch.Tensor | None = None,
                  dead_end: int | None = None) -> PRState:
    """Push or relabel every queue entry against the min search's
    ``(minh, argarc)``.  ``rev`` (paper-faithful BCSR) is the reverse arc
    of each entry's push arc as the min search's rev entry found it, ``A``
    where the entry does not push or the arc was not found; ``None`` reads
    the ``rev`` table.  ``dead_end`` is the height a vertex without a
    residual arc is relabelled to, ``meta.n`` by default; the batched
    core applies a whole batch as one graph of ``B * n_pad`` vertices and
    keeps it at ``n_pad``."""
    n, A = meta.n, meta.num_arcs
    res, h, e = state
    u_c = torch.clamp(u, max=n - 1)
    arc_c = torch.clamp(argarc, 0, A - 1)
    can, do_push = _push_decision(h, u_c, q_valid, minh)
    d = torch.where(do_push, torch.minimum(e[u_c], res[arc_c]), 0)

    rev_arc = g.rev[arc_c] if rev is None else rev
    # the reference drops the scatters of lanes that do not push, and the
    # reverse scatter of a push whose reverse arc was not found (A); here
    # such a scatter adds a zero at its lane's slot, which leaves the same
    # result without every dropped lane's atomic add contending for one
    # sentinel address.  The AVQ has n lanes.
    lane = torch.arange(u.shape[0], dtype=_I32, device=u.device)
    idle = lane % A
    found = do_push & (rev_arc < A)
    res = res.index_add(
        0, torch.cat([torch.where(do_push, arc_c, idle),
                      torch.where(found, rev_arc, idle)]),
        torch.cat([-d, torch.where(found, d, 0)]))
    e = e.index_add(0, torch.cat([torch.where(do_push, u_c, lane),
                                  torch.where(do_push, g.heads[arc_c], lane)]),
                    torch.cat([-d, d]))

    do_relabel = q_valid & ~do_push
    # dead end -> deactivate
    newh = torch.where(can, minh + 1, n if dead_end is None else dead_end)
    # relabelled entries are distinct vertices; every other lane writes
    # the dropped slot n
    hbuf = torch.cat([h, h.new_zeros(1)])
    hbuf[torch.where(do_relabel, u_c, n)] = torch.where(do_relabel, newh, 0)
    return PRState(res=res, h=hbuf[:-1], e=e)


def vc_step(g: DeviceGraph, meta: GraphMeta, state: PRState, s: int, t: int,
            minh_fn: Callable | None = None) -> PRState:
    """One vertex-centric iteration (paper Alg. 2).  ``minh_fn`` returns
    ``(minh, argarc)``, or ``(minh, argarc, rev)`` where it also finds the
    pushes' reverse arcs (``kernels.ops.min_neighbor_rev_kernel``)."""
    n = meta.n
    act = active_mask(state, n, s, t)
    avq = torch.nonzero_static(act, size=n, fill_value=n).view(-1).to(_I32)
    q_valid = avq < n
    fn = _flat_frontier_minh if minh_fn is None else minh_fn
    return _decide_apply(g, meta, state, avq, q_valid,
                         *fn(g, meta, state, avq, q_valid))


def tc_step(g: DeviceGraph, meta: GraphMeta, state: PRState, s: int,
            t: int) -> PRState:
    """One thread-centric iteration (paper Alg. 1 inner loop): every
    vertex is its own lane, the inactive ones masked (the scan gives
    them ``(INF, A)``)."""
    act = active_mask(state, meta.n, s, t)
    minh, argarc = _tc_scan_minh(g, meta, state, act)
    u = torch.arange(meta.n, dtype=_I32, device=act.device)
    return _decide_apply(g, meta, state, u, act, minh, argarc)


#: modes whose hot loops run the CUDA kernels ('vc_fused' runs the whole
#: discharge in one kernel; the others route the min search, and in
#: 'vc_kernel_bsearch' the reverse lookup with it, through the min-search
#: kernel)
KERNEL_MODES = ("vc_kernel", "vc_kernel_bsearch", "vc_fused")

#: every step strategy of the JAX package, under the same names
ALL_MODES = ("vc", "tc") + KERNEL_MODES


def _make_step(mode: str) -> Callable:
    """Step factory: 'vc' (flat frontier, beyond-paper), 'tc' (the
    thread-centric baseline), 'vc_kernel' (faithful min-search kernel),
    'vc_kernel_bsearch' (faithful BCSR: the min search and the
    binary-search reverse lookup in one launch).  'vc_fused' is not a
    per-cycle step: ``run_cycles`` drives it as K cycles per launch
    (``repro_torch.kernels.discharge``)."""
    if mode == "vc":
        return vc_step
    if mode == "tc":
        return tc_step
    if mode == "vc_fused":
        raise ValueError("mode 'vc_fused' is not a per-cycle step; "
                         "run_cycles drives it K cycles per launch")
    if mode not in KERNEL_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    from repro_torch.kernels import ops as kops

    if mode == "vc_kernel":
        return functools.partial(vc_step, minh_fn=kops.min_neighbor_minh_fn())
    return functools.partial(vc_step, minh_fn=kops.min_neighbor_rev_kernel)


# ---------------------------------------------------------------------------
# solver driver
# ---------------------------------------------------------------------------

def cycles_per_step(mode: str, max_cycles: int) -> int:
    """Cycles one engine step runs: K (``K_DEFAULT``, clamped to the
    cycle budget) for the fused discharge, 1 for every other mode."""
    if mode != "vc_fused":
        return 1
    from repro_torch.kernels import discharge

    return max(1, min(discharge.K_DEFAULT, max_cycles))


def _advance_fn(g: DeviceGraph, meta: GraphMeta, s: int, t: int, mode: str,
                kk: int, telemetry: bool) -> Callable:
    """``advance(state) -> (state, live cycles, counts)``: one engine
    step of ``mode``.  ``counts`` (``telemetry`` only, else ``None``) are
    the step's per-cycle ``(active, pushes, frontier, maxdeg)`` as
    ``(kk,)`` int32 tensors.  ``vc_fused``'s is ``advance(state, gate)``:
    it updates ``state`` in place under the engine's 0-d ``gate`` and
    returns it."""
    if mode == "vc_fused":
        from repro_torch.kernels import discharge

        # loop-invariant launch inputs and scratch, built once
        dev = g.indptr.device
        s_b, t_b = (torch.full((1,), x, dtype=_I32, device=dev)
                    for x in (s, t))
        rows = (g.indptr[None], g.heads[None], g.rev[None])
        scratch = discharge.discharge_scratch(1, meta.n, kk, dev)

        def advance(state, gate):
            out = discharge.fused_discharge_batched_(
                s_b, t_b, *rows, *(x[None] for x in state), n=meta.n, k=kk,
                gate=gate, scratch=scratch, counters=telemetry)
            return (state, out[0][0],
                    tuple(c[0] for c in out[2]) if telemetry else None)

        return advance
    step = _make_step(mode)

    def advance(state):
        if not telemetry:
            return step(g, meta, state, s, t), 1, None
        nact, fr, md = sc.cycle_stats(g, meta, state, s, t)
        new = step(g, meta, state, s, t)
        pushes = nact - sc.count_relabels(state.h, new.h)
        return new, 1, (nact[None], pushes[None], fr[None], md[None])

    return advance


def cycle_loop(g: DeviceGraph, meta: GraphMeta, s: int, t: int,
               mode: str = "vc", cap: int = 256, telemetry: bool = False,
               max_cycles: int | None = None):
    """The ``(step_fn, cond_fn)`` of the cycle loop over ``(state, cycle)``
    carries (``(state, cycle, CycleTelemetry)`` with ``telemetry``): one
    engine step of ``mode`` — one cycle, or K for ``vc_fused`` — while a
    vertex is active and fewer than ``cap`` cycles ran.  ``max_cycles``
    (default ``cap``) sizes K and the telemetry histories, which hold
    ``max_cycles`` slots, plus K for ``vc_fused``.

    ``vc_fused``'s step is ``step_fn(carry, gate)`` (run it with the
    engine's ``pass_gate=True``): it updates the carry's state tensors in
    place under the gate, so its carry must own them."""
    max_cycles = cap if max_cycles is None else max_cycles
    kk = cycles_per_step(mode, max_cycles)
    advance = _advance_fn(g, meta, s, t, mode, kk, telemetry)
    # the last history write may start at any cycle below the budget; like
    # the reference's dynamic_update_slice, clamp it to the history
    last = max_cycles + (kk if mode == "vc_fused" else 0) - kk
    slots = torch.arange(kk, device=g.indptr.device)

    def cond(carry):
        state, cycle = carry[0], carry[1]
        return (cycle < cap) & torch.any(active_mask(state, meta.n, s, t))

    def body(carry, *gate):
        state, cycle = carry[0], carry[1]
        new, live, cnt = advance(state, *gate)
        if not telemetry:
            return new, cycle + live
        tel = carry[2]
        acts, pushs, frs, mds = cnt
        a_sum = acts.sum(dtype=_I32)
        p_sum = pushs.sum(dtype=_I32)
        at = torch.clamp(cycle, max=last).long() + slots
        tel = sc.CycleTelemetry(
            pushes=tel.pushes + p_sum, relabels=tel.relabels + a_sum - p_sum,
            active=tel.active + a_sum,
            frontier=tel.frontier + frs.sum(dtype=_I32),
            # out of place: the engine's gate keeps the old carry
            active_hist=tel.active_hist.index_copy(0, at, acts),
            frontier_hist=tel.frontier_hist.index_copy(0, at, frs),
            maxdeg_hist=tel.maxdeg_hist.index_copy(0, at, mds))
        return new, cycle + live, tel

    return body, cond


def run_cycles(g: DeviceGraph, meta: GraphMeta, state: PRState, s: int, t: int,
               mode: str = "vc", max_cycles: int = 256,
               telemetry: bool = False, budget: int | None = None,
               chunk: int | None = None):
    """Paper Alg. 1 step 1: up to ``max_cycles`` push-relabel iterations with
    the AVQ-empty early exit (paper §3.3), run through the sweep engine in
    chunks of ``chunk`` steps (default ``engine.DEFAULT_CHUNK``) with one
    host read per chunk.

    ``budget`` tightens the cycle cap below ``max_cycles``: the loop
    executes exactly ``min(max_cycles, budget)`` cycles unless it converges
    first.  Returns ``(state, cycles)``, ``cycles`` a 0-d int32 tensor.

    ``mode='vc_fused'`` runs each engine step as ONE launch of the fused
    discharge kernel executing up to ``K_DEFAULT`` whole cycles; the
    kernel's live-cycle count keeps ``cycles`` the unfused loop's (the
    budget may overshoot by at most K-1 when it is not a multiple of K).
    The kernel updates the loop's state in place, so the loop starts from
    a clone of ``state``: the caller's tensors stay as they are.

    ``telemetry=True`` carries the workload counters of
    ``repro_torch.obs.solvercounters`` in the loop and returns a third
    element, a ``CycleTelemetry`` of 0-d push/relabel/active/frontier
    totals and per-cycle active/frontier/maxdeg histories, all on the
    device.
    """
    cap = max_cycles if budget is None else min(max_cycles, int(budget))
    kk = cycles_per_step(mode, max_cycles)
    body, cond = cycle_loop(g, meta, s, t, mode, cap, telemetry=telemetry,
                            max_cycles=max_cycles)
    dev = state.res.device
    fused = mode == "vc_fused"
    if fused:
        state = PRState(*(x.clone() for x in state))
    carry = (state, torch.zeros((), dtype=_I32, device=dev))
    if telemetry:
        hist = max_cycles + (kk if fused else 0)
        carry += (sc.telemetry_init(hist=hist, device=dev),)
    steps_bound = -(-max_cycles // kk)  # K cycles per engine step
    return engine.run_bulk_loop(body, carry, cond_fn=cond,
                                chunk=engine.normalize_chunk(chunk,
                                                             steps_bound),
                                pass_gate=fused)


def _empty_hist() -> np.ndarray:
    return np.zeros(0, np.int64)


@dataclasses.dataclass
class SolveStats:
    maxflow: int
    rounds: int = 0
    cycles: int = 0
    global_relabels: int = 0
    gr_sweeps: int = 0  # Bellman-Ford sweep total across global relabels
    # device-counter workload totals (telemetry solves; 0 otherwise) —
    # int32 per call, accumulated here in Python ints
    pushes: int = 0
    relabels: int = 0
    # per-cycle device-counter series (telemetry solves only; empty
    # otherwise): active vertices, frontier arcs, max active degree —
    # one entry per push-relabel cycle, read once per round
    active_history: np.ndarray = dataclasses.field(
        default_factory=_empty_hist)
    frontier_history: np.ndarray = dataclasses.field(
        default_factory=_empty_hist)
    maxdeg_history: np.ndarray = dataclasses.field(
        default_factory=_empty_hist)
    state: PRState | None = None  # final solver state (residual/heights/excess)


def solve_impl(r: ResidualCSR, s: int, t: int, mode: str = "vc",
               cycle_chunk: int | None = None, max_rounds: int = 100000,
               instrument: bool = False, device=None,
               max_cycles: int | None = None,
               scan_chunk: int | None = None) -> SolveStats:
    """Full max-flow solve: preflow -> [cycles -> global relabel]* -> e(t).

    ``mode``: 'vc' (paper's WBPR on plain PyTorch ops), 'tc' (the
    thread-centric baseline) or one of the ``KERNEL_MODES`` — kernel
    modes also route the global relabel's Bellman-Ford sweeps through the
    min-search kernel.  ``device``:
    ``None`` is the card; ``"cpu"`` runs the kernels' plain versions.

    ``max_cycles`` (optional) is an exact total cycle budget: the remaining
    allowance caps every ``run_cycles`` call, so the solve executes exactly
    ``max_cycles`` cycles before raising ``BudgetExhausted`` (``vc_fused``
    may overshoot by < K, its launch granularity).
    ``scan_chunk`` sets the engine's steps per chunk.

    ``instrument=True`` enables the device-side telemetry counters
    (``repro_torch.obs.solvercounters``): the returned stats carry exact
    push/relabel totals and per-cycle active/frontier/maxdeg histories,
    computed inside the loop and read once per round.

    This is the single-instance engine behind the facade; call it through
    ``repro_torch.api.Solver``.
    """
    if mode not in ALL_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    g, meta, res0 = to_device(r, device)
    n = meta.n
    if s == t or meta.num_arcs == 0 or meta.deg_max == 0:
        zeros = torch.zeros(n, dtype=_I32, device=res0.device)
        idle = PRState(res=res0, h=zeros, e=zeros.clone())
        return SolveStats(maxflow=0, state=idle)
    gr_minh = engine.resolve_minh_fn(mode)
    chunk = cycle_chunk or max(32, min(1024, n))
    state = preflow(g, meta, res0, s)
    # start from exact distance labels (global relabel heuristic)
    state, _, sweeps = globalrelabel.global_relabel_impl(g, meta, state, s, t,
                                                         minh_fn=gr_minh)
    stats = SolveStats(maxflow=0, gr_sweeps=int(sweeps))
    hists: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    remaining = max_cycles  # None = unbounded; else exact total allowance
    for _ in range(max_rounds):
        out = run_cycles(g, meta, state, s, t, mode=mode, max_cycles=chunk,
                         telemetry=instrument, budget=remaining,
                         chunk=scan_chunk)
        state, cycles = out[0], out[1]
        c = int(cycles)
        if instrument:
            tel = out[2]
            stats.pushes += int(tel.pushes)
            stats.relabels += int(tel.relabels)
            hists.append(tuple(
                # telemetry histories (not state), read once a round
                h[:c].cpu().numpy().astype(np.int64)  # lint-ok: host-sync, int64-state-cast
                for h in (tel.active_hist, tel.frontier_hist,
                          tel.maxdeg_hist)))
        stats.cycles += c
        stats.rounds += 1
        if remaining is not None:
            remaining -= c
        state, nact, sweeps = globalrelabel.global_relabel_impl(
            g, meta, state, s, t, minh_fn=gr_minh)
        stats.global_relabels += 1
        stats.gr_sweeps += int(sweeps)
        if int(nact) == 0:
            break
        if remaining is not None and remaining <= 0:
            from repro_torch.errors import BudgetExhausted

            # the state at this point is a valid partial preflow (cycles
            # stopped mid-solve, global relabel just ran): callers can
            # degrade — bigger budget, host fallback — instead of failing
            raise BudgetExhausted(
                f"push-relabel did not converge within max_cycles="
                f"{max_cycles}", cycles_spent=stats.cycles,
                limit=max_cycles, partial=True)
    else:
        raise RuntimeError("push-relabel did not converge within max_rounds")
    if hists:
        stats.active_history, stats.frontier_history, stats.maxdeg_history \
            = (np.concatenate(col) for col in zip(*hists))
    stats.maxflow = int(state.e[t])
    stats.state = state
    return stats


def host_array(x) -> np.ndarray:
    """A numpy view of a state array, from a tensor on any device."""
    return (x.cpu().numpy()  # lint-ok: host-sync (host callers only)
            if isinstance(x, torch.Tensor) else np.asarray(x))


def convert_preflow_to_flow(r: ResidualCSR, state: PRState, s: int,
                            t: int, reference: bool = False,
                            use_kernel: bool = False,
                            device=None) -> np.ndarray:
    """Phase 2: the solver terminates with a maximum *preflow* (stranded
    excess at deactivated vertices).  Return that excess to the source by
    cancelling flow backwards, yielding a genuine max flow; returns the
    corrected ``res`` array (int64 numpy).  ``state``'s arrays may be
    numpy arrays or tensors on any device.

    The default runs the device phase 2 (``repro_torch.core.phase2``) on
    ``device`` (``None`` = the card).  ``use_kernel=True`` runs its
    segmented mins on the min-search kernel (identical results; the same
    ``minh_fn`` hook the kernel solve modes use).  ``reference=True``
    runs the host-side per-excess-vertex BFS: the test oracle.
    """
    if not reference:
        from repro_torch.core import phase2

        minh_fn = None
        if use_kernel:
            from repro_torch.kernels import ops as kops

            minh_fn = kops.min_neighbor_minh_fn()
        return phase2.convert_preflow_to_flow_device(r, state, s, t,
                                                     minh_fn=minh_fn,
                                                     device=device)
    return _convert_preflow_to_flow_host(r, state, s, t)


def _convert_preflow_to_flow_host(r: ResidualCSR, state: PRState, s: int,
                                  t: int) -> np.ndarray:
    """Host-side reference phase 2: one BFS toward ``s`` per excess vertex
    over arcs currently carrying flow inward, cancelling along the found
    path.  O(V*E) worst case — kept as the oracle for the device path."""
    res = host_array(state.res).astype(np.int64)
    res0 = np.asarray(r.res0)
    e = host_array(state.e).astype(np.int64)
    indptr, heads, rev = r.indptr, r.heads, r.rev
    for v0 in range(r.n):
        # drain each vertex with stranded excess
        while v0 not in (s, t) and e[v0] > 0:
            # BFS back toward s over arcs currently carrying flow inward;
            # any positive excess is flow-connected to the source, so the
            # search always reaches s (greedy walks can dead-end, BFS not)
            parent = {v0: None}  # w -> (closer-to-v0 vertex, arc w->it)
            frontier = [v0]
            while frontier and s not in parent:
                nxt = []
                for v in frontier:
                    for a in range(indptr[v], indptr[v + 1]):
                        ra, w = rev[a], heads[a]  # ra: w -> v
                        if res0[ra] - res[ra] > 0 and w not in parent:
                            parent[w] = (v, ra)
                            if w == s:
                                break
                            nxt.append(w)
                    if s in parent:
                        break
                frontier = nxt
            if s not in parent:  # not an assert: must survive python -O
                raise RuntimeError(
                    f"preflow decomposition from vertex {v0} did not reach "
                    "the source — the state is not a valid preflow for this "
                    "graph (excess must be flow-connected to s)")
            path, cur = [], s
            while cur != v0:  # unwind s -> v0, collecting flow arcs
                cur, arc = parent[cur]
                path.append(arc)
            d = min(int(e[v0]), min(int(res0[a] - res[a]) for a in path))
            for a in path:  # cancel d units of flow on every path arc
                res[a] += d
                res[rev[a]] -= d
            e[v0] -= d
    return res


def flows_from_state(r: ResidualCSR, state: PRState, s: int | None = None,
                     t: int | None = None, reference: bool = False,
                     device=None) -> np.ndarray:
    """Per-coalesced-edge net flow u->v.  With (s, t) given, stranded
    preflow excess is cancelled first (exact flow decomposition, on
    ``device`` as :func:`convert_preflow_to_flow` runs it)."""
    if s is not None:
        res = convert_preflow_to_flow(r, state, s, t, reference=reference,
                                      device=device)
    else:
        res = host_array(state.res)
    arc = np.asarray(r.pair_arc)
    return np.asarray(r.res0)[arc] - res[arc]
