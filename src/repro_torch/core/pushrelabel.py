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

The kernel modes run the min search on the CUDA warp-per-vertex kernel
(``repro_torch.kernels.segmin``) and, in ``vc_kernel_bsearch``, the
reverse-arc lookup on the BCSR binary-search kernel
(``repro_torch.kernels.revsearch``); the plain ``vc`` mode below is the
reference semantics.  Nothing inside a cycle reads the device from the
host: every shape is static and every scatter that the reference drops
lands in a sentinel slot that is sliced off.
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

_I32 = torch.int32

#: where each part of the JAX package that this slice leaves out is queued
_QUEUE = "see ROADMAP.md Queue 1"


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
                  rev_fn: Callable | None = None) -> PRState:
    n, A = meta.n, meta.num_arcs
    res, h, e = state
    u_c = torch.clamp(u, max=n - 1)
    arc_c = torch.clamp(argarc, 0, A - 1)
    can, do_push = _push_decision(h, u_c, q_valid, minh)
    d = torch.where(do_push, torch.minimum(e[u_c], res[arc_c]), 0)

    if rev_fn is None:
        rev_arc = g.rev[arc_c]
    else:  # paper-faithful BCSR: locate the reverse arc by binary search
        rev_arc = rev_fn(g, meta, torch.where(do_push, arc_c, A))
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
    newh = torch.where(can, minh + 1, n)  # dead end -> deactivate
    # relabelled entries are distinct vertices; every other lane writes
    # the dropped slot n
    hbuf = torch.cat([h, h.new_zeros(1)])
    hbuf[torch.where(do_relabel, u_c, n)] = torch.where(do_relabel, newh, 0)
    return PRState(res=res, h=hbuf[:-1], e=e)


def vc_step(g: DeviceGraph, meta: GraphMeta, state: PRState, s: int, t: int,
            minh_fn: Callable | None = None,
            rev_fn: Callable | None = None) -> PRState:
    """One vertex-centric iteration (paper Alg. 2)."""
    n = meta.n
    act = active_mask(state, n, s, t)
    avq = torch.nonzero_static(act, size=n, fill_value=n).view(-1).to(_I32)
    q_valid = avq < n
    if minh_fn is None:
        minh, argarc = _flat_frontier_minh(g, meta, state, avq, q_valid)
    else:
        minh, argarc = minh_fn(g, meta, state, avq, q_valid)
    return _decide_apply(g, meta, state, avq, q_valid, minh, argarc, rev_fn)


#: modes whose hot loops run the CUDA kernels ('vc_fused' runs the whole
#: discharge in one kernel and is not ported yet; the others route the min
#: search / reverse lookup through the two kernels of this package)
KERNEL_MODES = ("vc_kernel", "vc_kernel_bsearch", "vc_fused")

#: every step strategy of the JAX package, under the same names
ALL_MODES = ("vc", "tc") + KERNEL_MODES

#: the modes this package runs
PORTED_MODES = ("vc", "vc_kernel", "vc_kernel_bsearch")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({_QUEUE})")


def _make_step(mode: str) -> Callable:
    """Step factory: 'vc' (flat frontier, beyond-paper), 'vc_kernel'
    (faithful warp-per-vertex min search), 'vc_kernel_bsearch' (faithful
    BCSR: the min-search kernel + the binary-search reverse lookup)."""
    if mode == "vc":
        return vc_step
    if mode in ("tc", "vc_fused"):
        raise _not_ported(f"mode {mode!r}")
    if mode not in KERNEL_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    from repro_torch.kernels import ops as kops

    minh_fn = kops.min_neighbor_minh_fn()
    if mode == "vc_kernel":
        return functools.partial(vc_step, minh_fn=minh_fn)
    return functools.partial(vc_step, minh_fn=minh_fn,
                             rev_fn=kops.rev_lookup_bsearch)


# ---------------------------------------------------------------------------
# solver driver
# ---------------------------------------------------------------------------

def cycle_loop(g: DeviceGraph, meta: GraphMeta, s: int, t: int,
               mode: str = "vc", cap: int = 256):
    """The ``(step_fn, cond_fn)`` of the cycle loop over ``(state, cycle)``
    carries: one ``mode`` step per cycle while a vertex is active and
    fewer than ``cap`` cycles ran."""
    step = _make_step(mode)

    def cond(carry):
        state, cycle = carry
        return (cycle < cap) & torch.any(active_mask(state, meta.n, s, t))

    def body(carry):
        state, cycle = carry
        return step(g, meta, state, s, t), cycle + 1

    return body, cond


def run_cycles(g: DeviceGraph, meta: GraphMeta, state: PRState, s: int, t: int,
               mode: str = "vc", max_cycles: int = 256,
               telemetry: bool = False, budget: int | None = None,
               chunk: int | None = None):
    """Paper Alg. 1 step 1: up to ``max_cycles`` push-relabel iterations with
    the AVQ-empty early exit (paper §3.3), run through the sweep engine in
    chunks of ``chunk`` cycles (default ``engine.DEFAULT_CHUNK``) with one
    host read per chunk.

    ``budget`` tightens the cycle cap below ``max_cycles``: the loop
    executes exactly ``min(max_cycles, budget)`` cycles unless it converges
    first.  Returns ``(state, cycles)``, ``cycles`` a 0-d int32 tensor.
    """
    if telemetry:
        raise _not_ported("telemetry=True")
    cap = max_cycles if budget is None else min(max_cycles, int(budget))
    body, cond = cycle_loop(g, meta, s, t, mode, cap)
    cycles0 = torch.zeros((), dtype=_I32, device=state.res.device)
    return engine.run_bulk_loop(body, (state, cycles0), cond_fn=cond,
                                chunk=engine.normalize_chunk(chunk,
                                                             max_cycles))


@dataclasses.dataclass
class SolveStats:
    maxflow: int
    rounds: int = 0
    cycles: int = 0
    global_relabels: int = 0
    gr_sweeps: int = 0  # Bellman-Ford sweep total across global relabels
    state: PRState | None = None  # final solver state (residual/heights/excess)


def solve_impl(r: ResidualCSR, s: int, t: int, mode: str = "vc",
               cycle_chunk: int | None = None, max_rounds: int = 100000,
               instrument: bool = False, device=None,
               max_cycles: int | None = None,
               scan_chunk: int | None = None) -> SolveStats:
    """Full max-flow solve: preflow -> [cycles -> global relabel]* -> e(t).

    ``mode``: 'vc' (paper's WBPR on plain PyTorch ops) or one of the ported
    ``KERNEL_MODES`` — kernel modes also route the global relabel's
    Bellman-Ford sweeps through the min-search kernel.  ``device``: ``None``
    is the card; ``"cpu"`` runs the kernels' plain versions.

    ``max_cycles`` (optional) is an exact total cycle budget: the remaining
    allowance caps every ``run_cycles`` call, so the solve executes exactly
    ``max_cycles`` cycles before raising ``BudgetExhausted``.
    ``scan_chunk`` sets the engine's steps per chunk.

    This is the single-instance engine behind the facade; call it through
    ``repro_torch.api.Solver``.
    """
    if instrument:
        raise _not_ported("telemetry (instrument=True)")
    if mode not in PORTED_MODES:
        _make_step(mode)  # raises: not ported, or unknown
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
    remaining = max_cycles  # None = unbounded; else exact total allowance
    for _ in range(max_rounds):
        state, cycles = run_cycles(g, meta, state, s, t, mode=mode,
                                   max_cycles=chunk, budget=remaining,
                                   chunk=scan_chunk)
        c = int(cycles)
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
    stats.maxflow = int(state.e[t])
    stats.state = state
    return stats
