"""Batched multi-instance WBPR: advance B independent max-flow instances
per device step (port of the JAX package's ``repro.core.batched``).

Serving traffic is many small and medium instances, so here instances
are stacked into padded arrays — one leading batch axis over the same
``DeviceGraph`` / ``PRState`` layout.  The JAX package ``vmap``s its
per-instance functions over that axis; PyTorch's ``vmap`` covers neither
``nonzero_static`` nor ``index_add``, so the port writes each batched
step over flat indices instead: row ``b``'s vertex ``v`` is
``b * n_pad + v`` and its arc ``a`` is ``b * A_pad + a``, and a batch is
one graph of B disjoint parts.  Nothing loops over B.  The CUDA kernels
take the ``(B, ·)`` rows natively, so each cycle's min search (with its
reverse-arc search in ``vc_kernel_bsearch``, and each K-cycle fused
discharge) is ONE launch spanning the whole batch:

* ``pack_instances`` pads B ``ResidualCSR``s to a common ``(n_pad, A_pad)``
  and stacks them (padded vertices have empty arc segments; padded arcs
  have zero residual and ``rev = self``, so both are inert under
  push/relabel and the distance sweeps).
* ``batched_run_cycles`` runs the bulk-synchronous loop with
  **per-instance convergence flags**: converged instances are fixpoints
  of the step, so the loop exits when every instance's AVQ is empty and
  each instance's cycle counter stops advancing the moment it converges.
* ``batched_resolve`` accepts an arbitrary valid starting state: the
  shared tail of cold solves and of warm re-solves
  (``warm_start_arrays``/``pack_states``).
* ``batched_phase2`` converts every final preflow to a genuine flow in one
  pass over the whole batch (``phase2.batched_phase2_impl``).

Correctness note on padding: every height threshold in the per-instance
code is ``meta.n``, which here is ``n_pad``.  Push-relabel is indifferent
to the numeric value of the "unreachable" height as long as it exceeds
any true residual distance, and ``n_pad >= n`` does; the max-flow value
(``e[t]`` at convergence) is the graph's unique optimum either way, so
batched and sequential solves agree exactly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import globalrelabel as gr
from repro_torch.core import pushrelabel as pr
from repro_torch.core.csr import ResidualCSR
from repro_torch.kernels import ref as kref
from repro_torch.kernels.runtime import resolve_device
from repro_torch.obs import solvercounters as sc

#: THE device state dtype: residual occupancies, heights and excess are
#: int32 end to end (the paper's integer-capacity formulation).  Host-side
#: staging arrays may be wider, but every device entry point narrows
#: through ``as_state_dtype``, which RAISES on values that do not fit
#: instead of silently truncating.
STATE_DTYPE = np.int32

_I32 = torch.int32

def as_state_dtype(arr, what: str = "array") -> np.ndarray:
    """``np.asarray(arr, STATE_DTYPE)`` that refuses lossy casts: raises
    ``OverflowError`` on values outside int32 instead of wrapping them."""
    a = np.asarray(arr)
    if a.dtype == STATE_DTYPE:
        return a
    info = np.iinfo(STATE_DTYPE)
    if a.size and (a.min() < info.min or a.max() > info.max):
        raise OverflowError(
            f"{what} holds values outside the int32 state dtype "
            f"(min={a.min()}, max={a.max()}); capacities this large are "
            "not representable — rescale the instance (see "
            "SolverOptions.dtype)")
    return a.astype(STATE_DTYPE)


class BatchedDeviceGraph(NamedTuple):
    """B stacked ``DeviceGraph``s padded to a common shape, plus the
    per-instance true sizes and terminals."""

    indptr: torch.Tensor  # (B, n_pad+1) int32
    heads: torch.Tensor  # (B, A_pad) int32
    tails: torch.Tensor  # (B, A_pad) int32
    rev: torch.Tensor  # (B, A_pad) int32
    n: torch.Tensor  # (B,) int32 — true vertex count
    num_arcs: torch.Tensor  # (B,) int32 — true arc count
    s: torch.Tensor  # (B,) int32
    t: torch.Tensor  # (B,) int32

    @property
    def batch(self) -> int:
        return self.s.shape[0]


class BatchedPRState(NamedTuple):
    res: torch.Tensor  # (B, A_pad) int32
    h: torch.Tensor  # (B, n_pad) int32
    e: torch.Tensor  # (B, n_pad) int32


@dataclasses.dataclass
class BatchedSolveResult:
    maxflows: np.ndarray  # (B,) int64
    cycles: np.ndarray  # (B,) int64 — per-instance push-relabel iterations
    rounds: np.ndarray  # (B,) int64 — chunks the instance was live for
    global_relabels: int
    converged: np.ndarray  # (B,) bool
    state: BatchedPRState  # final padded device state
    trivial: np.ndarray  # (B,) bool — s==t / empty instances, forced to 0
    corrected: bool = False  # state is phase-2 corrected (a genuine flow)
    gr_time_s: float = 0.0  # wall seconds in pooled global-relabel sweeps
    gr_sweeps: int = 0  # Bellman-Ford sweep total across global relabels
    # per-instance (B,) int64 device-counter totals — telemetry solves
    # only, None otherwise (repro_torch.obs.solvercounters)
    pushes: np.ndarray | None = None
    relabels: np.ndarray | None = None
    active_sum: np.ndarray | None = None
    frontier_sum: np.ndarray | None = None


def round_up_pow2(x: int, lo: int = 1) -> int:
    x = max(int(x), lo)
    return 1 << (x - 1).bit_length()


def _pad_instance(r: ResidualCSR, n_pad: int, A_pad: int, trivial: bool):
    n, A = r.n, r.num_arcs
    if n > n_pad or A > A_pad:
        raise ValueError(
            f"instance exceeds bucket shape: (n={n}, arcs={A}) does not "
            f"fit (n_pad={n_pad}, A_pad={A_pad})")
    indptr = np.full(n_pad + 1, A, np.int32)
    indptr[: n + 1] = r.indptr
    # pad arcs: zero residual, endpoints at the last padded vertex (keeps
    # `tails` non-decreasing for the sorted segment reductions), rev = self
    heads = np.full(A_pad, n_pad - 1, np.int32)
    tails = np.full(A_pad, n_pad - 1, np.int32)
    rev = np.arange(A_pad, dtype=np.int32)
    res0 = np.zeros(A_pad, np.int32)
    heads[:A] = r.heads
    tails[:A] = r.tails
    rev[:A] = r.rev
    if not trivial:
        res0[:A] = pr.as_int32(r.res0, "res0")
    return indptr, heads, tails, rev, res0


def pack_instances(instances: list[tuple[ResidualCSR, int, int]],
                   n_pad: int | None = None, A_pad: int | None = None,
                   deg_max: int | None = None, device=None):
    """Stack instances ``(ResidualCSR, s, t)`` into one padded batch on
    ``device`` (``None`` = the card).

    Returns ``(bg, meta, res0, trivial)`` where ``meta`` is the *padded*
    ``GraphMeta`` shared by every instance, ``res0`` is ``(B, A_pad)``
    and ``trivial`` a ``(B,)`` numpy bool array.  Instances with
    ``s == t``, no arcs, or no edges are trivial and packed with zero
    capacities (they converge at once with flow 0).

    ``meta.layout`` records whether EVERY instance has head-sorted (bcsr)
    segments — ``"batched-bcsr"`` vs plain ``"batched"`` — which is what
    licenses the binary-search reverse lookup; ``batched_run_cycles``
    rejects ``mode='vc_kernel_bsearch'`` on an unsorted pack.

    Every instance's capacities are checked first
    (``pushrelabel.check_capacity_range``): one the int32 state cannot
    hold raises before anything is packed.
    """
    if not instances:
        raise ValueError("empty batch")
    dev = resolve_device(device)
    n_pad = n_pad or max(max(r.n for r, _, _ in instances), 2)
    A_pad = A_pad or max(max(r.num_arcs for r, _, _ in instances), 1)
    deg_max = deg_max or max(max(r.deg_max for r, _, _ in instances), 1)
    for r, s, _ in instances:
        pr.check_capacity_range(r, s)
    cols = [[] for _ in range(5)]
    ns, As, ss, ts, triv = [], [], [], [], []
    for r, s, t in instances:
        trivial = (s == t) or r.num_arcs == 0 or r.deg_max == 0
        parts = _pad_instance(r, n_pad, A_pad, trivial)
        for c, p in zip(cols, parts):
            c.append(p)
        ns.append(r.n)
        As.append(r.num_arcs)
        ss.append(min(s, n_pad - 1))
        ts.append(min(t, n_pad - 1))
        triv.append(trivial)

    def put(x):
        return torch.from_numpy(np.asarray(x, np.int32)).to(dev)

    indptr, heads, tails, rev, res0 = (put(np.stack(c)) for c in cols)
    bg = BatchedDeviceGraph(indptr=indptr, heads=heads, tails=tails, rev=rev,
                            n=put(ns), num_arcs=put(As), s=put(ss),
                            t=put(ts))
    sorted_ok = all(r.binary_search_ready() for r, _, _ in instances)
    meta = pr.GraphMeta(n=n_pad, num_arcs=A_pad, deg_max=deg_max,
                        layout="batched-bcsr" if sorted_ok else "batched")
    return bg, meta, res0, np.asarray(triv)


def pack_states(states: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
                n_pad: int, A_pad: int, device=None) -> BatchedPRState:
    """Stack per-instance ``(res, h, e)`` numpy arrays into a padded
    ``BatchedPRState`` on ``device``.  Inputs of any integer dtype are
    accepted but must FIT the int32 state dtype — a wider array with
    out-of-range values raises ``OverflowError`` (``as_state_dtype``)
    instead of wrapping silently."""
    dev = resolve_device(device)
    B = len(states)
    res = np.zeros((B, A_pad), STATE_DTYPE)
    h = np.zeros((B, n_pad), STATE_DTYPE)
    e = np.zeros((B, n_pad), STATE_DTYPE)
    for i, (ri, hi, ei) in enumerate(states):
        res[i, : ri.shape[0]] = as_state_dtype(ri, f"states[{i}].res")
        h[i, : hi.shape[0]] = as_state_dtype(hi, f"states[{i}].h")
        e[i, : ei.shape[0]] = as_state_dtype(ei, f"states[{i}].e")
    return BatchedPRState(*(torch.from_numpy(x).to(dev) for x in (res, h, e)))


# ---------------------------------------------------------------------------
# batched device stages
# ---------------------------------------------------------------------------

def _rows(bg: BatchedDeviceGraph) -> pr.DeviceGraph:
    return pr.DeviceGraph(bg.indptr, bg.heads, bg.tails, bg.rev)


def active_rows(h: torch.Tensor, e: torch.Tensor, n: int, s: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    """``pushrelabel.active_mask`` of every row: ``(B, n)`` bool, with the
    ``(B,)`` terminals ``s``/``t`` excluded."""
    v = torch.arange(n, device=h.device)
    return ((e > 0) & (h < n) & (v[None, :] != s[:, None])
            & (v[None, :] != t[:, None]))


def row_avq(act: torch.Tensor) -> torch.Tensor:
    """Each row's AVQ: ``(B, n)`` int32, the row's active vertices in
    order, padded with ``n`` (``nonzero_static`` row by row, as one
    scatter)."""
    bsz, n = act.shape
    pos = torch.cumsum(act, 1, dtype=_I32) - 1
    out = torch.full((bsz, n + 1), n, dtype=_I32, device=act.device)
    verts = torch.arange(n, dtype=_I32, device=act.device).expand(bsz, n)
    # inactive vertices land in the spare column n, sliced off
    out.scatter_(1, torch.where(act, pos, n).long(), verts)
    return out[:, :n].contiguous()


class _Flat(NamedTuple):
    """The batch as one graph of ``B * n_pad`` vertices and ``B * A_pad``
    arcs (loop-invariant, built once per call)."""

    g: pr.DeviceGraph  # flat heads (+ b * n_pad) and rev (+ b * A_pad)
    meta: pr.GraphMeta
    starts: torch.Tensor  # (B * n_pad,) flat segment starts
    ends: torch.Tensor  # (B * n_pad,) flat segment ends
    voff: torch.Tensor  # (B, 1) int32 row offsets of vertices
    aoff: torch.Tensor  # (B, 1) int32 row offsets of arcs


def _flat(bg: BatchedDeviceGraph | pr.DeviceGraph, meta) -> _Flat:
    """The flat view of stacked rows (a ``BatchedDeviceGraph`` or a
    ``DeviceGraph`` of ``(B, ·)`` rows)."""
    bsz, n, A = bg.heads.shape[0], meta.n, meta.num_arcs
    b = torch.arange(bsz, dtype=_I32, device=bg.indptr.device)[:, None]
    voff, aoff = b * n, b * A
    g = pr.DeviceGraph(indptr=None, heads=(bg.heads + voff).view(-1),
                       tails=None, rev=(bg.rev + aoff).view(-1))
    fmeta = pr.GraphMeta(n=bsz * n, num_arcs=bsz * A, deg_max=meta.deg_max,
                         layout=meta.layout)
    return _Flat(g=g, meta=fmeta,
                 starts=(bg.indptr[:, :-1] + aoff).view(-1),
                 ends=(bg.indptr[:, 1:] + aoff).view(-1), voff=voff,
                 aoff=aoff)


def batched_preflow(bg: BatchedDeviceGraph, meta, res0) -> BatchedPRState:
    """Paper Alg. 1 step 0 over the whole batch: saturate every arc out
    of each row's source."""
    n = meta.n
    flat = _flat(bg, meta)
    d = torch.where(bg.tails == bg.s[:, None], res0, 0)
    res = (res0 - d).view(-1).index_add_(0, flat.g.rev, d.view(-1))
    e = torch.zeros(bg.batch * n, dtype=_I32, device=res0.device).index_add_(
        0, flat.g.heads, d.view(-1))
    s_col = bg.s.long()[:, None]
    h = torch.zeros((bg.batch, n), dtype=_I32, device=res0.device)
    return BatchedPRState(res=res.view(res0.shape),
                          h=h.scatter_(1, s_col, n),
                          e=e.view(bg.batch, n).scatter_(1, s_col, 0))


def batched_global_relabel(bg: BatchedDeviceGraph, meta,
                           state: BatchedPRState, minh_fn=None):
    """Global relabel over the whole batch; returns ``(state, nact (B,),
    sweeps)``.  ``nact == 0`` is the per-instance convergence flag.

    The distance sweeps run at batch level
    (``globalrelabel.batched_global_relabel_impl``): ``minh_fn=None`` is
    one ``scatter_reduce`` over the batch, while a kernel ``minh_fn``
    (``kernels.ops.min_neighbor_minh_fn()``) runs each sweep step as ONE
    ``tile_min_neighbor`` launch spanning the batch.  Results are bit for
    bit identical; ``sweeps`` is shared by the batch (the loop runs to
    the slowest row's fixpoint)."""
    st, nact, sweeps = gr.batched_global_relabel_impl(
        _rows(bg), meta, pr.PRState(*state), bg.s, bg.t, minh_fn=minh_fn)
    return BatchedPRState(res=st.res, h=st.h, e=st.e), nact, sweeps


def _check_mode(mode: str) -> None:
    """Raise ``ValueError`` on an unknown mode."""
    if mode not in pr.ALL_MODES:
        raise ValueError(
            f"batched mode must be one of {pr.ALL_MODES}, got {mode!r}")


def _kernel_batch_step(bg: BatchedDeviceGraph, meta, state: BatchedPRState,
                       mode: str, flat: _Flat | None = None
                       ) -> BatchedPRState:
    """One bulk-synchronous cycle over the whole batch.  Each row's AVQ is
    compacted with one scatter; the min-height search is ONE launch of
    the min-search kernel spanning every row (kernel modes) or one plain
    flat-frontier search over the batch as one graph (``vc``); in
    ``vc_kernel_bsearch`` that launch also finds every push's reverse arc
    (the min search's rev entry); the decide/apply runs on the flat graph.
    ``tc`` scans every vertex of the flat graph instead of the AVQ (its
    dead end stays ``n``).  Results are bit for bit ``vc``'s on each
    row."""
    from repro_torch.kernels import ops as kops

    n, A = meta.n, meta.num_arcs
    flat = flat or _flat(bg, meta)
    N, AF = bg.batch * n, bg.batch * A
    act = active_rows(state.h, state.e, n, bg.s, bg.t)
    fstate = pr.PRState(*(x.view(-1) for x in state))
    if mode == "tc":
        q_valid = act.view(-1)
        minh, argarc = pr.tc_scan(flat.starts, flat.ends - flat.starts,
                                  flat.g.heads, fstate.res, fstate.h,
                                  q_valid, meta.deg_max)
        new = pr._decide_apply(
            flat.g, flat.meta, fstate,
            torch.arange(N, dtype=_I32, device=act.device), q_valid,
            minh, argarc, dead_end=n)
        return BatchedPRState(*(x.view(y.shape) for x, y in zip(new, state)))
    avq = row_avq(act)
    q_valid = avq < n
    u = torch.where(q_valid, avq + flat.voff, N).view(-1)
    rev = None
    if mode == "vc":
        key = torch.where(fstate.res > 0, fstate.h[flat.g.heads], kref.INF)
        minh, argarc = kref.min_neighbor_segments(u, flat.starts, flat.ends,
                                                  key, n=N)
    else:
        hook = (kops.min_neighbor_rev_kernel if mode == "vc_kernel_bsearch"
                else kops.min_neighbor_kernel)
        out = hook(_rows(bg), meta, pr.PRState(*state), avq, q_valid)
        minh = out[0].view(-1)

        def flat_arcs(x):  # row-local arcs (A = none) -> flat (AF = none)
            return torch.where(x < A, x + flat.aoff, AF).view(-1)

        argarc = flat_arcs(out[1])
        if mode == "vc_kernel_bsearch":
            rev = flat_arcs(out[2])
    new = pr._decide_apply(flat.g, flat.meta, fstate, u, q_valid.view(-1),
                           minh, argarc, rev=rev, dead_end=n)
    return BatchedPRState(*(x.view(y.shape) for x, y in zip(new, state)))


def batched_run_cycles(bg: BatchedDeviceGraph, meta, state: BatchedPRState,
                       mode: str = "vc", max_cycles: int = 256,
                       telemetry: bool = False, budget: int | None = None,
                       chunk: int | None = None):
    """Up to ``max_cycles`` bulk-synchronous iterations over the batch,
    run through the sweep engine in chunks of ``chunk`` steps with one
    host read per chunk.  ``budget`` tightens the cycle cap below
    ``max_cycles``; ``batched_resolve`` threads its remaining total-cycle
    allowance through it.

    A converged instance (empty AVQ) is a fixpoint of the step, so
    stepping it is the identity; ``cycles[b]`` counts only the iterations
    instance ``b`` was still live for.  The loop exits early when every
    instance has converged *or* when a step moves no excess at all (pure
    relabel climb): once pushes stop, active vertices only raise heights
    toward ``n`` — the caller's next global relabel settles that in one
    sweep instead of O(n) climb iterations.

    Modes: 'vc' (plain PyTorch), 'vc_kernel'/'vc_kernel_bsearch' (one
    min-search launch per cycle spanning the batch, which in bsearch also
    finds the reverse arcs), and 'vc_fused' — one fused
    discharge launch per K cycles, its per-instance live-cycle counts
    keeping ``cycles[b]`` exact; 'tc' scans every vertex of the batch
    (the paper's thread-centric baseline).

    ``telemetry=True`` folds per-instance ``(B,)`` int32
    push/relabel/active/frontier totals into the carry (the fused mode
    reads them off the kernel's counter outputs) and returns them as a
    third element — a ``CycleTelemetry`` with ``None`` histories.
    Returns ``(state, cycles (B,))`` tensors on the device.
    """
    step, cond, init = batched_cycle_loop(bg, meta, state, mode, max_cycles,
                                          telemetry=telemetry, budget=budget)
    steps_bound = -(-max_cycles // pr.cycles_per_step(mode, max_cycles))
    out = engine.run_bulk_loop(step, init, cond_fn=cond,
                               chunk=engine.normalize_chunk(chunk,
                                                            steps_bound),
                               pass_gate=mode == "vc_fused")
    if telemetry:
        return out[0], out[3], out[5]
    return out[0], out[3]


def batched_cycle_loop(bg: BatchedDeviceGraph, meta, state: BatchedPRState,
                       mode: str = "vc", max_cycles: int = 256,
                       telemetry: bool = False, budget: int | None = None):
    """The ``(step_fn, cond_fn, carry)`` of :func:`batched_run_cycles`'s
    loop over ``(state, nact, cycle, cycles (B,), pushed[, telemetry])``
    carries, for ``engine.run_bulk_loop`` / ``engine.run_chunk``.

    ``vc_fused``'s step is ``step_fn(carry, gate)`` (the engine's
    ``pass_gate=True``): its kernel updates the carry's state in place
    under the gate, so the carry starts from a clone of ``state``."""
    _check_mode(mode)
    if mode == "vc_kernel_bsearch" and meta.layout != "batched-bcsr":
        # guard at the shared depth: every entry path passes through here,
        # and a binary search on unsorted segments finds wrong arcs
        raise ValueError(
            "mode 'vc_kernel_bsearch' needs head-sorted (bcsr) segments "
            f"in every packed instance; this batch is {meta.layout!r}")
    n = meta.n
    dev = state.res.device
    cap = max_cycles if budget is None else min(max_cycles, int(budget))
    kk = pr.cycles_per_step(mode, max_cycles)
    flat = _flat(bg, meta)
    g_rows = _rows(bg)

    def nact_of(st):
        return active_rows(st.h, st.e, n, bg.s, bg.t).sum(dim=1, dtype=_I32)

    # step(state, nact) -> (new state, cycle budget spent, per-instance
    # live cycles, pushed flag or None, counter increments or None).
    # pushed=None means "infer from e-equality", sound only for one-cycle
    # steps: across a K-cycle launch a push/relabel ping-pong can restore
    # e, so the fused kernel reports its own any-push flag.  inc=None
    # means "derive the counters from the state diff".
    if mode == "vc_fused":
        from repro_torch.kernels import discharge

        state = BatchedPRState(*(x.clone() for x in state))
        scratch = discharge.discharge_scratch(bg.batch, n, kk, dev)

        def step(state, nact, gate):
            out = discharge.fused_discharge_batched_(
                bg.s, bg.t, bg.indptr, bg.heads, bg.rev, *state, n=n, k=kk,
                gate=gate, scratch=scratch, counters=telemetry)
            inc = None
            if telemetry:
                acts, pushs, frs, _ = out[2]
                a_tot = acts.sum(dim=1, dtype=_I32)
                p_tot = pushs.sum(dim=1, dtype=_I32)
                inc = (p_tot, a_tot - p_tot, a_tot,
                       frs.sum(dim=1, dtype=_I32))
            return state, kk, out[0], torch.any(out[1] > 0), inc
    else:
        def step(state, nact):
            new = _kernel_batch_step(bg, meta, state, mode, flat)
            return new, 1, (nact > 0).to(_I32), None, None

    def cond(carry):
        nact, cycle, pushed = carry[1], carry[2], carry[4]
        return (cycle < cap) & torch.any(nact > 0) & pushed

    def body(carry, *gate):
        state, nact, cycle, cycles_per, _ = carry[:5]
        new_state, spent, live, pushed, inc = step(state, nact, *gate)
        if pushed is None:  # any excess moved this (single) cycle?
            pushed = torch.any(new_state.e != state.e)
        out = (new_state, nact_of(new_state), cycle + spent,
               cycles_per + live, pushed)
        if telemetry:
            tel = carry[5]
            if inc is None:
                # one-cycle modes: every active vertex pushed or
                # relabelled exactly once; relabels are the h changes
                relab = sc.count_relabels(state.h, new_state.h)
                _, fr, _ = sc.cycle_stats(g_rows, meta, state, bg.s, bg.t)
                inc = (nact - relab, relab, nact, fr)
            tel = sc.CycleTelemetry(
                pushes=tel.pushes + inc[0], relabels=tel.relabels + inc[1],
                active=tel.active + inc[2], frontier=tel.frontier + inc[3])
            out = out + (tel,)
        return out

    zero = torch.zeros(bg.batch, dtype=_I32, device=dev)
    init = (state, nact_of(state), torch.zeros((), dtype=_I32, device=dev),
            zero, torch.ones((), dtype=torch.bool, device=dev))
    if telemetry:
        init = init + (sc.telemetry_init(batch=bg.batch, device=dev),)
    return body, cond, init


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def batched_resolve(bg: BatchedDeviceGraph, meta, state: BatchedPRState,
                    trivial: np.ndarray | None = None, mode: str = "vc",
                    cycle_chunk: int | None = None,
                    max_rounds: int = 100000, telemetry: bool = False,
                    max_cycles: int | None = None,
                    scan_chunk: int | None = None) -> BatchedSolveResult:
    """[global relabel -> cycles]* from an arbitrary valid preflow state:
    the shared tail of cold solves (entered right after
    ``batched_preflow``) and of warm re-solves.

    Kernel modes route the pooled global-relabel distance sweeps through
    the min-search kernel (one launch per sweep step spanning the batch).

    ``telemetry=True`` fills the result's per-instance ``pushes``/
    ``relabels``/``active_sum``/``frontier_sum`` (int64, accumulated
    across rounds on the host — one read per round, never per cycle).

    ``max_cycles`` (optional) is an exact total cycle budget across
    rounds, threaded into every ``batched_run_cycles`` call.
    ``scan_chunk`` sets the engine's steps per chunk.
    """
    _check_mode(mode)
    B = bg.batch
    if trivial is None:
        trivial = np.zeros(B, bool)
    chunk = cycle_chunk or max(32, min(1024, meta.n))
    gr_minh = engine.resolve_minh_fn(mode)
    gr_time = 0.0
    gr_sweeps = 0

    def relabel(state):
        nonlocal gr_time, gr_sweeps
        t0 = time.perf_counter()
        state, nact, sweeps = batched_global_relabel(bg, meta, state,
                                                     minh_fn=gr_minh)
        # the host loop branches on it: one read a round, between loops
        nact = nact.cpu().numpy()  # lint-ok: host-sync
        gr_sweeps += int(sweeps)
        gr_time += time.perf_counter() - t0
        return state, nact

    state, nact = relabel(state)
    cycles = np.zeros(B, np.int64)
    rounds = np.zeros(B, np.int64)
    counts = np.zeros((4, B), np.int64)  # pushes, relabels, active, frontier
    grs = 1
    remaining = max_cycles  # None = unbounded; else exact total allowance
    for _ in range(max_rounds):
        live = nact > 0
        if not live.any():
            break
        out = batched_run_cycles(bg, meta, state, mode=mode,
                                 max_cycles=chunk, telemetry=telemetry,
                                 budget=remaining, chunk=scan_chunk)
        state = out[0]
        if telemetry:
            counts += np.stack([x.cpu().numpy()  # lint-ok: host-sync
                                for x in out[2][:4]]
                               ).astype(np.int64)
        # the round's counts, read once after its loop
        cyc = out[1].cpu().numpy().astype(np.int64)  # lint-ok: host-sync
        cycles += cyc
        rounds += live
        if remaining is not None:
            # per-lane liveness is a prefix of the loop, so the max lane
            # count IS the number of bulk cycles this call executed
            remaining -= int(cyc.max())
        state, nact = relabel(state)
        grs += 1
        if remaining is not None and remaining <= 0 and (nact > 0).any():
            from repro_torch.errors import BudgetExhausted

            raise BudgetExhausted(
                f"batched push-relabel did not converge within "
                f"max_cycles={max_cycles}",
                cycles_spent=max_cycles - remaining, limit=max_cycles,
                partial=True)
    else:
        raise RuntimeError("batched push-relabel did not converge "
                           "within max_rounds")
    # the result, read once the rounds are done (host int64 values)
    e = state.e.cpu().numpy()  # lint-ok: host-sync
    t = bg.t.cpu().numpy()  # lint-ok: host-sync
    maxflows = e[np.arange(B), t].astype(np.int64)  # lint-ok: int64-state-cast
    maxflows[trivial] = 0
    return BatchedSolveResult(
        maxflows=maxflows, cycles=cycles, rounds=rounds, global_relabels=grs,
        converged=nact == 0, state=state,
        trivial=np.asarray(trivial), gr_time_s=gr_time, gr_sweeps=gr_sweeps,
        pushes=counts[0] if telemetry else None,
        relabels=counts[1] if telemetry else None,
        active_sum=counts[2] if telemetry else None,
        frontier_sum=counts[3] if telemetry else None)


def batched_solve_impl(instances: list[tuple[ResidualCSR, int, int]],
                       mode: str = "vc", cycle_chunk: int | None = None,
                       max_rounds: int = 100000,
                       n_pad: int | None = None, A_pad: int | None = None,
                       deg_max: int | None = None,
                       phase2: bool = False, device=None,
                       telemetry: bool = False,
                       max_cycles: int | None = None,
                       scan_chunk: int | None = None) -> BatchedSolveResult:
    """Cold-solve B instances in one padded batch on ``device`` (``None``
    = the card).  Per-instance max-flow values match the single-instance
    solver exactly (the optimum is unique).  This is the engine behind
    ``repro_torch.api.Solver.solve_many``.

    The kernel modes launch each kernel once per cycle (once per K
    cycles for 'vc_fused') for the whole batch.  ``vc_kernel_bsearch``
    requires head-sorted (bcsr) instances.

    ``phase2=True`` additionally converts every final preflow to a
    genuine flow in one ``batched_phase2`` pass over the whole batch
    (kernel modes on the min search's batch-wide launches), and sets
    ``corrected``.
    """
    if mode == "vc_kernel_bsearch":
        bad = [i for i, (r, _, _) in enumerate(instances)
               if not r.binary_search_ready()]
        if bad:
            raise ValueError(
                "mode 'vc_kernel_bsearch' needs head-sorted (bcsr) "
                f"segments; instances {bad} are not binary-search ready")
    bg, meta, res0, trivial = pack_instances(instances, n_pad=n_pad,
                                             A_pad=A_pad, deg_max=deg_max,
                                             device=device)
    state = batched_preflow(bg, meta, res0)
    out = batched_resolve(bg, meta, state, trivial=trivial, mode=mode,
                          cycle_chunk=cycle_chunk, max_rounds=max_rounds,
                          telemetry=telemetry, max_cycles=max_cycles,
                          scan_chunk=scan_chunk)
    if phase2:
        out.state, leftover = batched_phase2(
            bg, meta, res0, out.state, minh_fn=engine.resolve_minh_fn(mode))
        check_phase2_leftover(leftover)
        out.corrected = True
    return out


# ---------------------------------------------------------------------------
# phase 2 and warm starts
# ---------------------------------------------------------------------------

def batched_phase2(bg: BatchedDeviceGraph, meta, res0,
                   state: BatchedPRState, scan: bool = False,
                   minh_fn=None):
    """Device phase 2 (preflow -> flow) over the whole batch: one pass
    cancels every instance's stranded excess back to its source.

    ``res0`` is the packed ``(B, A_pad)`` initial-capacity array from
    ``pack_instances``.  Returns ``(corrected state, leftover)`` where
    ``leftover[b]`` (a ``(B,)`` tensor) is instance b's undrainable
    excess — zero for every valid preflow (``check_phase2_leftover``
    raises otherwise).  Padded and trivial lanes carry no excess and are
    no-ops.  ``scan=True`` selects with the thread-centric scan (bit for
    bit the same).  Under a kernel ``minh_fn`` each height sweep and each
    cancellation selection is ONE launch spanning the batch
    (``phase2.batched_phase2_impl``)."""
    from repro_torch.core import phase2 as p2

    res, e, leftover = p2.batched_phase2_impl(
        _rows(bg), meta, res0, state.res, state.e, bg.s, bg.t,
        minh_fn=minh_fn, scan=scan)
    return BatchedPRState(res=res, h=state.h, e=e), leftover


def check_phase2_leftover(leftover) -> None:
    """Raise if any batch lane could not drain its excess (invalid preflow)."""
    left = pr.host_array(leftover)
    if left.any():
        bad = np.nonzero(left)[0].tolist()  # lint-ok: host-sync (numpy)
        raise RuntimeError(
            f"phase 2 could not drain excess on batch lanes {bad} — the "
            "states are not valid preflows (excess must be flow-connected "
            "to the source)")


def warm_start_arrays(r: ResidualCSR, prev_res: np.ndarray,
                      prev_e: np.ndarray, s: int,
                      budget: int | None = None):
    """Turn a cached final residual (possibly after capacity increases have
    been added to ``prev_res``) into a valid warm preflow.

    Saturates residual arcs out of the source, each by at most ``budget``
    units.  For a re-solve after capacity increases totalling ``D``, the
    max-flow gain is at most ``D`` and the optimum routes at most ``D``
    additional units through any single source arc, so ``budget = D``
    preserves optimality while bounding the injected excess to
    ``deg(s) * D`` instead of the full unsent source capacity.
    ``budget=None`` saturates fully, which on a fresh residual is exactly
    the preflow initialisation.

    Returns host ``(res, h, e)`` ready for ``pack_states`` (heights are
    recomputed by the global relabel inside ``batched_resolve``).  The
    arithmetic stages in int64 and narrows through ``as_state_dtype`` —
    values that left the int32 state dtype raise instead of wrapping.
    """
    res = np.asarray(prev_res, np.int64).copy()
    e = np.asarray(prev_e, np.int64).copy()
    lo, hi = int(r.indptr[s]), int(r.indptr[s + 1])
    out = np.arange(lo, hi)
    d = res[out] if budget is None else np.minimum(res[out], budget)
    res[r.rev[out]] += d
    np.add.at(e, r.heads[out], d)
    res[out] -= d
    e[s] = 0
    h = np.zeros(r.n, STATE_DTYPE)
    return (as_state_dtype(res, "warm-start res"), h,
            as_state_dtype(e, "warm-start excess"))


def find_arc(r: ResidualCSR, u: int, v: int) -> int:
    """Index of the directed arc u->v; raises KeyError when the pair does
    not exist (a structural change — callers must rebuild the CSR).

    Scans only u's arc segment (O(log deg) on bcsr, whose segments are
    head-sorted; O(deg) on rcsr) — this sits on the capacity-update path
    of every warm re-solve."""
    if not 0 <= u < r.n:
        raise KeyError(f"no arc {u}->{v} in graph")
    lo, hi = int(r.indptr[u]), int(r.indptr[u + 1])
    seg = r.heads[lo:hi]
    if r.binary_search_ready():
        i = int(np.searchsorted(seg, v))
        if i < seg.size and seg[i] == v:
            return lo + i
    else:
        hit = np.nonzero(seg == v)[0]
        if hit.size:
            return lo + int(hit[0])
    raise KeyError(f"no arc {u}->{v} in graph")


def apply_capacity_increases(r: ResidualCSR, res: np.ndarray,
                             updates) -> tuple[ResidualCSR, np.ndarray]:
    """Apply ``(u, v, delta>=0)`` capacity increases to a solved residual.

    Returns ``(updated ResidualCSR, updated res)``; raises ``KeyError`` if
    ``(u, v)`` is not an existing directed pair (a structural change — the
    caller must fall back to a cold solve on a rebuilt CSR) and
    ``ValueError`` for negative deltas (not warm-startable: reducing
    capacity below routed flow creates deficits push-relabel cannot drain).
    It raises ``OverflowError`` when the increases take an arc pair's
    capacity past the int32 bound (``pushrelabel.check_arc_pairs``), and
    leaves ``r`` and ``res`` as they were; the source's out-capacity is
    checked where the result is packed for a solve (``pack_instances``).
    """
    res = np.asarray(res, np.int64).copy()  # lint-ok: int64-state-cast
    res0 = r.res0.copy()
    for u, v, delta in updates:
        if delta < 0:
            raise ValueError("capacity decreases are not warm-startable")
        a = find_arc(r, u, v)
        res[a] += delta
        res0[a] += delta
    r2 = dataclasses.replace(r, res0=res0)
    pr.check_arc_pairs(r2)
    return r2, res
