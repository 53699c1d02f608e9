"""Device-resident flow rerouting for capacity decreases (port of the JAX
package's ``repro.streaming.reroute``).

A capacity decrease on arc ``(u, v)`` only invalidates the routed flow
when the arc carried more than the new capacity.  Instead of
cold-solving, the overflow ``o = flow - new_cap`` is *cancelled* on the
arc, which leaves a pseudo-flow with a signed per-vertex imbalance
``b``: ``+o`` of excess at ``u`` (units it was forwarding that no longer
fit) and ``-o`` of deficit at ``v`` (units it was passing on that no
longer arrive).  Both imbalances are drained on the device with the same
height-bounded bulk-synchronous cancellation phase 2 uses
(``repro_torch.core.phase2``: its outer/inner loop ``_drain``, its
cancellation step with ``outbound=True`` and its apply), on the shared
``minh_fn`` hook — the kernel modes run the drain on the min search's
gather entry, its dense form for every distance sweep and its AVQ form
for every cancellation:

* **deficit first**, along *outbound* flow arcs toward the multi-sink
  set ``{t} ∪ {vertices with excess}``.  Heights are the exact distance
  to that set over the pseudo-residual ``fout[a] = flow(a)`` (a
  Bellman-Ford sweep identical to ``globalrelabel.residual_distances_impl``
  but seeded at every sink).  Deficit reaching ``t`` reduces the flow
  value; deficit reaching an excess vertex annihilates against it
  (that pairing is what retires cancelled *cycle* flow, which has no
  path to ``t`` at all).  By pseudo-flow decomposition every deficit
  vertex has an outbound flow path into the sink set, so each pass with
  fresh heights makes progress.
* **excess second**, along inbound flow arcs back to ``s`` — literally
  ``phase2_impl``: once no deficits remain, every leftover excess is
  flow-connected to the source.

The result is a feasible (conservation-respecting) flow on the updated
capacities whose value is ``old_value - drained``; re-entering the
solver warm with budget ``drained + total_increases`` recovers
maximality (the new optimum exceeds the drained value by at most that
much), and a zero budget means the flow is *already* maximal — no
solver dispatch at all.  Both loops run on the sweep engine, one host
read per chunk; only :func:`_finish` reads the leftovers, once, after
the drain.  ``drain_prepared`` pools many streams' drains into one
dispatch (one launch per sweep step and per selection for the whole
pool under the kernel hook), bit for bit the per-stream drains.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import batched
from repro_torch.core import engine
from repro_torch.core import globalrelabel as gr
from repro_torch.core import phase2
from repro_torch.core import pushrelabel as pr
from repro_torch.core.csr import ResidualCSR
from repro_torch.kernels.ref import INF
from repro_torch.obs import counter, span

_I32 = torch.int32


# ---------------------------------------------------------------------------
# host side: apply signed capacity deltas, cancel overflow
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RerouteResult:
    """Outcome of applying signed updates to a corrected flow."""

    residual: ResidualCSR  # updated capacities (res0)
    res: np.ndarray  # feasible flow on the new capacities (int32)
    e: np.ndarray  # zero everywhere but e[t] == value (int32)
    value: int  # flow value after the drain (pre-re-solve)
    budget: int  # warm re-solve budget; 0 => already maximal
    overflow: int  # units cancelled on decreased arcs
    rerouted: bool  # a device drain actually ran
    ok: bool  # False => drain stalled, caller must cold-solve


@dataclasses.dataclass
class PreparedReroute:
    """Host-side outcome of ``prepare_signed``: updated capacities plus
    the cancelled-overflow imbalance, staged for a (possibly pooled)
    device drain.  ``overflow == 0`` means no drain is needed —
    ``drain_prepared`` answers directly."""

    residual: ResidualCSR  # updated capacities (res0)
    res: np.ndarray  # int64 post-cancel pseudo-flow
    b: np.ndarray  # int64 signed per-vertex imbalance
    e: np.ndarray  # int64 corrected excess of the pre-update flow
    s: int
    t: int
    old_value: int
    inc_total: int
    overflow: int


def prepare_signed(r: ResidualCSR, res: np.ndarray, e: np.ndarray,
                   s: int, t: int, ups) -> PreparedReroute:
    """The host half of ``apply_signed``: fold ``(u, v, signed_delta)``
    updates into the capacities, cancel overflow on decreased arcs and
    account the signed imbalance — NO device work.  Raises ``KeyError``
    for a missing arc and ``ValueError`` for a capacity driven below
    zero.  Preparations from many independent streams can then be pooled
    into one device drain (``drain_prepared``)."""
    res0 = np.asarray(r.res0, np.int64).copy()  # lint-ok: int64-state-cast
    res = np.asarray(res, np.int64).copy()  # lint-ok: int64-state-cast
    b = np.zeros(r.n, np.int64)
    inc_total = 0
    overflow = 0
    for u, v, delta in ups:
        a = batched.find_arc(r, u, v)
        if delta >= 0:
            res0[a] += delta
            res[a] += delta
            inc_total += delta
            continue
        c_new = res0[a] + delta
        if c_new < 0:
            raise ValueError(
                f"capacity of {u}->{v} would go negative "
                f"({int(res0[a])} {delta:+d})")
        f = res0[a] - res[a]  # current flow on the arc (negative: reverse)
        o = max(0, int(f - c_new))
        res0[a] = c_new
        res[a] += delta + o  # == c_new - min(f, c_new): never negative
        if o:
            res[r.rev[a]] -= o  # cancelled flow returns its reverse slack
            b[u] += o  # tail keeps units it can no longer forward
            b[v] -= o  # head no longer receives them
            overflow += o
    b[s] = 0  # the source absorbs/supplies freely; never an imbalance
    return PreparedReroute(
        residual=dataclasses.replace(r, res0=res0), res=res, b=b,
        e=np.asarray(e, np.int64).copy(),  # lint-ok: int64-state-cast
        s=s, t=t, old_value=int(e[t]),
        inc_total=inc_total, overflow=overflow)


def _finish(prep: PreparedReroute, res_j: np.ndarray, e_j: np.ndarray,
            stalled: int) -> RerouteResult:
    """Fold a drained ``(res, e)`` pair back into a ``RerouteResult``
    (counter accounting included) — shared by the single-instance and the
    pooled drain paths."""
    if stalled:
        # invariant violated (the input was not a corrected flow): loud
        # counter, graceful answer — the caller cold-solves
        counter("stream.reroute.stalls").inc()
        return RerouteResult(residual=prep.residual, res=np.asarray(res_j),
                             e=np.asarray(e_j), value=prep.old_value,
                             budget=0, overflow=prep.overflow,
                             rerouted=True, ok=False)
    value = int(np.asarray(e_j)[prep.t])
    counter("stream.reroute.drained_units").inc(
        max(0, prep.old_value - value))
    return RerouteResult(
        residual=prep.residual, res=np.asarray(res_j), e=np.asarray(e_j),
        value=value,
        budget=max(0, prep.old_value + prep.inc_total - value),
        overflow=prep.overflow, rerouted=True, ok=True)


def _no_drain_result(prep: PreparedReroute) -> RerouteResult:
    """Pure increases (or slack-only decreases): no device drain."""
    return RerouteResult(
        residual=prep.residual,
        res=batched.as_state_dtype(prep.res, "updated res"),
        e=batched.as_state_dtype(prep.e, "updated excess"),
        value=prep.old_value, budget=prep.inc_total, overflow=0,
        rerouted=False, ok=True)


def _minh_fn(use_kernel: bool):
    """The drain's segmented-min hook: the min search's gather entry, or
    ``None`` for the plain PyTorch path."""
    if not use_kernel:
        return None
    from repro_torch.kernels import ops as kops

    return kops.min_neighbor_minh_fn()


def _put(x: np.ndarray, what: str, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(batched.as_state_dtype(x, what)).to(dev)


def apply_signed(r: ResidualCSR, res: np.ndarray, e: np.ndarray,
                 s: int, t: int, ups, use_kernel: bool = False,
                 device=None) -> RerouteResult:
    """Apply ``(u, v, signed_delta)`` updates to a phase-2-corrected
    ``(res, e)`` flow and reroute any overflowed flow on ``device``
    (``None`` = the card).

    Increases follow ``batched.apply_capacity_increases`` semantics
    (residual grows, flow untouched).  Decreases below the currently
    routed flow cancel the overflow and drain the resulting imbalance
    (module docstring); decreases that stay above the routed flow are
    free.  ``use_kernel=True`` runs the drain's segmented mins on the
    min-search kernel (bit for bit the plain path's).  Raises
    ``KeyError`` for a missing arc and ``ValueError`` for a capacity
    driven below zero.
    """
    prep = prepare_signed(r, res, e, s, t, ups)
    if prep.overflow == 0:
        return _no_drain_result(prep)

    counter("stream.reroute.applies").inc()
    counter("stream.reroute.overflow_units").inc(prep.overflow)
    minh_fn = _minh_fn(use_kernel)
    r2 = prep.residual
    g, meta, res0 = pr.to_device(r2, device)
    dev = res0.device
    with span("stream.reroute", n=r2.n, arcs=r2.num_arcs,
              overflow=prep.overflow):
        res_j, e_j, deficit_left, excess_left = _reroute_impl(
            g, meta, res0, _put(prep.res, "reroute res", dev),
            _put(prep.b, "reroute imbalance", dev),
            _put(prep.e, "reroute excess", dev), s, t, minh_fn=minh_fn)
        stalled = int(deficit_left + excess_left)
        res_np, e_np = res_j.cpu().numpy(), e_j.cpu().numpy()
    return _finish(prep, res_np, e_np, stalled)


def drain_prepared(preps: list[PreparedReroute], use_kernel: bool = False,
                   device=None) -> list[RerouteResult]:
    """Drain MANY prepared reroutes in ONE pooled dispatch on ``device``
    (``None`` = the card).

    The overflowed preparations are packed into stacked ``(B, ...)`` rows
    (``batched.pack_instances`` shapes; the imbalance vector rides in the
    height slot of ``batched.pack_states``) and the whole pool runs
    through the batched drain (:func:`_batched_reroute_impl`) — one
    engine loop per phase for every stream at once, and under the kernel
    hook ONE launch spanning the pool per sweep step and per selection.
    Overflow-free preparations are answered inline without device work.
    Results are bit for bit what per-stream ``apply_signed`` produces:
    each row's trajectory depends only on its own arrays (see
    ``phase2.batched_phase2_impl``).
    """
    out: list[RerouteResult | None] = [None] * len(preps)
    todo = []
    for i, prep in enumerate(preps):
        if prep.overflow == 0:
            out[i] = _no_drain_result(prep)
        else:
            todo.append(i)
            counter("stream.reroute.applies").inc()
            counter("stream.reroute.overflow_units").inc(prep.overflow)
    if not todo:
        return out  # type: ignore[return-value]
    minh_fn = _minh_fn(use_kernel)
    pool = [preps[i] for i in todo]
    bg, meta, res0_p, _ = batched.pack_instances(
        [(p.residual, p.s, p.t) for p in pool], device=device)
    state = batched.pack_states(
        [(batched.as_state_dtype(p.res, "reroute res"),
          batched.as_state_dtype(p.b, "reroute imbalance"),
          batched.as_state_dtype(p.e, "reroute excess")) for p in pool],
        meta.n, meta.num_arcs, device=res0_p.device)
    counter("stream.reroute.batched_dispatches").inc()
    with span("stream.reroute.pooled", streams=len(pool), n=meta.n,
              arcs=meta.num_arcs,
              overflow=sum(p.overflow for p in pool)):
        res_j, e_j, deficit_left, excess_left = _batched_reroute_impl(
            batched._rows(bg), meta, res0_p, state.res, state.h, state.e,
            bg.s, bg.t, minh_fn=minh_fn)
        res_np, e_np = res_j.cpu().numpy(), e_j.cpu().numpy()
        left = (deficit_left + excess_left).cpu().numpy()
    for row, i in enumerate(todo):
        p = preps[i]
        out[i] = _finish(p, res_np[row, : p.residual.num_arcs],
                         e_np[row, : p.residual.n], int(left[row]))
    return out  # type: ignore[return-value]


def apply_signed_batched(items, use_kernel: bool = False,
                         device=None) -> list[RerouteResult]:
    """``apply_signed`` over many independent streams with the overflow
    drains POOLED into one dispatch.  ``items`` is a list of ``(r, res,
    e, s, t, ups)`` tuples; returns one ``RerouteResult`` per item, bit
    for bit equal to calling ``apply_signed`` per item."""
    preps = [prepare_signed(r, res, e, s, t, ups)
             for r, res, e, s, t, ups in items]
    return drain_prepared(preps, use_kernel=use_kernel, device=device)


# ---------------------------------------------------------------------------
# device side: deficit drain (phase 2's mirror) + excess drain (phase 2)
# ---------------------------------------------------------------------------

def _dist0(sink: torch.Tensor) -> torch.Tensor:
    """The starting distances of a multi-sink sweep: 0 on the set, INF
    elsewhere, made in int32 (an int64 ``where`` narrowed afterwards
    would leave the int32 lattice)."""
    return torch.full(sink.shape, INF, dtype=_I32,
                      device=sink.device).masked_fill_(sink, 0)


def _multi_sink_sweep(g, meta, fres, sink, minh_fn=None):
    """``(sweep, dist0)``: one Bellman-Ford sweep toward the vertex *set*
    ``sink`` (a boolean mask) over ``fres``-positive arcs, and the
    starting distances (0 on the set, INF elsewhere) — the global
    relabel's sweep (``globalrelabel.sweep_candidates``, on the gather
    entry's dense form under a kernel ``minh_fn``) seeded at every sink,
    with the ``where(sink, 0, min(dist, cand))`` fold on both routes."""
    cand = gr.sweep_candidates(g, meta, fres, minh_fn)

    def sweep(dist):
        return torch.where(sink, 0, torch.minimum(dist, cand(dist)))

    return sweep, _dist0(sink)


def _multi_sink_distances(g, meta, fres, sink, minh_fn=None):
    """Exact distance to the nearest sink over ``fres``-positive arcs
    (:func:`_multi_sink_sweep`), swept to fixpoint through the shared
    engine."""
    sweep, dist0 = _multi_sink_sweep(g, meta, fres, sink, minh_fn)
    return engine.run_to_fixpoint(sweep, dist0, cap=meta.n)[0]


def _batched_multi_sink_sweep(g, meta, fres, sink, minh_fn=None):
    """Batch-level :func:`_multi_sink_sweep` over stacked rows: ``fres``
    is ``(B, A)``, ``sink`` a ``(B, n)`` mask; each sweep is ONE segmented
    min spanning the batch (``globalrelabel.batched_sweep_candidates``)."""
    cand = gr.batched_sweep_candidates(g, meta, fres, minh_fn)

    def sweep(dist):
        return torch.where(sink, 0, torch.minimum(dist, cand(dist)))

    return sweep, _dist0(sink)


def _batched_multi_sink_distances(g, meta, fres, sink, minh_fn=None):
    """Batch-level :func:`_multi_sink_distances`: one shared sweep loop
    serves the whole pool.  Rows that reach their fixpoint earlier are
    fixpoints of the sweep, so results equal the per-row loops bit for
    bit."""
    sweep, dist0 = _batched_multi_sink_sweep(g, meta, fres, sink, minh_fn)
    return engine.run_to_fixpoint(sweep, dist0, cap=meta.n)[0]


def _deficit_cancel_step(g, meta, res0, res, height, b, s, t,
                         minh_fn: Callable | None = None):
    """One bulk-synchronous deficit cancellation: every deficit vertex
    retires ``min(-b, flow)`` units of its minimum-height *outbound* flow
    arc, provided that arc steps strictly toward the sink set — phase 2's
    cancellation step (``phase2._cancel_step``) with ``outbound=True``
    on the negated imbalance.  Arc ownership by the selecting vertex
    keeps the scatter conflict-free: within a coalesced pair only one
    direction can carry positive flow.  Returns ``(res, b)``."""
    st = phase2._cancel_step(g, meta, res0, pr.PRState(res, height, -b), s,
                             t, minh_fn, outbound=True)
    return st.res, -st.e


def _batched_deficit_cancel_step(g, meta, flat, res0, res, height, b, s, t,
                                 minh_fn: Callable | None = None):
    """Batch-level :func:`_deficit_cancel_step` over stacked ``(B, ...)``
    rows (``flat`` is ``batched._flat`` of them): phase 2's batched
    cancellation step with ``outbound=True``, its selection ONE launch
    spanning the batch under a kernel ``minh_fn``."""
    res, e = phase2._batched_cancel_step(g, meta, flat, res0, res, height,
                                         -b, s, t, minh_fn, outbound=True)
    return res, -e


def _drain_deficit(g, meta, res0, res, b, s: int, t: int,
                   minh_fn: Callable | None = None):
    """Drain every negative imbalance along outbound flow arcs into
    ``{t} ∪ {b > 0}`` through phase 2's [heights -> cancel-to-fixpoint]
    loop (``phase2._drain``), carrying ``e = -b``.  Returns ``(res, b,
    leftover)``, ``leftover`` the 0-d int32 deficit it could not
    drain."""
    inner = engine.fill_at(engine.fill_at(
        torch.ones(meta.n, dtype=torch.bool, device=b.device), s, False),
        t, False)

    def stranded(e):  # the deficit left off s and t
        return torch.where(inner, torch.clamp(e, min=0), 0).sum(dtype=_I32)

    def heights(res, e):
        sink = engine.fill_at(e < 0, t, True)  # {t} ∪ {b > 0}
        return _multi_sink_distances(g, meta, res0 - res, sink, minh_fn)

    def cancel(res, height, e):
        res, b = _deficit_cancel_step(g, meta, res0, res, height, -e, s, t,
                                      minh_fn)
        return res, -b

    res, e = phase2._drain(heights, cancel, res, -b, stranded)
    return res, -e, stranded(e)


def _fold_imbalance(b: torch.Tensor, e: torch.Tensor, s: int,
                    t: int) -> torch.Tensor:
    """The drained imbalance as a plain excess vector: positives are
    stranded excess, ``b[t]`` adjusts the flow value (deficit that
    reached the sink is value lost; excess minted at ``t`` by a cancel on
    an outbound arc of ``t`` is value regained by its returning deficit),
    and ``s`` holds none — ``max(b, 0)``, then ``e[t] + b[t]`` at ``t``,
    then 0 at ``s``, in that order, on the device."""
    e2 = torch.clamp(b, min=0)
    e2[t:t + 1] = e[t:t + 1] + b[t:t + 1]
    return engine.fill_at(e2, s, 0)


def _reroute_impl(g, meta, res0, res, b, e, s: int, t: int,
                  minh_fn: Callable | None = None):
    """The full device drain: deficit toward ``{t} ∪ {excess}``, then the
    leftover excess back to ``s`` via ``phase2_impl``.  ``e`` is the
    corrected excess of the pre-update flow (zero but ``e[t]``).  Returns
    ``(res, e, deficit_left, excess_left)`` — both leftovers 0-d int32
    tensors, zero on success, ``e`` again zero everywhere but
    ``e[t] == new value``."""
    res, b, deficit_left = _drain_deficit(g, meta, res0, res, b, s, t,
                                          minh_fn=minh_fn)
    res, e3, excess_left = phase2.phase2_impl(
        g, meta, res0, res, _fold_imbalance(b, e, s, t), s, t,
        minh_fn=minh_fn)
    return res, e3, deficit_left, excess_left


# ---------------------------------------------------------------------------
# batch-level formulation: many streams' drains in one dispatch
# ---------------------------------------------------------------------------

def _batched_drain_deficit(g, meta, res0, res, b, s, t,
                           minh_fn: Callable | None = None):
    """Batch-level :func:`_drain_deficit`: every stream's negative
    imbalance drains at once through the shared [heights ->
    cancel-to-fixpoint] loops of ``phase2._drain``, the pool seen as one
    flat graph of B parts.  Rows that finish or stall earlier are
    fixpoints of both loops (the argument of
    ``phase2.batched_phase2_impl``), so results match the per-stream
    drains bit for bit.  ``s``/``t`` are ``(B,)`` tensors.  Returns
    ``(res, b, leftover (B,))``."""
    inner = phase2._inner_rows(meta.n, s, t)
    t_col = t.long()[:, None]
    flat = batched._flat(g, meta)  # loop-invariant, built once

    def stranded(e):
        return torch.where(inner, torch.clamp(e, min=0), 0).sum(
            dim=1, dtype=_I32)

    def heights(res, e):
        sink = (e < 0).scatter_(1, t_col, True)
        return _batched_multi_sink_distances(g, meta, res0 - res, sink,
                                             minh_fn)

    def cancel(res, height, e):
        res, b = _batched_deficit_cancel_step(g, meta, flat, res0, res,
                                              height, -e, s, t, minh_fn)
        return res, -b

    res, e = phase2._drain(heights, cancel, res, -b, stranded)
    return res, -e, stranded(e)


def _batched_reroute_impl(g, meta, res0, res, b, e, s, t,
                          minh_fn: Callable | None = None):
    """Batch-level :func:`_reroute_impl`: the full drain for B pooled
    streams in one dispatch — deficit toward each row's ``{t} ∪
    {excess}``, then leftover excess back to each row's ``s`` via
    ``phase2.batched_phase2_impl``.  Returns ``(res, e, deficit_left,
    excess_left)`` with per-row ``(B,)`` leftovers."""
    res, b, deficit_left = _batched_drain_deficit(g, meta, res0, res, b,
                                                  s, t, minh_fn=minh_fn)
    t_col, s_col = t.long()[:, None], s.long()[:, None]
    e2 = torch.clamp(b, min=0)
    e2.scatter_(1, t_col, torch.gather(e, 1, t_col)
                + torch.gather(b, 1, t_col))
    e2.scatter_(1, s_col, 0)
    res, e3, excess_left = phase2.batched_phase2_impl(
        g, meta, res0, res, e2, s, t, minh_fn=minh_fn)
    return res, e3, deficit_left, excess_left
