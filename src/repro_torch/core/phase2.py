"""Device phase 2: preflow -> flow conversion (flow decomposition); port
of the JAX package's ``repro.core.phase2``.

The solver (``repro_torch.core.pushrelabel``) terminates with a maximum
*preflow*: ``e[t]`` is the max-flow value, but vertices that the global
relabel deactivated may hold stranded excess, so ``res0 - res`` is not
yet a conservation-respecting flow.  Every stranded unit of excess is
flow-connected to ``s``, so all of it can be drained at once by
cancelling flow along arcs that step closer to the source, with the same
primitives as phase 1:

* **heights**: a reverse BFS from ``s`` over flow-carrying arcs —
  ``globalrelabel.residual_distances_impl`` on the pseudo-residual
  ``fin[a] = flow(rev[a])``, swept to fixpoint with segmented mins (the
  dense form of the min-search kernel under a kernel ``minh_fn``);
* **cancellation**: every stranded vertex selects its minimum-height
  inbound flow arc with the flat-frontier segmented min the
  vertex-centric push uses (``pushrelabel._flat_frontier_minh``, the AVQ
  form of the kernel under a kernel ``minh_fn``, or the thread-centric
  scan with ``scan=True``), and cancels ``min(e, fin)`` units on it when
  the arc is strictly height-decreasing.

When the inner loop drains no more, the outer loop recomputes heights;
each pass with fresh heights makes progress (a stranded vertex at height
``d`` has an inbound flow arc from height ``d-1``), so the loop ends
with all excess returned to ``s``.  Both loops run on the sweep engine
(one host read per chunk; the outer loop's chunk is one pass).  Every
selector picks the smallest arc index attaining the minimum height, and
integer adds commute, so the results are bit for bit the reference's.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import globalrelabel as gr
from repro_torch.core import pushrelabel as pr
from repro_torch.core.csr import ResidualCSR
from repro_torch.kernels.ref import INF

_I32 = torch.int32


def inflow(g: pr.DeviceGraph, res0: torch.Tensor,
           res: torch.Tensor) -> torch.Tensor:
    """Per-arc inbound flow: ``fin[a]`` is the flow carried by ``rev[a]``,
    i.e. arriving at ``tails[a]`` from ``heads[a]``.  Positive entries are
    the arcs phase 2 may cancel along, and ``fin`` doubles as the
    pseudo-residual of the height BFS."""
    return (res0 - res)[g.rev]


def flow_heights_impl(g: pr.DeviceGraph, meta, res0, res, s: int,
                      minh_fn: Callable | None = None):
    """Exact distance-from-``s`` along flow-carrying arcs, by reverse BFS
    over ``inflow`` — ``residual_distances_impl`` with the source as the
    sink.  Unreachable vertices get INF.  Returns ``(heights, sweeps)``."""
    return gr.residual_distances_impl(g, meta, inflow(g, res0, res), s,
                                      minh_fn=minh_fn)


def _cancel_apply(heads, rev, res, e, fin, height, u, q_valid, minh, argarc,
                  outbound: bool = False):
    """Cancel ``min(e, fin)`` units on each lane's selected arc where it
    is strictly height-decreasing: ``res[arc] -= d`` and
    ``res[rev[arc]] += d`` undo the inbound flow, and the excess moves
    from ``u`` to ``heads[arc]``.  ``outbound=True`` is the streaming
    drain's mirror (``fin`` is the flow the arc itself carries, ``e`` the
    negated imbalance): the residual's sign flips, ``res[arc] += d`` and
    ``res[rev[arc]] -= d``, and the excess moves the same way.  Lanes
    ``u`` (one per vertex slot, ``q_valid`` marking real ones) and arcs
    index flat arrays, so one call serves an instance or a batch seen as
    one graph.  A lane that does not cancel adds zero at a slot of its own
    (the reference drops its scatter)."""
    nv, a = height.shape[0], res.shape[0]
    u_c = torch.clamp(u, max=nv - 1)
    arc_c = torch.clamp(argarc, 0, a - 1)
    do = q_valid & (minh < height[u_c])  # strictly toward the sinks
    d = torch.where(do, torch.minimum(e[u_c], fin[arc_c]), 0)
    lane = torch.arange(u.shape[0], dtype=_I32, device=u.device)
    idle = lane % a
    dr = d if outbound else -d  # what the selected arc's residual gains
    res = res.index_add(0, torch.cat([torch.where(do, arc_c, idle),
                                      torch.where(do, rev[arc_c], idle)]),
                        torch.cat([dr, -dr]))
    e = e.index_add(0, torch.cat([torch.where(do, u_c, lane),
                                  torch.where(do, heads[arc_c], lane)]),
                    torch.cat([-d, d]))
    return res, e


def _cancel_step(g: pr.DeviceGraph, meta, res0, state: pr.PRState, s: int,
                 t: int, minh_fn: Callable | None = None,
                 scan: bool = False, outbound: bool = False) -> pr.PRState:
    """One bulk-synchronous cancellation: every stranded vertex returns
    ``min(e, fin)`` units along its minimum-height inbound flow arc,
    provided that arc is strictly height-decreasing.  ``state.h`` holds
    the flow heights (distance from s).  ``outbound=True`` is the
    streaming drain's deficit step: ``state.e`` is the negated imbalance,
    and each deficit vertex retires flow on its minimum-height *outbound*
    flow arc (``fout = res0 - res``) toward the sink set the heights
    measure (``_cancel_apply``)."""
    n = meta.n
    res, height, e = state
    strand = engine.fill_at(engine.fill_at(e > 0, s, False), t, False)
    fin = res0 - res if outbound else inflow(g, res0, res)
    # the phase-1 min-height machinery verbatim: res := inbound flow,
    # h := flow heights -> (min height of a flow-sending neighbour, arc)
    pseudo = pr.PRState(res=fin, h=height, e=e)
    if scan:
        u = torch.arange(n, dtype=_I32, device=e.device)
        q_valid = strand
        minh, argarc = pr._tc_scan_minh(g, meta, pseudo, strand)
    else:
        u = torch.nonzero_static(strand, size=n, fill_value=n).view(-1).to(
            _I32)
        q_valid = u < n
        fn = pr._flat_frontier_minh if minh_fn is None else minh_fn
        minh, argarc = fn(g, meta, pseudo, u, q_valid)
    res, e = _cancel_apply(g.heads, g.rev, res, e, fin, height, u, q_valid,
                           minh, argarc, outbound)
    return pr.PRState(res=res, h=height, e=e)


def _drain(heights_fn: Callable, cancel_fn: Callable, res, e,
           stranded_fn: Callable):
    """The outer [heights -> cancel to fixpoint] loop shared by the
    single and the batched phase 2 and the streaming drain's deficit
    half.  ``heights_fn(res, e)`` gives the pass's heights,
    ``cancel_fn(res, height, e)`` one cancellation step,
    ``stranded_fn(e)`` the stranded excess (0-d, or ``(B,)`` for a
    batch, whose per-pass progress is then kept per row)."""

    def outer_cond(carry):
        _, e, progressed = carry
        return torch.any((stranded_fn(e) > 0) & progressed)

    def outer_body(carry):
        res, e, _ = carry
        e_before = e
        height = heights_fn(res, e)

        def inner_body(c):
            res, e, _ = c
            res2, e2 = cancel_fn(res, height, e)
            return res2, e2, torch.any(e2 != e)

        true = torch.ones((), dtype=torch.bool, device=e.device)
        res, e, _ = engine.run_bulk_loop(inner_body, (res, e, true),
                                         cond_fn=lambda c: c[2])
        # no movement under fresh heights: a row that moved nothing can
        # never move again (its state is unchanged) — done, or stuck on
        # an invalid preflow (the caller raises)
        moved = e != e_before
        return res, e, (torch.any(moved, dim=1) if moved.ndim == 2
                        else torch.any(moved))

    prog = torch.ones(e.shape[:-1], dtype=torch.bool, device=e.device)
    # chunk=1: one outer step is a full [heights -> cancel-to-fixpoint]
    # pass; speculative passes would be pure gated waste
    res, e, _ = engine.run_bulk_loop(outer_body, (res, e, prog),
                                     cond_fn=outer_cond, chunk=1)
    return res, e


def phase2_impl(g: pr.DeviceGraph, meta, res0, res, e, s: int, t: int,
                minh_fn: Callable | None = None, scan: bool = False):
    """Drain all stranded excess at once, on the tensors' device.

    Returns ``(res, e, leftover)``: the corrected residual (a genuine
    flow when ``leftover == 0``), the cleaned excess (zero everywhere but
    ``e[t] == maxflow``), and the excess that could not be drained, a 0-d
    int32 tensor (non-zero only if the input was not a valid preflow —
    callers raise).  ``scan=True`` selects cancellation arcs with the
    thread-centric scan (``O(n * deg_max)``); the default flat frontier
    is workload-balanced (``O(sum deg(stranded))``).  Results are bit for
    bit identical either way."""
    inner = engine.fill_at(engine.fill_at(
        torch.ones(meta.n, dtype=torch.bool, device=e.device), s, False),
        t, False)

    def stranded(e):
        return torch.where(inner, e, 0).sum(dtype=_I32)

    def heights(res, e):
        return flow_heights_impl(g, meta, res0, res, s, minh_fn=minh_fn)[0]

    def cancel(res, height, e):
        st = _cancel_step(g, meta, res0, pr.PRState(res, height, e), s, t,
                          minh_fn, scan)
        return st.res, st.e

    res, e = _drain(heights, cancel, res, e, stranded)
    leftover = stranded(e)
    clean = torch.zeros_like(e)
    clean[t:t + 1] = e[t:t + 1]  # a flow: only the sink holds excess
    return res, clean, leftover


# ---------------------------------------------------------------------------
# batch-level formulation (stacked (B, ...) rows, shared sweep loops)
# ---------------------------------------------------------------------------

def batched_inflow(g: pr.DeviceGraph, res0, res):
    """``inflow`` over stacked rows: per-row gather of ``(res0-res)[rev]``."""
    return torch.gather(res0 - res, 1, g.rev.long())


def _inner_rows(n: int, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``(B, n)`` bool: each row's vertices other than its ``s`` and ``t``."""
    v = torch.arange(n, device=s.device)
    return (v[None, :] != s[:, None]) & (v[None, :] != t[:, None])


def _batched_cancel_step(g: pr.DeviceGraph, meta, flat, res0, res, height,
                         e, s, t, minh_fn: Callable | None = None,
                         scan: bool = False, outbound: bool = False):
    """Batch-level ``_cancel_step``: one bulk-synchronous cancellation for
    every instance at once, over the batch seen as one graph of ``B``
    disjoint parts (``flat``, ``batched._flat`` of the rows: row ``b``'s
    vertex ``v`` is ``b * n + v``, its arc ``a`` is ``b * A + a``).  Under
    a kernel ``minh_fn`` the selection is ONE launch of the min search's
    AVQ form spanning the batch; otherwise one flat-frontier search (or,
    ``scan=True``, one thread-centric scan) over the flat graph — the
    same choices either way.  ``outbound=True``: the streaming drain's
    deficit step, as in :func:`_cancel_step`."""
    from repro_torch.core import batched
    from repro_torch.kernels import ref as kref

    bsz, n = e.shape
    A = res.shape[1]
    N, AF = flat.meta.n, flat.meta.num_arcs
    strand = (e > 0) & _inner_rows(n, s, t)
    fin = res0 - res if outbound else batched_inflow(g, res0, res)
    fin_f, h_f = fin.view(-1), height.view(-1)
    heads_f = flat.g.heads
    if scan:
        u = torch.arange(N, dtype=_I32, device=e.device)
        q_valid = strand.view(-1)
        minh, argarc = pr.tc_scan(flat.starts, flat.ends - flat.starts,
                                  heads_f, fin_f, h_f, q_valid,
                                  meta.deg_max)
    else:
        avq = batched.row_avq(strand)
        q_valid = (avq < n).view(-1)
        u = torch.where(avq < n, avq + flat.voff, N).view(-1)
        if minh_fn is None:
            key = torch.where(fin_f > 0, h_f[heads_f], INF)
            minh, argarc = kref.min_neighbor_segments(u, flat.starts,
                                                      flat.ends, key, n=N)
        else:
            out = minh_fn(g, meta, pr.PRState(fin, height, e), avq,
                          avq < n)
            minh = out[0].view(-1)
            # row-local arcs (A = none) -> flat (AF = none)
            argarc = torch.where(out[1] < A, out[1] + flat.aoff, AF).view(-1)
    res_f, e_f = _cancel_apply(heads_f, flat.g.rev, res.view(-1), e.view(-1),
                               fin_f, h_f, u, q_valid, minh, argarc, outbound)
    return res_f.view(bsz, A), e_f.view(bsz, n)


def batched_phase2_impl(g: pr.DeviceGraph, meta, res0, res, e, s, t,
                        minh_fn: Callable | None = None,
                        scan: bool = False):
    """Batch-level :func:`phase2_impl` over stacked ``(B, ·)`` rows
    (``s``/``t`` are ``(B,)`` tensors): drain every instance's stranded
    excess with shared [heights -> cancel-to-fixpoint] loops — the height
    sweeps and (``scan=False``) cancellation selections each run as ONE
    batch-wide launch per step under a kernel ``minh_fn``.  The inner
    loop runs while any row moves; the outer loop's progress is per row.

    Rows that finish (or stall) earlier are fixpoints of both loops, so
    the result is bit for bit the per-instance ``phase2_impl``'s on each
    row.  Returns ``(res, e, leftover (B,))``."""
    inner = _inner_rows(meta.n, s, t)

    def stranded(e):
        return torch.where(inner, e, 0).sum(dim=1, dtype=_I32)

    def heights(res, e):
        return gr.batched_residual_distances_impl(
            g, meta, batched_inflow(g, res0, res), s, minh_fn=minh_fn)[0]

    from repro_torch.core import batched

    flat = batched._flat(g, meta)  # loop-invariant, built once

    def cancel(res, height, e):
        return _batched_cancel_step(g, meta, flat, res0, res, height, e, s,
                                    t, minh_fn, scan)

    res, e = _drain(heights, cancel, res, e, stranded)
    leftover = stranded(e)
    t_col = t.long()[:, None]
    clean = torch.zeros_like(e).scatter_(1, t_col, torch.gather(e, 1, t_col))
    return res, clean, leftover


def convert_preflow_to_flow_device(r: ResidualCSR, state: pr.PRState,
                                   s: int, t: int,
                                   minh_fn: Callable | None = None,
                                   device=None) -> np.ndarray:
    """Host entry point for a single instance: run the device phase 2 on
    ``device`` (``None`` = the card) and return the corrected ``res``
    (int64 numpy, the host reference's convention).  ``state``'s arrays
    may be numpy arrays or tensors.  States with no stranded excess are
    returned untouched without device work.  ``minh_fn`` runs the height
    sweeps and the cancellation-arc selection on the min-search kernel
    (results are bit for bit identical)."""
    e = pr.host_array(state.e)
    inner = np.ones(r.n, bool)
    inner[[s, t]] = False
    if not (e[inner] > 0).any():  # already a genuine flow
        return pr.host_array(state.res).astype(np.int64)
    g, meta, res0 = pr.to_device(r, device)
    st = pr.state_from_numpy(pr.host_array(state.res),
                             np.zeros(r.n, np.int32), e, res0.device)
    res, _, leftover = phase2_impl(g, meta, res0, st.res, st.e, s, t,
                                   minh_fn=minh_fn)
    left = int(leftover)
    if left != 0:
        raise RuntimeError(
            f"phase 2 could not drain {left} units of excess back "
            "to the source — the state is not a valid preflow for this "
            "graph (excess must be flow-connected to s)")
    # the host entry point's result, after the drain's loops
    return res.cpu().numpy().astype(np.int64)  # lint-ok: host-sync, int64-state-cast
