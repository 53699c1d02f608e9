"""Global-relabel heuristic (paper Alg. 1 step 2); port of the JAX
package's ``repro.core.globalrelabel`` for one instance.

A backward BFS from the sink over the residual graph reassigns every height
to the exact residual distance-to-sink.  Vectorised as Bellman-Ford-style
sweeps — each sweep is one segmented min over the arc array (the same
primitive as the vertex-centric min-height search, and executable by the
same CUDA kernel) — iterated to fixpoint through the sweep engine
(``repro_torch.core.engine.run_to_fixpoint``; #sweeps = residual-graph
eccentricity of t).

Vertices that cannot reach the sink get h = n and are thereby deactivated;
their stranded excess is the paper's ``Excess_total`` deduction (line 6 /
§2.2) — max-flow value is then e(t).
"""
from __future__ import annotations

import torch

from repro_torch.core import engine
from repro_torch.kernels.ref import INF, segment_min


def sweep_candidates(g, meta, res, minh_fn=None):
    """``cand(dist)``: the heart of one Bellman-Ford sweep over the
    residual arcs of ``res`` — per vertex the least ``dist[head] + 1``
    over its arcs with ``res > 0`` (INF where none), for 1-D ``(n,)``
    distances of one instance.

    ``minh_fn`` (the hook shared with ``pushrelabel.vc_step``, e.g.
    ``repro_torch.kernels.ops.min_neighbor_minh_fn()``) runs the
    segmented min on the CUDA kernel instead of ``scatter_reduce``;
    results are identical (both take the exact min over each segment)."""
    from repro_torch.core import pushrelabel as pr

    if minh_fn is not None:
        def cand(dist):
            # the kernel computes key = where(res > 0, h[heads], INF);
            # feeding h' = min(dist + 1, INF) reproduces the sweep's key
            # exactly (dist is INF-saturated, and INF + 1 < int32 max).
            # avq=None: the dense every-vertex kernel form
            pseudo = pr.PRState(res=res,
                                h=torch.clamp(dist + 1, max=INF), e=None)
            return minh_fn(g, meta, pseudo, None, None)[0]
        return cand
    tails = g.tails.long()

    def cand(dist):
        dh = dist[g.heads]
        key = torch.where((res > 0) & (dh < INF), dh + 1, INF)
        return segment_min(key, tails, meta.n)
    return cand


def distance_sweep(g, meta, res, t: int, minh_fn=None):
    """``(sweep, dist0)``: one Bellman-Ford sweep toward ``t`` over the
    residual arcs of ``res`` (:func:`sweep_candidates`), and the starting
    distances (0 at ``t``, INF elsewhere)."""
    cand = sweep_candidates(g, meta, res, minh_fn)
    dist0 = engine.fill_at(
        torch.full((meta.n,), INF, dtype=torch.int32, device=res.device),
        t, 0)

    def sweep(dist):
        return engine.fill_at(torch.minimum(dist, cand(dist)), t, 0)

    return sweep, dist0


def residual_distances_impl(g, meta, res, t: int, minh_fn=None):
    """Exact distance-to-t over residual arcs, via sweeps
    (:func:`distance_sweep`) to fixpoint.  Returns ``(dist, sweeps)``."""
    sweep, dist0 = distance_sweep(g, meta, res, t, minh_fn=minh_fn)
    return engine.run_to_fixpoint(sweep, dist0, cap=meta.n)


def global_relabel_impl(g, meta, state, s: int, t: int, minh_fn=None):
    """Reassign heights to exact residual distances; deactivate unreachable
    vertices.  Returns ``(new_state, active_count, sweeps)``, the last two
    as 0-d int32 tensors (``sweeps`` is the Bellman-Ford iteration count
    of the distance fixpoint).  ``minh_fn`` routes the distance sweeps
    through the CUDA kernel (see ``residual_distances_impl``)."""
    from repro_torch.core import pushrelabel as pr

    n = meta.n
    dist, sweeps = residual_distances_impl(g, meta, state.res, t,
                                           minh_fn=minh_fn)
    h = engine.fill_at(torch.where(dist < INF, dist, n), s, n)
    new_state = pr.PRState(res=state.res, h=h, e=state.e)
    nact = pr.active_mask(new_state, n, s, t).sum(dtype=torch.int32)
    return new_state, nact, sweeps


def batched_sweep_candidates(g, meta, res, minh_fn=None):
    """Batch-level :func:`sweep_candidates`: ``g`` holds stacked
    ``(B, n+1)``/``(B, A)`` rows, ``res`` is ``(B, A)`` and ``cand(dist)``
    takes ``(B, n)`` distances.  Each call is ONE segmented min over the
    whole batch: ``minh_fn=None`` runs ``scatter_reduce`` over the batch
    as one graph of B disjoint rows (row ``b``'s vertex ``v`` is
    ``b * n + v``), a kernel ``minh_fn`` a single launch of the min
    search with the batch on ``grid.y``."""
    from repro_torch.core import pushrelabel as pr

    if minh_fn is not None:
        def cand(dist):
            pseudo = pr.PRState(res=res,
                                h=torch.clamp(dist + 1, max=INF), e=None)
            return minh_fn(g, meta, pseudo, None, None)[0]
        return cand
    n = meta.n
    bsz = res.shape[0]
    voff = torch.arange(bsz, device=res.device)[:, None] * n
    flat_tails = (g.tails.long() + voff).view(-1)
    heads = g.heads.long()

    def cand(dist):
        dh = torch.gather(dist, 1, heads)
        key = torch.where((res > 0) & (dh < INF), dh + 1, INF)
        return segment_min(key.view(-1), flat_tails, bsz * n).view(bsz, n)
    return cand


def batched_residual_distances_impl(g, meta, res, t, minh_fn=None):
    """Batch-level form of :func:`residual_distances_impl`: ``t`` is a
    ``(B,)`` tensor, each sweep one segmented min over the whole batch
    (:func:`batched_sweep_candidates`).

    The sweep loop runs until EVERY row reaches its fixpoint; rows that
    converge earlier are fixpoints of the sweep (``min`` is idempotent),
    so the result is bit for bit what per-instance loops produce.
    Returns ``(dist (B, n), sweeps)``."""
    cand = batched_sweep_candidates(g, meta, res, minh_fn)
    t_col = t.long()[:, None]
    dist0 = torch.full((res.shape[0], meta.n), INF, dtype=torch.int32,
                       device=res.device).scatter_(1, t_col, 0)

    def sweep(dist):
        return torch.minimum(dist, cand(dist)).scatter_(1, t_col, 0)

    return engine.run_to_fixpoint(sweep, dist0, cap=meta.n)


def batched_global_relabel_impl(g, meta, state, s, t, minh_fn=None):
    """Batch-level global relabel over stacked rows: one distance-sweep
    loop (:func:`batched_residual_distances_impl`) serves the whole
    batch.  ``s``/``t`` are ``(B,)`` tensors; returns ``(new_state, nact
    (B,), sweeps)`` bit for bit equal to :func:`global_relabel_impl` on
    each row (``sweeps`` is the shared fixpoint's count — the max over
    instances)."""
    from repro_torch.core import batched
    from repro_torch.core import pushrelabel as pr

    n = meta.n
    dist, sweeps = batched_residual_distances_impl(g, meta, state.res, t,
                                                   minh_fn=minh_fn)
    h = torch.where(dist < INF, dist, n).scatter_(1, s.long()[:, None], n)
    new_state = pr.PRState(res=state.res, h=h, e=state.e)
    act = batched.active_rows(h, state.e, n, s, t)
    return new_state, act.sum(dim=1, dtype=torch.int32), sweeps
