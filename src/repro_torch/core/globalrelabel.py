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


def distance_sweep(g, meta, res, t: int, minh_fn=None):
    """``(sweep, dist0)``: one Bellman-Ford sweep toward ``t`` over the
    residual arcs of ``res``, and the starting distances (0 at ``t``, INF
    elsewhere).

    ``minh_fn`` (the hook shared with ``pushrelabel.vc_step``, e.g.
    ``repro_torch.kernels.ops.min_neighbor_minh_fn()``) runs the sweep's
    segmented min on the CUDA kernel instead of ``scatter_reduce``;
    results are identical (both take the exact min over each segment).
    """
    from repro_torch.core import pushrelabel as pr

    n = meta.n
    dist0 = engine.fill_at(
        torch.full((n,), INF, dtype=torch.int32, device=res.device), t, 0)
    tails = g.tails.long() if minh_fn is None else None

    def sweep(dist):
        if minh_fn is None:
            dh = dist[g.heads]
            key = torch.where((res > 0) & (dh < INF), dh + 1, INF)
            cand = segment_min(key, tails, n)
        else:
            # the kernel computes key = where(res > 0, h[heads], INF);
            # feeding h' = min(dist + 1, INF) reproduces the sweep's key
            # exactly (dist is INF-saturated, and INF + 1 < int32 max).
            # avq=None: the dense every-vertex kernel form
            pseudo = pr.PRState(res=res,
                                h=torch.clamp(dist + 1, max=INF), e=None)
            cand, _ = minh_fn(g, meta, pseudo, None, None)
        return engine.fill_at(torch.minimum(dist, cand), t, 0)

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
