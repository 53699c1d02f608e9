"""Minimum s-t cut extraction (the paper solves "maximum flow/minimum
cut"); port of the JAX package's ``repro.core.mincut``.

After the solver terminates and the preflow is converted to a flow, the
set S of vertices residually reachable from s defines a minimum cut; the
crossing arcs are all saturated and their capacity equals the max flow
(max-flow = min-cut).  The reference finds S with a host BFS, one pass
over the arcs per level; here S is found on the device as the vertices at
a finite distance from ``s`` over arcs with residual — the distance
sweeps of ``globalrelabel.residual_distances_impl`` over ``res[rev]``
(the dense form of the min-search kernel under a kernel ``minh_fn``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import globalrelabel as gr
from repro_torch.core import pushrelabel as pr
from repro_torch.core.csr import ResidualCSR
from repro_torch.kernels.ref import INF


@dataclasses.dataclass(frozen=True)
class MinCut:
    value: int
    source_side: np.ndarray  # bool mask over vertices
    cut_arcs: np.ndarray  # arc ids crossing S -> T (all saturated)

    @property
    def cut_edges(self):
        return self.cut_arcs


def min_cut(r: ResidualCSR, state: pr.PRState, s: int, t: int,
            corrected: bool = False, reference: bool = False,
            use_kernel: bool = False, device=None) -> MinCut:
    """``corrected=True`` skips phase 2 when ``state.res`` is already a
    genuine flow (e.g. from ``WarmStartHandle.arrays``); otherwise the
    device phase 2 corrects it first (``reference=True`` for the host-BFS
    oracle).  The reach sweeps run on ``device`` (``None`` = the card),
    on the min-search kernel with ``use_kernel``.  ``state``'s arrays may
    be numpy arrays or tensors."""
    if corrected:
        res = pr.host_array(state.res)
    else:
        res = pr.convert_preflow_to_flow(r, state, s, t,
                                         reference=reference,
                                         use_kernel=use_kernel,
                                         device=device)
    g, meta, _ = pr.to_device(r, device)
    minh_fn = None
    if use_kernel:
        from repro_torch.kernels import ops as kops

        minh_fn = kops.min_neighbor_minh_fn()
    res_d = torch.from_numpy(pr.as_int32(res, "residual")).to(
        g.heads.device)
    # w is reachable iff w lies at a finite distance from s over the arcs
    # b out of w whose reverse rev[b] (into w) has residual
    dist, _ = gr.residual_distances_impl(g, meta, res_d[g.rev], s,
                                         minh_fn=minh_fn)
    # the cut is a host result: one read after the sweeps' loop
    reach = (dist < INF).cpu().numpy()  # lint-ok: host-sync
    if reach[t]:  # not an assert: must survive python -O
        raise RuntimeError(
            "sink is residually reachable from the source — the state is "
            "not an optimal flow, so no min cut exists for it")
    heads, tails = np.asarray(r.heads), np.asarray(r.tails)
    crossing = np.nonzero(reach[tails] & ~reach[heads])[0]
    value = int(np.asarray(r.res0)[crossing].sum()
                - res[crossing].astype(np.int64).sum())  # lint-ok: int64-state-cast
    return MinCut(value=value, source_side=reach,
                  cut_arcs=crossing.astype(np.int64))


def solve_min_cut(r: ResidualCSR, s: int, t: int, mode: str = "vc",
                  device=None):
    """Convenience: full solve + cut extraction on ``device`` (``None`` =
    the card).  Returns ``(maxflow, MinCut)``."""
    from repro_torch.api import MinCutProblem, Solver, SolverOptions

    sol = Solver(SolverOptions(mode=mode, layout=r.layout,
                               device=device)).solve(
        MinCutProblem.from_residual(r, s, t))
    return sol.value, sol.min_cut()
