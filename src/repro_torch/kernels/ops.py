"""The solver's hooks onto the CUDA kernels (port of the JAX package's
``repro.kernels.ops``).

Each wrapper launches its kernel for CUDA tensors and takes the plain
PyTorch version for CPU tensors, so these hooks need no device argument.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as kref
from repro_torch.kernels.revsearch import bcsr_rev_search
from repro_torch.kernels.segmin import tile_min_neighbor

INF = kref.INF


def min_neighbor_kernel(g, meta, state, avq, q_valid):
    """Drop-in for ``pushrelabel._flat_frontier_minh`` backed by the
    warp-per-vertex kernel (the paper's faithful VC mode).  Returns
    ``(minh, argarc)`` with the ``argarc == A`` sentinel where no eligible
    arc exists — the flat path's sentinel.

    Serves 1-D states (``g`` holds ``(n+1,)``/``(A,)`` rows) and batched
    ``(B, ·)`` states in one launch.  ``avq=None`` is the dense
    every-vertex form the distance sweeps use."""
    if state.h.ndim == 2:  # batched rows: per-row gather of h[heads]
        hh = torch.gather(state.h, 1,
                          torch.clamp(g.heads, 0, meta.n - 1).long())
    else:
        hh = state.h[g.heads]
    key = torch.where(state.res > 0, hh, INF)
    return tile_min_neighbor(avq, g.indptr, key, n=meta.n)


def min_neighbor_minh_fn():
    """The ``minh_fn`` hook of the kernel modes, shared by the cycle step
    and the global relabel's sweeps."""
    return min_neighbor_kernel


def rev_lookup_bsearch(g, meta, arcs):
    """Reverse-arc lookup via the paper's BCSR binary search kernel."""
    if meta.layout != "bcsr":
        raise ValueError(
            f"binary search requires head-sorted (bcsr) segments, got "
            f"layout {meta.layout!r}")
    return bcsr_rev_search(arcs, g.indptr, g.heads, g.tails,
                           deg_max=meta.deg_max)


def rev_lookup_table(g, meta, arcs):
    """Beyond-paper variant: precomputed rev index (O(E) ints, no search)."""
    return kref.rev_search_ref(arcs, g.rev, g.heads.shape[0])
