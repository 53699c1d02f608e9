"""The solver's hooks onto the CUDA kernels (port of the JAX package's
``repro.kernels.ops``).

Each wrapper launches its kernel for CUDA tensors and takes the plain
PyTorch version for CPU tensors, so these hooks need no device argument.
"""
from __future__ import annotations

from repro_torch.kernels.segmin import (tile_min_neighbor_gather,
                                        tile_min_neighbor_gather_rev)


def min_neighbor_kernel(g, meta, state, avq, q_valid):
    """Drop-in for ``pushrelabel._flat_frontier_minh`` backed by the
    min-search kernel (the paper's faithful VC mode), which forms the key
    ``where(res > 0, h[heads], INF)`` per arc itself: no key array is
    built.  Returns ``(minh, argarc)`` with the ``argarc == A`` sentinel
    where no eligible arc exists — the flat path's sentinel.

    Serves 1-D states (``g`` holds ``(n+1,)``/``(A,)`` rows) and batched
    ``(B, ·)`` states in one launch (row ``b``'s heads index row ``b`` of
    ``h``, clamped for the padded arcs).  ``avq=None`` is the dense
    every-vertex form the distance sweeps use."""
    return tile_min_neighbor_gather(avq, g.indptr, g.heads, state.res,
                                    state.h, n=meta.n)


def min_neighbor_minh_fn():
    """The ``minh_fn`` hook of the kernel modes, shared by the cycle step
    and the global relabel's sweeps."""
    return min_neighbor_kernel


def min_neighbor_rev_kernel(g, meta, state, avq, q_valid):
    """The paper-faithful BCSR cycle's search (``vc_kernel_bsearch``):
    :func:`min_neighbor_kernel` and, in the same launch of the min
    search's rev entry, the reverse arc of each entry that pushes, found by
    the BCSR binary search.  Returns ``(minh, argarc, rev)``, ``rev == A``
    where the entry does not push or the arc is not found, which
    ``pushrelabel._decide_apply`` takes as it is.  AVQ form only; 1-D or
    batched ``(B, ·)`` states, as :func:`min_neighbor_kernel`."""
    if meta.layout not in ("bcsr", "batched-bcsr"):
        raise ValueError(
            f"binary search requires head-sorted (bcsr) segments, got "
            f"layout {meta.layout!r}")
    return tile_min_neighbor_gather_rev(avq, g.indptr, g.heads, g.tails,
                                        state.res, state.h, n=meta.n,
                                        deg_max=meta.deg_max)
