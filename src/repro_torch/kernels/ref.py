"""Plain PyTorch versions of the min-search and reverse-search CUDA
kernels (port of the JAX package's ``repro.kernels.ref``).

The kernel wrappers run these for tensors on the CPU, and
``chip_smoke.py`` holds each kernel against them on the card.  Each
function takes the kernel's own inputs and repeats its arithmetic with
sync-free tensor ops; :func:`rev_search_ref` is the build-time ``rev``
table oracle the binary search must reproduce.
"""
from __future__ import annotations

import torch

INF = 2**30
_I32 = torch.int32
_INT32_MAX = torch.iinfo(torch.int32).max


def segment_min(values: torch.Tensor, segments: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_min``: per segment the minimum, int32-max where a
    segment is empty."""
    out = torch.full((num_segments,), _INT32_MAX, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, segments.long(), values, "amin")


def frontier_rows(deg: torch.Tensor, size: int) -> torch.Tensor:
    """``jnp.repeat(arange(q), deg, total_repeat_length=size)`` without a
    host read: entry ``i`` repeated ``deg[i]`` times, cut at ``size``.  The
    counts are cut so that they sum to exactly ``size``
    (``repeat_interleave`` requires it), one dummy entry ``q`` filling the
    tail past ``sum(deg)`` (where ``jnp.repeat`` repeats the last entry;
    every caller masks that tail)."""
    q = deg.shape[0]
    ends = torch.clamp(torch.cumsum(deg, 0, dtype=_I32), max=size)
    counts = torch.diff(ends, prepend=ends.new_zeros(1))
    return torch.repeat_interleave(
        torch.arange(q + 1, dtype=_I32, device=deg.device),
        torch.cat([counts, size - ends[-1:]]), output_size=size)


def min_neighbor_ref(avq: torch.Tensor, indptr: torch.Tensor,
                     key: torch.Tensor, *, n: int):
    """Plain ``segmin.tile_min_neighbor`` for one row: per queue entry the
    min key over its CSR segment and the smallest arc index attaining it,
    ``(INF, A)`` where ``u < 0``, ``u >= n`` or no key below INF exists.
    ``u < 0`` as a sentinel is the port's own extension: the JAX reference
    clamps ``u`` only from above, and its TPU kernel reads out of range
    there, so the two agree only on queues padded with ``n``, the
    reference's contract.  A flat frontier of every entry's arcs, reduced
    with two segmented mins.  As in the JAX
    package's version, the frontier holds at most ``A`` arcs: the entries
    below ``n`` must be distinct, as an AVQ's are (the kernel has no such
    limit)."""
    return min_neighbor_segments(avq, indptr[:-1], indptr[1:], key, n=n)


def min_neighbor_segments(avq: torch.Tensor, starts: torch.Tensor,
                          ends: torch.Tensor, key: torch.Tensor, *, n: int):
    """:func:`min_neighbor_ref` over segments ``starts[u]:ends[u]`` that
    need not tile the arc array — the batched core's B disjoint rows seen
    as one graph, where row ``b``'s arcs start at ``b * A_pad``."""
    a = key.shape[0]
    q = avq.shape[0]
    dev = key.device
    q_valid = (avq >= 0) & (avq < n)
    avq_c = torch.clamp(avq, 0, n - 1)
    lo = starts[avq_c]
    deg = torch.where(q_valid, ends[avq_c] - lo, 0)
    offs = torch.cumsum(deg, 0, dtype=_I32)
    first = offs - deg
    total = offs[-1:]
    pos = torch.arange(a, dtype=_I32, device=dev)
    row = frontier_rows(deg, a)
    fvalid = pos < total
    # past the frontier each position feeds (INF, A) to a row of its own:
    # no row's result changes, and no single row's atomic min is contended
    row = torch.where(fvalid, row, pos % q)
    arc = torch.clamp(lo[row] + (pos - first[row]), 0, a - 1)
    k = torch.where(fvalid, key[arc], INF)
    minh = segment_min(k, row, q)
    cand = torch.where(fvalid & (k == minh[row]) & (k < INF), arc, a)
    argarc = segment_min(cand, row, q)
    minh = torch.where(q_valid & (minh < INF), minh, INF)
    argarc = torch.where(minh < INF, argarc, a)
    return minh, argarc


def rev_search_bsearch_ref(arcs: torch.Tensor, indptr: torch.Tensor,
                           heads: torch.Tensor, tails: torch.Tensor, *,
                           steps: int) -> torch.Tensor:
    """Plain ``revsearch.bcsr_rev_search``, 1-D or ``(B, ·)`` rows: the
    kernel's ``steps`` lock-step halvings of a clamped lower-bound search
    for the push tail in the push head's segment; ``A`` where the arc is
    out of range or not found."""
    a = heads.shape[-1]
    take = (lambda x, i: x[i]) if arcs.ndim == 1 else \
        (lambda x, i: torch.gather(x, 1, i.long()))
    valid = (arcs >= 0) & (arcs < a)
    arc_c = torch.where(valid, arcs, 0)
    u = take(tails, arc_c)
    v = take(heads, arc_c)
    lo = take(indptr, v)
    hi = end = take(indptr, v + 1)
    for _ in range(steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        right = take(heads, torch.clamp(mid, max=a - 1)) < u
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(right, hi, mid)
    found = valid & (lo < end) & (take(heads, torch.clamp(lo, max=a - 1)) == u)
    return torch.where(found, lo, a)


def rev_search_ref(arcs: torch.Tensor, rev: torch.Tensor, a: int
                   ) -> torch.Tensor:
    """Oracle for ``revsearch.bcsr_rev_search``: the build-time rev table."""
    valid = arcs < a
    return torch.where(valid, rev[torch.clamp(arcs, max=a - 1)], a)
