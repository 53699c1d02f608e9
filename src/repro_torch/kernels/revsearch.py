"""BCSR reverse-arc lookup by binary search (paper §3.2): the CUDA kernel
``csrc/revsearch.cu`` behind the JAX package's ``bcsr_rev_search``
signature.

For each push arc ``a = (u -> v)`` the wrapper returns the arc ``v -> u``,
found by ``max(1, deg_max.bit_length())`` lock-step halvings of a
lower-bound search for ``u`` in ``v``'s head-sorted segment; ``A`` where
``a`` is outside ``[0, A)`` or the arc is not found.  1-D inputs are one
instance; ``(B, ·)`` rows are one launch with the batch on ``grid.y``.

No solver path calls this entry: the paper-faithful cycle runs the same
search (``csrc/revsearch.cuh``) inside the min search's rev entry,
``segmin.tile_min_neighbor_gather_rev``.  It stays as the TPU kernel's own
function, the yardstick of that fold.

CUDA tensors launch the kernel on the current stream (or raise); CPU
tensors take the plain version, :func:`repro_torch.kernels.ref.
rev_search_bsearch_ref`.  ``bcsr_rev_search.launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as kref
from repro_torch.kernels.runtime import census_launch, check_operand


def search_steps(deg_max: int) -> int:
    """Lock-step halvings that resolve any segment of ``deg_max`` arcs."""
    return max(1, int(deg_max).bit_length())


def bcsr_rev_search(arcs: torch.Tensor, indptr: torch.Tensor,
                    heads: torch.Tensor, tails: torch.Tensor, *,
                    deg_max: int) -> torch.Tensor:
    """Reverse arc of each push arc.  Single instance: ``arcs (P,)``,
    ``indptr (n+1,)``, ``heads``/``tails (A,)``.  Batched: ``arcs (B, P)``
    with ``(B, ·)`` graph rows.  Returns int32 of ``arcs``' shape."""
    if arcs.ndim not in (1, 2):
        raise ValueError(f"arcs must be (P,) or (B, P), got "
                         f"{tuple(arcs.shape)}")
    lead = tuple(arcs.shape[:-1])
    n = indptr.shape[-1] - 1
    a = heads.shape[-1]
    check_operand("arcs", arcs, tuple(arcs.shape), arcs.device)
    check_operand("indptr", indptr, lead + (n + 1,), arcs.device)
    check_operand("heads", heads, lead + (a,), arcs.device)
    check_operand("tails", tails, lead + (a,), arcs.device)
    steps = search_steps(deg_max)
    if arcs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {arcs.device}")
    rows = lead[0] if lead else 1
    with census_launch("bcsr_rev_search", rows, arcs.shape[-1]):
        if arcs.device.type == "cpu":
            return kref.rev_search_bsearch_ref(arcs, indptr, heads, tails,
                                               steps=steps)
        out = torch.empty_like(arcs)
        fn = build.entry("revsearch", "bcsr_rev_search_launch")
        with torch.cuda.device(arcs.device):
            code = fn(arcs.data_ptr(), indptr.data_ptr(), heads.data_ptr(),
                      tails.data_ptr(), out.data_ptr(), rows, arcs.shape[-1],
                      n, a, steps,
                      torch.cuda.current_stream(arcs.device).cuda_stream)
        build.check(code, "bcsr_rev_search")
    bcsr_rev_search.launches += 1
    return out


bcsr_rev_search.launches = 0
