"""Min-height neighbour search per queue entry: the CUDA kernel
``csrc/segmin.cu`` behind the JAX package's ``tile_min_neighbor``
signature.

For each queue entry ``u`` the wrapper returns the minimum ``key`` over
``u``'s arcs ``indptr[u]:indptr[u+1]`` and the smallest arc attaining it,
``(INF, A)`` where ``u >= n``, the segment is empty or every key is INF.
``avq=None`` is the dense form (every vertex its own entry, bit for bit
``avq == arange(n)``), the shape of the Bellman-Ford sweeps.  1-D inputs
are one instance; ``(B, ·)`` rows are one launch with the batch on
``grid.y``.

CUDA tensors launch the kernel on the current stream (or raise); CPU
tensors take the plain version, :func:`repro_torch.kernels.ref.
min_neighbor_ref`.  ``tile_min_neighbor.launches`` counts kernel launches,
``tile_min_neighbor.dense_launches`` those of the dense form.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as kref
from repro_torch.kernels.runtime import check_operand

INF = kref.INF


def tile_min_neighbor(avq: torch.Tensor | None, indptr: torch.Tensor,
                      key: torch.Tensor, *, n: int):
    """Per-queue-entry ``(min key, argmin arc)`` over CSR segments.

    Single instance: ``avq (Q,)`` padded with ``n``, ``indptr (n+1,)``,
    ``key (A,)``.  Batched: ``avq (B, Q)``, ``indptr (B, n+1)``,
    ``key (B, A)``.  ``avq=None``: dense form, ``Q = n``.  Returns int32
    ``(minh, argarc)`` of shape ``(Q,)`` / ``(B, Q)``."""
    single = key.ndim == 1
    if key.ndim not in (1, 2):
        raise ValueError(f"key must be (A,) or (B, A), got {tuple(key.shape)}")
    lead = () if single else (key.shape[0],)
    a = key.shape[-1]
    q = n if avq is None else avq.shape[-1]
    check_operand("key", key, lead + (a,), key.device)
    check_operand("indptr", indptr, lead + (n + 1,), key.device)
    if avq is not None:
        check_operand("avq", avq, lead + (q,), key.device)
    if key.device.type == "cpu":
        return tile_min_neighbor_plain(avq, indptr, key, n=n)
    if key.device.type != "cuda":
        raise ValueError(f"unsupported device {key.device}")
    minh = torch.empty(lead + (q,), dtype=torch.int32, device=key.device)
    argarc = torch.empty_like(minh)
    fn = build.entry("segmin")
    with torch.cuda.device(key.device):
        code = fn(None if avq is None else avq.data_ptr(), indptr.data_ptr(),
                  key.data_ptr(), minh.data_ptr(), argarc.data_ptr(),
                  1 if single else key.shape[0], q, n, a,
                  torch.cuda.current_stream(key.device).cuda_stream)
    build.check(code, "tile_min_neighbor")
    tile_min_neighbor.launches += 1
    if avq is None:
        tile_min_neighbor.dense_launches += 1
    return minh, argarc


tile_min_neighbor.launches = 0  # kernel launches, both forms
tile_min_neighbor.dense_launches = 0  # of which with avq=None


def tile_min_neighbor_plain(avq, indptr, key, *, n):
    """The plain PyTorch version of the kernel (row by row for ``(B, ·)``
    inputs), on whatever device the tensors are."""
    if key.ndim == 1:
        if avq is None:
            avq = torch.arange(n, dtype=torch.int32, device=key.device)
        return kref.min_neighbor_ref(avq, indptr, key, n=n)
    rows = [tile_min_neighbor_plain(None if avq is None else avq[i],
                                    indptr[i], key[i], n=n)
            for i in range(key.shape[0])]
    return (torch.stack([m for m, _ in rows]),
            torch.stack([g for _, g in rows]))

