"""Min-height neighbour search per queue entry: the CUDA kernel
``csrc/segmin.cu`` behind the JAX package's ``tile_min_neighbor``
signature, and a second entry that forms the key itself.

For each queue entry ``u`` the wrappers return the minimum key over
``u``'s arcs ``indptr[u]:indptr[u+1]`` and the smallest arc attaining it,
``(INF, A)`` where ``u < 0`` or ``u >= n``, the segment is empty or every
key is INF.  :func:`tile_min_neighbor` reads the key from an array (the
TPU kernel's function); :func:`tile_min_neighbor_gather` forms it per arc
as ``res > 0 ? h[clamp(heads, 0, n-1)] : INF``, the solver's key, without
writing a key array.  ``avq=None`` is the dense form (every vertex its
own entry, bit for bit ``avq == arange(n)``), the shape of the
Bellman-Ford sweeps.  1-D inputs are one instance; ``(B, ·)`` rows are one
launch with the batch on ``grid.y``.

CUDA tensors launch the kernel on the current stream (or raise); CPU
tensors take the plain versions.  Each entry counts its own launches, and
no other's: ``.launches`` all of them, ``.dense_launches`` those of the
dense form.  The solver calls only the gather entry (``ops.py``); the
key-in entry is the TPU kernel's function, timed against ``scatter_reduce``
and the gather entry's oracle on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as kref
from repro_torch.kernels.runtime import check_operand

INF = kref.INF


def _launch(symbol, avq, indptr, arrays, *, lead, q, n, a, dev):
    """Launch ``symbol`` of ``csrc/segmin.cu`` on ``(avq|NULL, indptr,
    *arrays)``; returns ``(minh, argarc)``."""
    minh = torch.empty(lead + (q,), dtype=torch.int32, device=dev)
    argarc = torch.empty_like(minh)
    fn = build.entry("segmin", symbol)
    with torch.cuda.device(dev):
        code = fn(None if avq is None else avq.data_ptr(), indptr.data_ptr(),
                  *(x.data_ptr() for x in arrays), minh.data_ptr(),
                  argarc.data_ptr(), lead[0] if lead else 1, q, n, a,
                  torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, symbol)
    return minh, argarc


def _check(avq, indptr, arcs, n):
    """Check the operands common to both entries against the arc-sized
    ``arcs``; returns ``(lead, q, a, device)``."""
    if arcs.ndim not in (1, 2):
        raise ValueError(f"arc arrays must be (A,) or (B, A), got "
                         f"{tuple(arcs.shape)}")
    lead = tuple(arcs.shape[:-1])
    a = arcs.shape[-1]
    q = n if avq is None else avq.shape[-1]
    check_operand("indptr", indptr, lead + (n + 1,), arcs.device)
    if avq is not None:
        check_operand("avq", avq, lead + (q,), arcs.device)
    if arcs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {arcs.device}")
    return lead, q, a, arcs.device


def tile_min_neighbor(avq: torch.Tensor | None, indptr: torch.Tensor,
                      key: torch.Tensor, *, n: int):
    """Per-queue-entry ``(min key, argmin arc)`` over CSR segments.

    Single instance: ``avq (Q,)`` padded with ``n``, ``indptr (n+1,)``,
    ``key (A,)``.  Batched: ``avq (B, Q)``, ``indptr (B, n+1)``,
    ``key (B, A)``.  ``avq=None``: dense form, ``Q = n``.  Returns int32
    ``(minh, argarc)`` of shape ``(Q,)`` / ``(B, Q)``."""
    lead, q, a, dev = _check(avq, indptr, key, n)
    check_operand("key", key, lead + (a,), dev)
    if dev.type == "cpu":
        return tile_min_neighbor_plain(avq, indptr, key, n=n)
    out = _launch("tile_min_neighbor_launch", avq, indptr, (key,),
                  lead=lead, q=q, n=n, a=a, dev=dev)
    tile_min_neighbor.launches += 1
    if avq is None:
        tile_min_neighbor.dense_launches += 1
    return out


tile_min_neighbor.launches = 0  # key-in launches, both forms
tile_min_neighbor.dense_launches = 0  # of which with avq=None


def tile_min_neighbor_gather(avq: torch.Tensor | None, indptr: torch.Tensor,
                             heads: torch.Tensor, res: torch.Tensor,
                             h: torch.Tensor, *, n: int):
    """:func:`tile_min_neighbor` over the key ``where(res > 0,
    h[clamp(heads, 0, n-1)], INF)``, formed per arc inside the kernel.

    ``heads``/``res`` are ``(A,)`` or ``(B, A)``, ``h`` is ``(n,)`` or
    ``(B, n)`` (row ``b``'s heads index row ``b`` of ``h``); the rest as
    :func:`tile_min_neighbor`."""
    lead, q, a, dev = _check(avq, indptr, res, n)
    check_operand("res", res, lead + (a,), dev)
    check_operand("heads", heads, lead + (a,), dev)
    check_operand("h", h, lead + (n,), dev)
    if dev.type == "cpu":
        return tile_min_neighbor_gather_plain(avq, indptr, heads, res, h, n=n)
    out = _launch("tile_min_neighbor_gather_launch", avq, indptr,
                  (heads, res, h), lead=lead, q=q, n=n, a=a, dev=dev)
    tile_min_neighbor_gather.launches += 1
    if avq is None:
        tile_min_neighbor_gather.dense_launches += 1
    return out


tile_min_neighbor_gather.launches = 0  # gather-entry launches, both forms
tile_min_neighbor_gather.dense_launches = 0  # of which with avq=None


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


def tile_min_neighbor_gather_plain(avq, indptr, heads, res, h, *, n):
    """The plain version of the gather entry: the key built with two
    tensor ops, then :func:`tile_min_neighbor_plain`."""
    hh = torch.gather(h, -1, torch.clamp(heads, 0, n - 1).long())
    key = torch.where(res > 0, hh, INF)
    return tile_min_neighbor_plain(avq, indptr, key, n=n)
