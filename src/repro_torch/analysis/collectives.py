"""Collective bytes on the wire, from a census's ``c10d`` records (the
port of ``repro.analysis.hlo``).

The reference parses the compiled HLO for its collectives.  Eager PyTorch
issues each one as a ``c10d`` op, which the census records with the
tensor it moves and its group's size (:class:`~repro_torch.analysis.ir.
Collective`).  Each kind contributes its on-wire bytes per device, by the
reference's formulas, from the result's bytes ``out`` and the group size
``g`` (at least 2, as the reference takes it)::

    all-gather         out * (g-1)/g        (ring, out = full gathered)
    all-reduce         2 * out * (g-1)/g    (reduce-scatter + all-gather)
    reduce-scatter     out * (g-1)          (input = out * g)
    all-to-all         out * (g-1)/g
    collective-permute out                  (a send)

``cost_summary``, the reference's flops/bytes/memory summary of a
compiled executable, has no counterpart: eager PyTorch compiles no
executable to ask.
"""
from __future__ import annotations

import warnings
from collections import defaultdict

from repro_torch.analysis.ir import Collective, OpCensus

__all__ = ["GroupSizeError", "wire_bytes", "collective_bytes"]


class GroupSizeError(ValueError):
    """A collective whose group size the census could not read: guessing
    one would mis-state its wire bytes, so strict mode refuses.
    ``.record`` carries the offender."""

    def __init__(self, record: Collective):
        self.record = record
        super().__init__(
            f"the group size of {record.op} at {record.origin} is unknown "
            "(wire-byte accounting would be wrong)")


def wire_bytes(kind: str, nbytes: float, group_size: int) -> float:
    """On-wire bytes per device of one collective of ``kind`` whose result
    holds ``nbytes``, over a group of ``group_size``."""
    g = max(2, group_size)
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (g - 1)
    if kind == "all-to-all":
        return nbytes * (g - 1) / g
    if kind == "collective-permute":
        return nbytes
    raise ValueError(f"unknown collective kind {kind!r}")


def collective_bytes(census: OpCensus | list[Collective],
                     strict: bool = True) -> dict:
    """Per-kind on-wire bytes per device and counts, in the reference's
    shape (``total_bytes``, ``by_op``, ``counts``).  Collectives of no
    counted kind (a barrier, a receive) are skipped.  ``strict=True``
    raises :class:`GroupSizeError` on a record of unknown group size;
    ``strict=False`` takes 2, with a warning."""
    records = census.collectives if isinstance(census, OpCensus) else census
    out_bytes: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    for c in records:
        if c.kind is None:
            continue
        g = c.group_size
        if g is None and c.kind != "collective-permute":
            if strict:
                raise GroupSizeError(c)
            warnings.warn(f"unknown group size of {c.op} at {c.origin}; "
                          "assuming 2 (may UNDERCOUNT wire bytes)",
                          stacklevel=2)
        out_bytes[c.kind] += wire_bytes(c.kind, c.nbytes, g or 2)
        counts[c.kind] += 1
    return {"total_bytes": sum(out_bytes.values()), "by_op": dict(out_bytes),
            "counts": dict(counts)}
