"""Edit events for long-lived streaming graphs (a copy of the JAX
package's ``repro.streaming.events``; the port imports nothing of
``repro``).

Three structural-ish event shapes plus the existing relative
``repro_torch.api.CapacityUpdate``:

* :class:`EdgeInsert` — add a directed edge ``u -> v`` with capacity
  ``cap``.  If the coalesced arc pair already exists (the CSR always
  materialises *both* directions of a pair, including the zero-capacity
  one), this degrades to a capacity increase and stays on the pure
  warm-start path; only a genuinely new pair triggers a CSR rebuild
  (with the routed flow embedded — still warm, see
  ``streaming.stream.rebuild_with_state``).
* :class:`EdgeDelete` — remove ``u -> v``.  The arc pair is kept in the
  CSR (deleting would reindex every arc); the capacity is driven to
  zero and the overflowed flow rerouted, which is observationally
  identical.
* :class:`CapacityReweight` — set ``cap(u -> v)`` to an absolute value;
  normalised against the *current* capacity into a signed delta.

``normalize_events`` turns any mix of these (plus ``CapacityUpdate`` /
``(u, v, delta)`` tuples) into ``(structural_inserts, signed_deltas)``
against a concrete residual.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EdgeInsert:
    """Add directed edge ``u -> v`` with capacity ``cap >= 0``."""

    u: int
    v: int
    cap: int


@dataclasses.dataclass(frozen=True)
class EdgeDelete:
    """Remove directed edge ``u -> v`` (capacity driven to zero)."""

    u: int
    v: int


@dataclasses.dataclass(frozen=True)
class CapacityReweight:
    """Set ``cap(u -> v)`` to the absolute value ``cap >= 0``."""

    u: int
    v: int
    cap: int


def normalize_events(r, events):
    """Split an event mix into CSR-level work against residual ``r``.

    Returns ``(inserts, deltas)``: ``inserts`` is a list of
    ``(u, v, cap)`` for pairs absent from ``r`` (they need a CSR
    rebuild), ``deltas`` a list of ``(u, v, signed_delta)`` for existing
    arcs.  Events apply *sequentially*: a delete or re-weight is
    normalised against the capacity the earlier events in the same batch
    left behind, not the batch-start residual, so e.g. [reweight to 9,
    delete] nets to zero.  Raises ``KeyError`` for a delete/re-weight of
    a missing arc and ``ValueError`` for self-loops, out-of-range
    vertices or negative capacities.
    """
    from repro_torch.api.solution import CapacityUpdate
    from repro_torch.core.batched import find_arc

    if isinstance(events, (EdgeInsert, EdgeDelete, CapacityReweight,
                           CapacityUpdate)):
        events = [events]
    inserts: list[tuple[int, int, int]] = []
    deltas: list[tuple[int, int, int]] = []
    res0 = r.res0
    pending: dict[tuple[int, int], int] = {}  # net delta so far this batch
    new_pairs: set[frozenset] = set()  # pairs inserted earlier this batch

    def current_cap(u, v):
        """cap(u->v) after the events already normalised, KeyError if the
        arc is missing from ``r``."""
        if frozenset((u, v)) in new_pairs:
            raise ValueError(
                f"event on {u}->{v} follows its own insert within one "
                "batch; the pair does not exist yet — split the events "
                "into separate apply batches")
        return int(res0[find_arc(r, u, v)]) + pending.get((u, v), 0)

    def push(u, v, d):
        deltas.append((u, v, d))
        pending[(u, v)] = pending.get((u, v), 0) + d

    for ev in events:
        if isinstance(ev, EdgeInsert):
            u, v, cap = int(ev.u), int(ev.v), int(ev.cap)
            if cap < 0:
                raise ValueError(f"EdgeInsert({u}->{v}) with cap {cap} < 0")
            _check_pair(r.n, u, v)
            try:
                current_cap(u, v)  # raises on same-batch re-insert too
                find_arc(r, u, v)
            except KeyError:
                inserts.append((u, v, cap))
                new_pairs.add(frozenset((u, v)))
            else:
                push(u, v, cap)  # pair exists: pure increase
        elif isinstance(ev, EdgeDelete):
            u, v = int(ev.u), int(ev.v)
            # KeyError if missing, as documented
            push(u, v, -current_cap(u, v))
        elif isinstance(ev, CapacityReweight):
            u, v, cap = int(ev.u), int(ev.v), int(ev.cap)
            if cap < 0:
                raise ValueError(
                    f"CapacityReweight({u}->{v}) with cap {cap} < 0")
            push(u, v, cap - current_cap(u, v))
        elif isinstance(ev, CapacityUpdate):
            push(int(ev.u), int(ev.v), int(ev.delta))
        else:
            u, v, d = ev
            push(int(u), int(v), int(d))
    return inserts, deltas


def _check_pair(n: int, u: int, v: int) -> None:
    if u == v:
        raise ValueError(f"self-loop insert {u}->{v}")
    if not (0 <= u < n and 0 <= v < n):
        raise ValueError(
            f"insert {u}->{v} references a vertex outside 0..{n - 1} "
            "(streaming graphs have a fixed vertex set)")
