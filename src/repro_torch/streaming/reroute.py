"""Signed capacity updates on a corrected flow: the host half of the JAX
package's ``repro.streaming.reroute``.

A capacity decrease on arc ``(u, v)`` only invalidates the routed flow
when the arc carried more than the new capacity.  ``prepare_signed``
folds signed updates into the capacities, cancels the overflow
``o = flow - new_cap`` on each decreased arc and accounts the signed
per-vertex imbalance it leaves (``+o`` at ``u``, ``-o`` at ``v``).
Increases, and decreases that stay above the routed flow
(``overflow == 0``), need no drain: ``drain_prepared`` answers them
directly, and a warm re-solve budgeted by the increases' total recovers
maximality.  Draining an overflow on the device is the streaming slice
of ROADMAP.md Queue 1 and raises ``NotImplementedError`` until it is
ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import batched
from repro_torch.core.csr import ResidualCSR

#: where the device drain of an overflow waits
_DRAIN = ("draining a capacity decrease below the routed flow (overflow "
          "{}) needs the streaming tier's device drain, which is not "
          "ported yet (see ROADMAP.md Queue 1, 'Streaming')")


@dataclasses.dataclass
class RerouteResult:
    """Outcome of applying signed updates to a corrected flow."""

    residual: ResidualCSR  # updated capacities (res0)
    res: np.ndarray  # feasible flow on the new capacities (int32)
    e: np.ndarray  # zero everywhere but e[t] == value (int32)
    value: int  # flow value after the drain (pre-re-solve)
    budget: int  # warm re-solve budget; 0 => already maximal
    overflow: int  # units cancelled on decreased arcs
    rerouted: bool  # a device drain actually ran
    ok: bool  # False => drain stalled, caller must cold-solve


@dataclasses.dataclass
class PreparedReroute:
    """Host-side outcome of ``prepare_signed``: updated capacities plus
    the cancelled-overflow imbalance, staged for a device drain.
    ``overflow == 0`` means no drain is needed."""

    residual: ResidualCSR  # updated capacities (res0)
    res: np.ndarray  # int64 post-cancel pseudo-flow
    b: np.ndarray  # int64 signed per-vertex imbalance
    e: np.ndarray  # int64 corrected excess of the pre-update flow
    s: int
    t: int
    old_value: int
    inc_total: int
    overflow: int


def prepare_signed(r: ResidualCSR, res: np.ndarray, e: np.ndarray,
                   s: int, t: int, ups) -> PreparedReroute:
    """Fold ``(u, v, signed_delta)`` updates into the capacities, cancel
    overflow on decreased arcs and account the signed imbalance — NO
    device work.  Raises ``KeyError`` for a missing arc and
    ``ValueError`` for a capacity driven below zero."""
    res0 = np.asarray(r.res0, np.int64).copy()
    res = np.asarray(res, np.int64).copy()
    b = np.zeros(r.n, np.int64)
    inc_total = 0
    overflow = 0
    for u, v, delta in ups:
        a = batched.find_arc(r, u, v)
        if delta >= 0:
            res0[a] += delta
            res[a] += delta
            inc_total += delta
            continue
        c_new = res0[a] + delta
        if c_new < 0:
            raise ValueError(
                f"capacity of {u}->{v} would go negative "
                f"({int(res0[a])} {delta:+d})")
        f = res0[a] - res[a]  # current flow on the arc (negative: reverse)
        o = max(0, int(f - c_new))
        res0[a] = c_new
        res[a] += delta + o  # == c_new - min(f, c_new): never negative
        if o:
            res[r.rev[a]] -= o  # cancelled flow returns its reverse slack
            b[u] += o  # tail keeps units it can no longer forward
            b[v] -= o  # head no longer receives them
            overflow += o
    b[s] = 0  # the source absorbs/supplies freely; never an imbalance
    return PreparedReroute(
        residual=dataclasses.replace(r, res0=res0), res=res, b=b,
        e=np.asarray(e, np.int64).copy(), s=s, t=t, old_value=int(e[t]),
        inc_total=inc_total, overflow=overflow)


def _no_drain_result(prep: PreparedReroute) -> RerouteResult:
    """Pure increases (or slack-only decreases): no device drain."""
    return RerouteResult(
        residual=prep.residual,
        res=batched.as_state_dtype(prep.res, "updated res"),
        e=batched.as_state_dtype(prep.e, "updated excess"),
        value=prep.old_value, budget=prep.inc_total, overflow=0,
        rerouted=False, ok=True)


def drain_prepared(preps: list[PreparedReroute]) -> list[RerouteResult]:
    """Answer prepared updates: each overflow-free preparation without
    device work.  A preparation with ``overflow > 0`` needs the device
    drain and raises ``NotImplementedError`` (ROADMAP.md Queue 1,
    'Streaming')."""
    for prep in preps:
        if prep.overflow:
            raise NotImplementedError(_DRAIN.format(prep.overflow))
    return [_no_drain_result(prep) for prep in preps]
