"""Device-side solver telemetry: int32 workload counters that ride the
cycle loops' carries (port of the JAX package's
``repro.obs.solvercounters``).

The paper's workload analysis (Fig. 3) needs *per-cycle* active-vertex
and scanned-arc counts.  Reading them on the host every cycle would
serialise the solve, so the counters are folded into the carries of
``pushrelabel.run_cycles`` / ``batched.batched_run_cycles`` (and, for
``vc_fused``, into the fused discharge kernel's own outputs): they are
computed on the device and read once per round.

Counter definitions (identical across every mode, because the state
sequences are bit-for-bit identical and every active vertex performs
exactly one push or one relabel per bulk-synchronous cycle):

* ``active``   — per-cycle count of active vertices, summed over cycles;
* ``pushes``   — cycles' push actions: ``active - relabels``;
* ``relabels`` — vertices whose height changed this cycle (a relabel
  strictly raises ``h``; a dead end deactivates to ``h = n`` — both
  count, pushes never touch ``h``);
* ``frontier`` — per-cycle sum of ``deg(u)`` over active ``u``: the flat
  arc frontier the vertex-centric approach scans;
* ``*_hist``   — the per-cycle series of the three quantities above plus
  the per-cycle max active degree, single-instance drivers only.

Overflow contract: counters are **int32 on the device** like every other
state array, and every sum passes ``dtype=torch.int32`` (torch would
widen it to int64).  Within one call the largest cell is ``frontier <=
max_cycles * A``; drivers accumulate across calls on the host in int64.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

__all__ = ["CycleTelemetry", "telemetry_init", "cycle_stats",
           "count_relabels"]

_I32 = torch.int32


class CycleTelemetry(NamedTuple):
    """Device-side counter block carried by the cycle loops.

    Totals are 0-d int32 tensors (single driver) or ``(B,)`` rows
    (batched driver).  Histories are ``(H,)`` int32 per-cycle series,
    present only when the driver allocates them (``None`` otherwise; the
    sweep engine carries ``None`` leaves untouched).
    """

    pushes: Any
    relabels: Any
    active: Any
    frontier: Any
    active_hist: Any = None
    frontier_hist: Any = None
    maxdeg_hist: Any = None


def telemetry_init(batch: int | None = None, hist: int | None = None,
                   device=None) -> CycleTelemetry:
    """Zeroed telemetry block on ``device``: 0-d totals for the
    single-instance driver (``batch=None``), ``(batch,)`` rows otherwise;
    ``hist`` adds ``(hist,)`` per-cycle series (single-instance only)."""
    shape = () if batch is None else (batch,)

    def zero(shape):
        return torch.zeros(shape, dtype=_I32, device=device)

    hists = (None, None, None)
    if hist is not None:
        if batch is not None:
            raise ValueError("per-cycle histories are single-instance only")
        hists = tuple(zero((hist,)) for _ in range(3))
    return CycleTelemetry(pushes=zero(shape), relabels=zero(shape),
                          active=zero(shape), frontier=zero(shape),
                          active_hist=hists[0], frontier_hist=hists[1],
                          maxdeg_hist=hists[2])


def cycle_stats(g, meta, state, s, t):
    """Per-cycle workload counts of the CURRENT state: ``(active
    vertices, frontier arcs, max active degree)``, each int32.

    Single instance: ``s``/``t`` ints, 0-d results.  With ``(B, ·)``
    state rows (the batched driver) pass ``s``/``t`` as ``(B,)`` tensors
    and get ``(B,)`` out."""
    deg = g.indptr[..., 1:] - g.indptr[..., :-1]
    if state.h.ndim == 1:
        from repro_torch.core import pushrelabel as pr

        act = pr.active_mask(state, meta.n, s, t)
    else:
        from repro_torch.core import batched

        act = batched.active_rows(state.h, state.e, meta.n, s, t)
    adeg = torch.where(act, deg, 0)
    return (act.sum(dim=-1, dtype=_I32), adeg.sum(dim=-1, dtype=_I32),
            adeg.amax(dim=-1))


def count_relabels(old_h: torch.Tensor, new_h: torch.Tensor) -> torch.Tensor:
    """Vertices whose height changed across one bulk-synchronous cycle —
    exactly the relabel count (pushes do not write ``h``; every relabel,
    the dead-end deactivation to ``h = n`` included, strictly changes
    it)."""
    return (new_h != old_h).sum(dim=-1, dtype=_I32)
