"""Streaming dynamic-graph tier: incremental re-solves over versioned
warm-start chains (port of the JAX package's ``repro.streaming``).

* ``repro_torch.streaming.events`` — edit-event types (``EdgeInsert``,
  ``EdgeDelete``, ``CapacityReweight``) and their normalisation against
  a concrete residual;
* ``repro_torch.streaming.reroute`` — device-resident flow rerouting for
  capacity decreases (the tier's core algorithm), single and pooled;
* ``repro_torch.streaming.versioned`` — bounded-LRU ``VersionChain`` of
  phase-2-corrected warm-start handles;
* ``repro_torch.streaming.stream`` — ``StreamingGraph`` (=
  ``StreamHandle``), the per-client orchestration
  ``repro_torch.api.Solver.open_stream`` returns.

Only the event types import eagerly; everything else resolves lazily so
low-level modules (e.g. ``repro_torch.graphs.generators``' trace
generator) can import the event vocabulary without pulling in the solver
stack.
"""
from __future__ import annotations

from repro_torch.streaming.events import (  # noqa: F401
    CapacityReweight, EdgeDelete, EdgeInsert, normalize_events)

__all__ = [
    "CapacityReweight", "EdgeDelete", "EdgeInsert", "normalize_events",
    "StreamingGraph", "StreamHandle", "VersionChain", "reroute",
]

_LAZY = {
    "StreamingGraph": ("repro_torch.streaming.stream", "StreamingGraph"),
    "StreamHandle": ("repro_torch.streaming.stream", "StreamHandle"),
    "rebuild_with_state": ("repro_torch.streaming.stream",
                           "rebuild_with_state"),
    "VersionChain": ("repro_torch.streaming.versioned", "VersionChain"),
    "VersionRecord": ("repro_torch.streaming.versioned", "VersionRecord"),
}


def __getattr__(name: str):
    if name == "reroute":
        import repro_torch.streaming.reroute as mod
        return mod
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch.streaming' has no attribute {name!r}"
        ) from None
    import importlib

    return getattr(importlib.import_module(mod_name), attr)
