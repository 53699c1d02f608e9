"""Nested span tracing with Chrome ``trace_event`` JSON export (a copy of
the JAX package's ``repro.obs.trace``).

``Tracer`` records begin/end (``ph: "B"``/``"E"``) events for the
synchronous span tree (flush -> solve -> phase 2) plus complete
(``ph: "X"``) events for things whose start was recorded elsewhere (a
request's enqueue -> respond lifecycle).  ``Tracer.export(path)`` writes
the JSON object form (``{"traceEvents": [...]}``) that
``chrome://tracing`` and https://ui.perfetto.dev open directly.

Disabled (the default) the tracer is zero-overhead by construction:
``span()`` returns a shared no-op context manager, ``@traced`` functions
call straight through, and nothing allocates.  Enable with
``TRACER.enable()``.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time

__all__ = ["Tracer", "TRACER", "span", "traced"]


def _now_us() -> float:
    return time.perf_counter() * 1e6


class _NullSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live ``B``/``E`` pair; re-entrant use is a fresh instance."""

    __slots__ = ("_tracer", "_name", "_args")

    def __init__(self, tracer: Tracer, name: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._tracer._emit("B", self._name, _now_us(), self._args)
        return self

    def __exit__(self, *exc):
        self._tracer._emit("E", self._name, _now_us())
        return False


class Tracer:
    """Collects Chrome trace events in memory until ``export``/``clear``."""

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._pid = os.getpid()

    # -- control ------------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events = []

    def __len__(self) -> int:
        return len(self._events)

    # -- recording ----------------------------------------------------------

    def _emit(self, ph: str, name: str, ts_us: float,
              args: dict | None = None, dur_us: float | None = None) -> None:
        ev = {"name": name, "ph": ph, "ts": ts_us, "pid": self._pid,
              "tid": threading.get_ident()}
        if dur_us is not None:
            ev["dur"] = dur_us
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def span(self, name: str, **args):
        """``with tracer.span("serve.flush", bucket=...):`` — emits a
        nested ``B``/``E`` pair.  Disabled: the shared no-op manager."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def complete(self, name: str, start_s: float, end_s: float,
                 **args) -> None:
        """A ``ph: "X"`` complete event from ``time.perf_counter()``
        endpoints — for lifecycles whose start predates the span (a
        request's enqueue happened turns before its flush)."""
        if not self.enabled:
            return
        self._emit("X", name, start_s * 1e6, args,
                   dur_us=max(end_s - start_s, 0.0) * 1e6)

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        ev_args = dict(args)
        self._emit("i", name, _now_us(), ev_args)
        self._events[-1]["s"] = "t"  # instant scope: thread

    # -- export -------------------------------------------------------------

    def to_dict(self) -> dict:
        with self._lock:
            return {"traceEvents": list(self._events),
                    "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the Chrome ``trace_event`` JSON object format; returns
        ``path``.  Load in chrome://tracing or ui.perfetto.dev."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path


#: THE process-global tracer (disabled until a surface enables it)
TRACER = Tracer()


def span(name: str, **args):
    """Module-level shorthand for ``TRACER.span``."""
    if not TRACER.enabled:
        return _NULL_SPAN
    return _Span(TRACER, name, args)


def traced(name: str | None = None):
    """Decorator form: ``@traced()`` wraps the call in a span named after
    the function (or ``name``).  Disabled tracer: straight call-through.
    """
    def deco(fn):
        span_name = name or f"{fn.__module__}.{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not TRACER.enabled:
                return fn(*a, **kw)
            with _Span(TRACER, span_name, {}):
                return fn(*a, **kw)
        return wrapper
    return deco
