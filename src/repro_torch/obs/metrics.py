"""Process-global metrics registry: counters, gauges, histograms (a copy
of the JAX package's ``repro.obs.metrics``; the port imports nothing of
``repro``).

The serving tier, the solver drivers and the benchmarks all report
through one registry so every number has exactly one source of truth —
``MaxflowService.telemetry_snapshot()`` and ``BENCH_*.json`` read the
same cells.  Design constraints, in order:

* **cheap** — a counter increment is a dict lookup + an int add; safe to
  leave on in production paths (the expensive *device-side* counters are
  gated separately, see ``repro_torch.obs.solvercounters``);
* **label-scoped** — one metric family (``serve.pushes``) holds one
  child per label set (``bucket=n64a256d8``), so per-bucket and
  per-mode breakdowns do not mint new metric names;
* **JSON-snapshot-able** — ``MetricsRegistry.snapshot()`` returns plain
  Python scalars only (``json.dumps`` round-trips it verbatim).

Values are Python ints/floats, not numpy scalars: callers must convert
on the way in or rely on the
``int()``/``float()`` coercion the update methods apply.
"""
from __future__ import annotations

import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram",
]

#: default histogram bucket upper bounds (seconds-flavoured: latencies
#: from 100us to ~2min; the top bucket is +inf implicitly)
DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1,
                   1.0, 3.0, 10.0, 30.0, 120.0)


def _label_key(labels: dict) -> tuple:
    """Canonical, hashable rendering of a label set."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_suffix(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


class Counter:
    """Monotonically increasing integer/float count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, amount: int | float = 1) -> None:
        amount = amount if isinstance(amount, (int, float)) else int(amount)
        if amount < 0:
            raise ValueError(
                f"counters are monotonic; cannot inc by {amount}")
        self.value += amount

    def _snapshot(self):
        return self.value


class Gauge:
    """Last-written value (queue depths, pinned costs, config echoes)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, value: int | float) -> None:
        self.value = (value if isinstance(value, (int, float))
                      else float(value))

    def inc(self, amount: int | float = 1) -> None:
        self.value += amount

    def dec(self, amount: int | float = 1) -> None:
        self.value -= amount

    def _snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram (cumulative counts, Prometheus-style).

    ``buckets`` are the finite upper bounds; an implicit +inf bucket
    catches the tail.  ``observe`` is O(len(buckets)) with no
    allocation — fine for per-request latencies, do not put it inside a
    per-cycle loop (that is what the device-side counters are for).
    """

    __slots__ = ("bounds", "counts", "total", "count")

    def __init__(self, buckets: tuple = DEFAULT_BUCKETS):
        self.bounds = tuple(float(b) for b in buckets)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(
                f"histogram buckets must be strictly increasing, "
                f"got {buckets}")
        self.counts = [0] * (len(self.bounds) + 1)  # +1: the +inf bucket
        self.total = 0.0
        self.count = 0

    def observe(self, value: int | float) -> None:
        value = float(value)
        i = 0
        for bound in self.bounds:
            if value <= bound:
                break
            i += 1
        self.counts[i] += 1
        self.total += value
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def _snapshot(self):
        return {"buckets": list(self.bounds), "counts": list(self.counts),
                "sum": self.total, "count": self.count}


class MetricsRegistry:
    """Name -> family -> per-label-set child.  Thread-safe on the
    create path (the serving tier is single-threaded by design, but the
    ROADMAP's async front-end will not be); updates on the returned
    metric objects are plain attribute writes.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # name -> (kind, {label_key: metric})
        self._families: dict[str, tuple[type, dict]] = {}

    def _get(self, kind: type, name: str, labels: dict, **kw):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = (kind, {})
            if fam[0] is not kind:
                raise TypeError(
                    f"metric {name!r} is a {fam[0].__name__}, not a "
                    f"{kind.__name__}")
            child = fam[1].get(key)
            if child is None:
                child = fam[1][key] = kind(**kw)
            return child

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, buckets: tuple = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def get(self, name: str, **labels):
        """The existing child for (name, labels), or None."""
        fam = self._families.get(name)
        if fam is None:
            return None
        return fam[1].get(_label_key(labels))

    def snapshot(self) -> dict:
        """JSON-clean dump: ``{"counters": {...}, "gauges": {...},
        "histograms": {...}}`` with ``name{k=v,...}`` keys."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        section = {Counter: "counters", Gauge: "gauges",
                   Histogram: "histograms"}
        with self._lock:
            for name, (kind, children) in sorted(self._families.items()):
                dst = out[section[kind]]
                for key, child in sorted(children.items()):
                    dst[name + _label_suffix(key)] = child._snapshot()
        return out

    def reset(self) -> None:
        """Drop every family (tests and benchmark reruns)."""
        with self._lock:
            self._families.clear()


#: THE process-global registry — everything observable reports here
REGISTRY = MetricsRegistry()


def counter(name: str, **labels) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, buckets: tuple = DEFAULT_BUCKETS,
              **labels) -> Histogram:
    return REGISTRY.histogram(name, buckets=buckets, **labels)
