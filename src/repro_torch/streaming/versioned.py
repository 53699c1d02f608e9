"""Versioned chains of warm-start handles (a copy of the JAX package's
``repro.streaming.versioned``).

A streaming graph yields a new phase-2-corrected ``WarmStartHandle``
per applied update batch.  :class:`VersionChain` keeps a bounded window
of those versions so queries can address a consistent snapshot
("version 12, before this morning's re-weights") while updates keep
flowing:

* ``append`` registers a new version and returns its id (monotonically
  increasing, starting at 0);
* ``get`` retrieves a version and marks it recently-used;
* ``pin``/``unpin`` exclude a version from eviction (queries that hold a
  version across a long computation pin it);
* eviction is LRU over the unpinned versions whenever the chain exceeds
  ``capacity`` — the latest version is never evicted (the next update
  re-enters the solver from it).

Evicted versions raise ``KeyError`` on access; never-issued versions
raise too, with a distinct message.  The chain stores values alongside
handles so a query for an evicted-but-remembered *value* is still
answerable by re-solving cold from the recorded capacities — callers
decide; the chain itself only manages lifetime.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any


@dataclasses.dataclass
class VersionRecord:
    """One link of the chain."""

    version: int
    handle: Any  # WarmStartHandle (untyped to keep layering one-way)
    value: int
    parent: int | None  # version this one was derived from
    events: int = 0  # update events folded into this version
    pins: int = 0


class VersionChain:
    """Bounded LRU chain of solved versions (module docstring)."""

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError(f"chain capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._records: OrderedDict[int, VersionRecord] = OrderedDict()
        self._next = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._records)

    def __contains__(self, version: int) -> bool:
        return version in self._records

    @property
    def latest(self) -> int:
        if not self._records:
            raise KeyError("empty version chain")
        return next(reversed(self._records))

    def append(self, handle, value: int, parent: int | None = None,
               events: int = 0) -> int:
        version = self._next
        self._next += 1
        self._records[version] = VersionRecord(
            version=version, handle=handle, value=int(value),
            parent=parent, events=int(events))
        self._evict()
        return version

    def get(self, version: int) -> VersionRecord:
        rec = self._records.get(version)
        if rec is None:
            if 0 <= version < self._next:
                raise KeyError(
                    f"version {version} was evicted from the chain "
                    f"(capacity {self.capacity}; pin versions you need "
                    "to keep)")
            raise KeyError(f"version {version} was never issued "
                           f"(latest is {self._next - 1})")
        self._records.move_to_end(version)  # recently used
        return rec

    def pin(self, version: int) -> None:
        self.get(version).pins += 1

    def unpin(self, version: int) -> None:
        rec = self.get(version)
        if rec.pins <= 0:
            raise ValueError(f"version {version} is not pinned")
        rec.pins -= 1
        self._evict()

    def _evict(self) -> None:
        """Drop least-recently-used unpinned non-latest versions until the
        chain fits.  Pinned versions can hold the chain over capacity —
        bounded by the number of outstanding pins, which the pinner
        controls."""
        while len(self._records) > self.capacity:
            latest = self.latest
            victim = next(
                (v for v, rec in self._records.items()
                 if rec.pins == 0 and v != latest), None)
            if victim is None:
                return  # everything is pinned (or latest): allow overflow
            del self._records[victim]
            self.evictions += 1

    def stats(self) -> dict:
        return {
            "versions": len(self._records),
            "latest": self._next - 1,
            "capacity": self.capacity,
            "evictions": self.evictions,
            "pinned": sum(1 for rec in self._records.values() if rec.pins),
        }
