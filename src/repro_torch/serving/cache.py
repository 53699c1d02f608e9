"""Caches for the max-flow serving subsystem (a copy of the JAX package's
``repro.serving.cache``).

Two caches bound the two expensive things a serving loop repeats:

* ``ResultCache`` — solved instances keyed by a canonical graph hash.  A
  repeat ``submit`` of an identical ``(graph, s, t)`` is answered without
  touching the device, and the stored final residual state is the entry
  point for warm-started re-solves (``MaxflowService.resubmit``).
* ``ExecutableCache`` — bookkeeping of dispatch signatures ``(bucket,
  batch, mode, cycle_chunk)``.  There is no compiler in the way on the
  card, but a signature's first dispatch is not a steady-state one
  either: it pays for the first load of the kernel libraries its mode
  launches and for the caching allocator's first growth to the bucket's
  padded shapes.  So a "compile" here counts a signature's first
  dispatch, exactly as the reference counts its XLA compiles; the
  shape-bucketing policy stays auditable and the mode policy's warm
  re-dispatch of a signature's first flush keeps its meaning.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import OrderedDict

import numpy as np

from repro_torch.api.solution import WarmStartHandle
from repro_torch.core.csr import Graph
from repro_torch.obs import metrics


def canonical_graph_key(graph: Graph, s: int, t: int,
                        layout: str = "bcsr") -> str:
    """Content hash of a max-flow instance (graph + terminals + layout)."""
    h = hashlib.sha256()
    h.update(f"{graph.n}|{s}|{t}|{layout}|".encode())
    edges = np.ascontiguousarray(graph.edges, np.int64)
    cap = np.ascontiguousarray(graph.cap, np.int64)
    h.update(edges.tobytes())
    h.update(b"|")
    h.update(cap.tobytes())
    return h.hexdigest()[:32]


@dataclasses.dataclass
class CacheEntry:
    """A solved instance: value + a ``repro_torch.api.WarmStartHandle``.

    The handle owns the final residual state (host copies) and its lazy
    phase-2 preflow->flow correction — the warm re-start semantics that
    used to be hand-rolled here live with the handle now, shared with
    ``repro_torch.api.Solver.resolve``.
    """

    graph_id: str
    maxflow: int
    handle: WarmStartHandle


class ResultCache:
    """LRU cache of ``CacheEntry`` keyed by canonical graph hash."""

    def __init__(self, max_entries: int = 512):
        self.max_entries = max_entries
        self._entries: OrderedDict[str, CacheEntry] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> CacheEntry | None:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            metrics.counter("serve.result_cache.misses").inc()
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        metrics.counter("serve.result_cache.hits").inc()
        return entry

    def put(self, entry: CacheEntry) -> None:
        self._entries[entry.graph_id] = entry
        self._entries.move_to_end(entry.graph_id)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def peek(self, key: str) -> CacheEntry | None:
        """Lookup without touching LRU order or hit/miss stats."""
        return self._entries.get(key)

    def __len__(self) -> int:
        return len(self._entries)


class ExecutableCache:
    """Bounded-LRU tracking of dispatch signatures (see the module
    docstring for what a "compile" is on the card).

    ``max_entries`` caps the resident signature set; the
    least-recently-dispatched signature is evicted past the cap, and a
    re-dispatch of an evicted signature counts as a fresh compile, as
    in the reference.
    ``compiles`` is the monotonic count of compile events, not the
    resident size (``stats()['resident']``)."""

    def __init__(self, max_entries: int = 256):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self._keys: OrderedDict[tuple, int] = OrderedDict()
        self.hits = 0
        self.evictions = 0
        self._compiles = 0

    def note(self, key: tuple) -> bool:
        """Record a dispatch under ``key``; returns True if this signature
        was already compiled (cache hit)."""
        if key in self._keys:
            self._keys[key] += 1
            self._keys.move_to_end(key)
            self.hits += 1
            metrics.counter("serve.executable_cache.hits").inc()
            return True
        self._keys[key] = 1
        self._compiles += 1
        metrics.counter("serve.executable_cache.compiles").inc()
        while len(self._keys) > self.max_entries:
            self._keys.popitem(last=False)
            self.evictions += 1
            metrics.counter("serve.executable_cache.evictions").inc()
        return False

    @property
    def compiles(self) -> int:
        return self._compiles

    @staticmethod
    def _jsonable(key):
        """A JSON-serializable rendering of one signature tuple.  Tuples
        (incl. NamedTuples like BucketKey) become lists; anything that is
        not a JSON scalar is stringified."""
        if isinstance(key, tuple):
            return [ExecutableCache._jsonable(v) for v in key]
        if key is None or isinstance(key, (bool, int, float, str)):
            return key
        return repr(key)

    def stats(self) -> dict:
        # signature tuples are heterogeneous (None cadences, str modes,
        # NamedTuple buckets), so sorting the raw tuples can raise
        # TypeError; sort a canonical JSON rendering instead — stable
        # across runs and safe to json.dumps
        keys = [self._jsonable(k) for k in self._keys]
        # per-mode dispatch histogram: under the auto policy, trial
        # dispatches of the candidate modes show up here — the audit
        # trail for how much measuring cost (solve signatures are
        # (bucket, B, mode, cadence); other callers' keys are skipped)
        by_mode: dict[str, int] = {}
        for key, count in self._keys.items():
            if len(key) == 4 and isinstance(key[2], str):
                by_mode[key[2]] = by_mode.get(key[2], 0) + count
        return {"compiles": self.compiles, "hits": self.hits,
                "evictions": self.evictions, "resident": len(self._keys),
                "max_entries": self.max_entries,
                "dispatches_by_mode": dict(sorted(by_mode.items())),
                "keys": sorted(keys, key=json.dumps)}
