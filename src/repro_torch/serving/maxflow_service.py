"""Max-flow serving: shape-bucketed microbatching + warm-started re-solves
(port of the JAX package's ``repro.serving.maxflow_service``; it serves
on the CUDA card unless ``ServiceConfig(device="cpu")`` asks for the
CPU, where every kernel hook takes its plain PyTorch version).

``MaxflowService`` turns the batched WBPR core into a request/response
subsystem:

* ``submit(graph, s, t) -> future`` — canonical-hash lookup first (repeat
  queries are served from the result cache without touching the device),
  otherwise the instance is bucketed by padded shape and microbatched; one
  ``batched_resolve`` dispatch advances the whole bucket.
* ``resubmit(graph_id, edge_updates) -> future`` — re-solve a previously
  solved graph after capacity updates.  The cache stores a
  ``repro_torch.api.WarmStartHandle`` per solved instance; its ``apply``
  turns increases into budgeted warm-start arrays (only the new capacity
  gets routed; the solved flow is kept) and decreases into an on-device
  reroute of the overflowed flow (``repro_torch.streaming.reroute``) —
  the same semantics as ``repro_torch.api.Solver.resolve``, shared
  through the handle.  Phase-2 preflow->flow correction is
  deferred but *batched*: solved handles join a correction pool, and the
  first entry that needs a genuine flow (a resubmit, a flows/min-cut
  view) is corrected by one ``batched.batched_phase2`` device dispatch
  that tops its batch up with other pending handles — pool-mates ride
  along free, never-resubmitted entries never pay, and no host-side
  O(V*E) conversion remains on the resubmit hot path.
* Signature reuse — batches are padded to ``(bucket shape, pow2
  batch)`` so the number of distinct dispatch signatures (each one's
  first dispatch loads its kernels and grows the caching allocator) is
  bounded by the bucket grid, not by the traffic; ``ExecutableCache``
  audits this.
* Measured per-bucket mode policy — under ``ServiceConfig(mode="auto")``
  each shape bucket trials the candidate solver modes on its first
  flushes and pins the measured winner (``repro_torch.serving.policy``); the
  table is surfaced by ``stats()['mode_policy']``.  A fixed mode is the
  escape hatch.
* Streaming sessions — ``open_stream(graph, s, t) -> stream_id`` holds a
  long-lived versioned chain of warm-start handles
  (``repro_torch.streaming.versioned``); ``stream_apply(stream_id, events)``
  folds edge insert / delete / re-weight events into a new version,
  riding the SAME bucket queues as one-shot requests, so update events
  from many concurrent streams pool into shared incremental flushes.
  Applies whose reroute already restores maximality resolve without any
  dispatch; ``stream_query`` answers from the retained chain.

The service is synchronous and single-threaded by design: callers drive it
with ``poll()`` (release due microbatches), ``flush()`` (drain everything),
or implicitly via ``future.result()``.  That keeps it deterministic and
testable; an async front-end is a thin wrapper away (see ROADMAP).

**Overload hardening** (``docs/ROBUSTNESS.md``): admission is bounded
(per-bucket queues reject with a typed ``Overloaded`` carrying a
retry-after hint once full — after shedding expired work first), requests
may carry a ``deadline_s`` (expired work is shed *before* dispatch and
fails with ``DeadlineExceeded``; a near-deadline queue flushes early),
dispatch failures walk a graceful degradation ladder (retry with
exponential backoff + jitter at each rung, demote ``vc_fused ->
vc_kernel -> vc``, bottom out on the sequential host reference solver;
on the card only the typed ``InjectedFault`` and ``BudgetExhausted`` take
it, and any other dispatch error fails the flush and propagates), and
cached warm-start handles are validated before every reuse —
corrupted state is quarantined and rebuilt cold, never warm-started
from.  A seed-deterministic ``repro_torch.runtime.fault.FaultPlan``
injects all of these failure classes for chaos tests.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import time
import weakref
from collections import deque

import numpy as np

from repro_torch.api.solution import WarmStartHandle
from repro_torch.core import batched
from repro_torch.core.csr import Graph, ResidualCSR, build_residual
from repro_torch.core.pushrelabel import ALL_MODES, KERNEL_MODES
from repro_torch.core.ref_maxflow import dinic_residual_flow
from repro_torch.errors import (BudgetExhausted, DeadlineExceeded,
                                DispatchFailed, HandleCorrupted, Overloaded)
from repro_torch.graphs.generators import BipartiteProblem
from repro_torch.kernels.runtime import resolve_device
from repro_torch.obs import (REGISTRY, TRACER, counter, histogram, span,
                             to_jsonable)
from repro_torch.runtime.fault import InjectedFault
from repro_torch.serving.cache import (CacheEntry, ExecutableCache,
                                       ResultCache, canonical_graph_key)
from repro_torch.serving.policy import (HOST_REF, BucketLadder,
                                        BucketModePolicy, candidate_modes,
                                        demote_mode)
from repro_torch.serving.queueing import (BucketKey, MaxflowFuture,
                                          MicrobatchQueue, Request,
                                          bucket_for)
from repro_torch.streaming import reroute
from repro_torch.streaming.events import normalize_events
from repro_torch.streaming.stream import rebuild_with_state
from repro_torch.streaming.versioned import VersionChain


def _pooled_correction(svc_ref, handle_ref) -> None:
    """Corrector hook installed on served ``WarmStartHandle``s: dispatch
    the owning service's pooled phase-2 correction.  Holds only weakrefs
    (see ``MaxflowService._correct_batch``); if either side is gone the
    hook is a no-op and ``arrays()`` falls back to the per-instance
    device conversion."""
    svc, handle = svc_ref(), handle_ref()
    if svc is not None and handle is not None:
        svc._correct_batch(handle)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    # "auto" (default): measured per-bucket mode policy — each shape
    # bucket trials the candidate modes on its first flushes and pins the
    # measured winner (see repro_torch.serving.policy).  Any fixed solver mode
    # ('vc' | 'tc' | 'vc_kernel' | 'vc_kernel_bsearch' | 'vc_fused') is
    # the escape hatch: every bucket runs exactly that mode, no trials.
    mode: str = "auto"
    layout: str = "bcsr"  # 'bcsr' | 'rcsr'
    max_batch: int = 8  # microbatch release threshold / capacity
    max_wait_s: float = float("inf")  # latency bound for poll()
    cycle_chunk: int | None = None  # cycles per device dispatch
    cache_entries: int = 512
    # resident cap for the dispatch-signature LRU; evicted
    # signatures count a fresh compile when dispatched again
    executable_entries: int = 256
    pad_full_batch: bool = True  # one executable per bucket (see queueing)
    mode_trials: int = 1  # clean samples per candidate before pinning
    # pooled phase-2 sweeps, and served handles' own drains and fallback
    # phase 2: None resolves by mode (a fixed kernel mode runs them on the
    # min-search kernel, one launch a step for the whole group;
    # 'auto'/'vc'/'tc' keep the plain scan selector), an explicit bool
    # overrides
    phase2_kernel: bool | None = None
    # fold device-side workload counters (pushes/relabels/active/frontier)
    # into every solve dispatch.  False runs the exact pre-telemetry
    # cycle loop — the escape hatch if the extra int32 carries ever matter
    telemetry: bool = True
    # -- overload hardening (docs/ROBUSTNESS.md) --
    # bound on queued requests per bucket; None = unbounded (legacy).
    # Pushing past it raises a typed Overloaded (expired work is shed
    # first — a full queue of dead requests does not reject live ones)
    max_queue: int | None = None
    # flush a bucket early when its most urgent deadline is this close
    deadline_slack_s: float = 0.0
    # degradation ladder: retries per rung before demoting one mode down,
    # exponential backoff base/cap (jittered), and how many accumulated
    # failures of a mode demote the bucket's ceiling permanently
    retry_limit: int = 2
    retry_base_s: float = 0.01
    retry_max_s: float = 0.25
    demote_after: int = 2
    retry_seed: int = 0  # jitter rng; fixed seed = reproducible schedules
    # validate cached warm-start handles before every reuse (resubmit,
    # stream apply, correction pool); corrupted state is quarantined and
    # rebuilt cold.  O(arcs) host work per reuse — the escape hatch for
    # trusted single-writer deployments
    validate_handles: bool = True
    # where every solve, correction and drain runs: None = the CUDA card
    # (the service raises without one), or "cpu" by name
    device: str | None = None

    def __post_init__(self):
        if self.mode != "auto" and self.mode not in ALL_MODES:
            raise ValueError(
                f"mode must be 'auto' or one of {ALL_MODES}, "
                f"got {self.mode!r}")
        if self.mode_trials < 1:
            raise ValueError(
                f"mode_trials must be >= 1, got {self.mode_trials}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1 or None, got {self.max_queue}")
        if self.retry_limit < 0:
            raise ValueError(
                f"retry_limit must be >= 0, got {self.retry_limit}")
        if self.retry_base_s < 0 or self.retry_max_s < 0:
            raise ValueError("retry backoff times must be >= 0")
        if self.demote_after < 1:
            raise ValueError(
                f"demote_after must be >= 1, got {self.demote_after}")

    def resolve_phase2_kernel(self) -> bool:
        if self.phase2_kernel is not None:
            return self.phase2_kernel
        return self.mode in KERNEL_MODES


@dataclasses.dataclass
class MaxflowResult:
    graph_id: str
    maxflow: int
    cycles: int = 0  # push-relabel iterations this solve spent
    rounds: int = 0
    warm: bool = False  # warm-started from a cached residual
    cached: bool = False  # answered from the result cache (no solve)
    batch_size: int = 1  # live instances in the dispatch that solved it
    phase2_s: float = 0.0  # device phase-2 time this request triggered
    version: int | None = None  # chain version (streaming applies/queries)


@dataclasses.dataclass
class StreamSession:
    """One open streaming session: a versioned chain plus the futures of
    applies still waiting on a pooled flush."""

    stream_id: str
    s: int
    t: int
    chain: object  # repro_torch.streaming.versioned.VersionChain
    pending: list = dataclasses.field(default_factory=list)
    applies: int = 0
    events: int = 0
    queries: int = 0
    rebuilds: int = 0
    noop_applies: int = 0  # reroute restored maximality: no dispatch


@dataclasses.dataclass
class _PendingApply:
    """One stream apply between its admission half (events normalized,
    structural rebuild done, capacity deltas staged as a
    ``PreparedReroute``) and its completion half (drained result chained
    as a new version).  ``stream_apply_many`` pools the drains of a whole
    wave of these through one ``reroute.drain_prepared`` dispatch."""

    sess: StreamSession
    handle: WarmStartHandle
    prep: object  # reroute.PreparedReroute
    graph_id: str
    parent: int
    events: int
    phase2_s: float


class MaxflowService:
    def __init__(self, config: ServiceConfig | None = None, faults=None):
        self.config = config or ServiceConfig()
        # raises without a card unless the config names the CPU: the
        # service never falls back to it
        self.device = resolve_device(self.config.device)
        # optional chaos schedule (repro_torch.runtime.fault.FaultPlan or any
        # object with before_dispatch/corrupt_handle/stats); None = no
        # injection.  Faults only ever poison *cached* state or raise
        # from dispatches — answers already extracted stay correct.
        self.faults = faults
        self.results = ResultCache(self.config.cache_entries)
        self.executables = ExecutableCache(self.config.executable_entries)
        self._buckets: dict[BucketKey, MicrobatchQueue] = {}
        self._inflight: dict[str, Request] = {}  # graph_id -> queued request
        self.n_submitted = 0
        self.n_resubmitted = 0
        self.n_coalesced = 0
        self.n_solved = 0
        self.n_batches = 0
        self.phase2_time_s = 0.0  # cumulative device phase-2 time
        self.sweep_time_s = 0.0  # cumulative pooled global-relabel time
        self.gr_sweeps = 0  # cumulative global-relabel BF sweep count
        # per-bucket device-counter totals (live lanes only), keyed by
        # BucketKey.label; mirrored into the metrics registry as
        # serve.*{bucket=...} counters
        self._bucket_counts: dict[str, dict[str, int]] = {}
        # per-bucket measured mode policy (mode='auto' only; fixed modes
        # leave this empty)
        self._policies: dict[BucketKey, BucketModePolicy] = {}
        # phase-2 correction pool: _pending_correction holds weakrefs to
        # cached handles awaiting correction; the dispatch that corrects a
        # resubmit target tops its batch up with the oldest of them, so
        # later resubmits usually find their handle already corrected.
        # Served handles drain and correct themselves on the kernel route
        # when the service's pooled correction does.
        self._handle_kernel = self.config.resolve_phase2_kernel()
        self._pending_correction: deque = deque()  # weakref.ref[handle]
        # streaming sessions: stream_id -> StreamSession
        self._streams: dict[str, StreamSession] = {}
        self.n_streams_opened = 0
        # -- robustness state (docs/ROBUSTNESS.md) --
        self._ladders: dict[BucketKey, BucketLadder] = {}
        self._retry_rng = np.random.default_rng(self.config.retry_seed)
        self._flush_ewma: dict[str, float] = {}  # bucket -> flush secs
        self.n_rejected = 0  # admission rejections (Overloaded)
        self.n_shed = 0  # expired requests shed before dispatch
        self.n_expired_admission = 0  # deadline already <= 0 at submit
        self.n_retries = 0  # dispatch retries (all rungs)
        self.n_transient_demotions = 0  # within-flush ladder step-downs
        self.n_host_fallbacks = 0  # requests solved by the host reference
        self.n_quarantined = 0  # corrupted handles rebuilt cold
        self.n_dispatch_failed = 0  # requests failed past the last rung
        self.n_budget_exhausted = 0  # BudgetExhausted dispatches absorbed

    # -- admission ----------------------------------------------------------

    def submit(self, graph: Graph, s: int, t: int,
               deadline_s: float | None = None) -> MaxflowFuture:
        """Queue one max-flow instance; returns a future whose ``result()``
        is a ``MaxflowResult``.

        ``deadline_s`` (relative to now) bounds how long the request may
        wait: expired requests are shed before dispatch and their futures
        raise ``DeadlineExceeded``.  Raises ``Overloaded`` when the
        target bucket's queue is full (``ServiceConfig.max_queue``) and
        ``DeadlineExceeded(where='admission')`` for a non-positive
        deadline."""
        self.n_submitted += 1
        graph_id = canonical_graph_key(graph, s, t, self.config.layout)
        deadline_at = self._admit_deadline(graph_id, deadline_s)
        fut = self._hit_or_coalesce(graph_id)
        if fut is not None:
            return fut
        r = build_residual(graph, self.config.layout)
        if s == t or r.num_arcs == 0 or r.deg_max == 0:
            # trivial instance: answer (and cache) without a dispatch
            self.results.put(CacheEntry(
                graph_id=graph_id, maxflow=0,
                handle=WarmStartHandle(r, s, t, r.res0.copy(),
                                       np.zeros(r.n, batched.STATE_DTYPE),
                                       corrected=True, device=self.device)))
            fut = MaxflowFuture()
            fut.set_result(MaxflowResult(graph_id=graph_id, maxflow=0))
            return fut
        return self._enqueue(graph_id, r, s, t, warm=None,
                             deadline_at=deadline_at)

    def _admit_deadline(self, graph_id: str,
                        deadline_s: float | None) -> float | None:
        """Absolute expiry for a relative deadline; a deadline already
        spent rejects at admission (never reaches a queue)."""
        if deadline_s is None:
            return None
        if deadline_s <= 0:
            self.n_expired_admission += 1
            counter("serve.expired_admission").inc()
            raise DeadlineExceeded(graph_id, float(deadline_s), 0.0,
                                   where="admission")
        return time.perf_counter() + float(deadline_s)

    def _hit_or_coalesce(self, graph_id: str) -> MaxflowFuture | None:
        """A future answered from the result cache, one attached to an
        identical in-flight request, or None (caller must enqueue)."""
        hit = self.results.get(graph_id)  # get(): refresh LRU recency
        if hit is not None:
            fut = MaxflowFuture()
            fut.set_result(MaxflowResult(graph_id=graph_id,
                                         maxflow=hit.maxflow, cached=True))
            return fut
        inflight = self._inflight.get(graph_id)
        if inflight is not None:  # coalesce onto the queued solve
            self.n_coalesced += 1
            counter("serve.coalesced").inc()
            fut = MaxflowFuture(force=inflight.futures[0]._force)
            inflight.futures.append(fut)
            return fut
        return None

    def submit_matching(self, problem: BipartiteProblem,
                        deadline_s: float | None = None) -> MaxflowFuture:
        """Bipartite matching request: matching size == max-flow value on
        the super-source/super-sink construction."""
        return self.submit(problem.graph, problem.s, problem.t,
                           deadline_s=deadline_s)

    def resubmit(self, graph_id: str, edge_updates,
                 deadline_s: float | None = None) -> MaxflowFuture:
        """Re-solve a cached graph after ``(u, v, delta)`` capacity updates.

        The cached ``WarmStartHandle`` decides how: increases warm-start
        from its phase-2-corrected residual, any decrease forces a cold
        solve of the updated capacities.  Raises ``KeyError`` if
        ``graph_id`` is unknown/evicted or an update names a missing arc
        (structural change — submit the new graph instead).

        The base handle is validated before reuse (unless
        ``ServiceConfig.validate_handles`` is off): a corrupted one is
        quarantined and rebuilt cold from its pristine base capacities,
        so garbage state never seeds a warm start.
        """
        entry = self.results.get(graph_id)  # get(): a warm-start base in
        if entry is None:                   # active use must stay in LRU
            raise KeyError(f"unknown or evicted graph_id {graph_id!r}")
        self.n_resubmitted += 1
        updates = [(int(u), int(v), int(d)) for u, v, d in edge_updates]
        # content-address the edited graph as (base id, update set)
        new_id = hashlib.sha256(
            f"{graph_id}|{sorted(updates)}".encode()).hexdigest()[:32]
        deadline_at = self._admit_deadline(new_id, deadline_s)
        fut = self._hit_or_coalesce(new_id)
        if fut is not None:  # identical edit already solved or queued
            return fut
        handle = entry.handle
        if self.config.validate_handles:
            try:
                handle.validate()
            except HandleCorrupted:
                handle = self._quarantine(entry=entry)
        p2_before = self.phase2_time_s
        r2, warm = handle.apply(updates)  # may trigger the group phase 2
        return self._enqueue(new_id, r2, handle.s, handle.t, warm=warm,
                             phase2_s=self.phase2_time_s - p2_before,
                             deadline_at=deadline_at)

    # -- quarantine ---------------------------------------------------------

    def _rebuild_cold(self, handle: WarmStartHandle) -> tuple[int,
                                                              WarmStartHandle]:
        """A pristine corrected handle for ``handle``'s graph, solved from
        its base capacities (``res0``) by the host reference solver — the
        one path that shares no state with whatever got corrupted."""
        r = handle.residual
        flow, res = dinic_residual_flow(r, handle.s, handle.t)
        e = np.zeros(r.n, batched.STATE_DTYPE)
        e[handle.t] = flow
        fresh = WarmStartHandle(r, handle.s, handle.t, res, e,
                                corrected=True,
                                use_kernel=handle._use_kernel,
                                device=handle.device)
        return int(flow), fresh

    def _quarantine(self, entry: CacheEntry | None = None,
                    record=None) -> WarmStartHandle:
        """Replace a corrupted cached handle (result-cache ``entry`` or
        stream chain ``record``) with a cold rebuild, in place.  The
        poisoned arrays are dropped on the floor — quarantined state is
        never warm-started from, never served."""
        self.n_quarantined += 1
        counter("serve.quarantined").inc()
        holder = entry if entry is not None else record
        flow, fresh = self._rebuild_cold(holder.handle)
        holder.handle = fresh
        if entry is not None:
            entry.maxflow = flow
        else:
            record.value = flow
        return fresh

    def _enqueue(self, graph_id: str, r: ResidualCSR, s: int, t: int,
                 warm, phase2_s: float = 0.0, on_solved=None,
                 deadline_at: float | None = None) -> MaxflowFuture:
        key = bucket_for(r)
        queue = self._buckets.get(key)
        if queue is None:
            queue = self._buckets[key] = MicrobatchQueue(
                key, self.config.max_batch, self.config.max_wait_s,
                max_queue=self.config.max_queue,
                deadline_slack_s=self.config.deadline_slack_s)
        if queue.full():
            # shed expired work first: dead requests must not keep a full
            # queue rejecting live ones
            self._shed_queue(queue)
        if queue.full():
            self.n_rejected += 1
            counter("serve.rejected", bucket=key.label).inc()
            raise Overloaded(key.label, len(queue), queue.max_queue,
                             self._retry_after(queue))
        fut = MaxflowFuture()
        # result() must be able to drain requests queued deeper than one
        # microbatch, so the force hook flushes until this future resolves
        fut._force = lambda: self._force_future(key, fut)
        req = Request(graph_id=graph_id, residual=r, s=s, t=t,
                      futures=[fut], warm=warm, phase2_s=phase2_s,
                      on_solved=on_solved, deadline_at=deadline_at)
        queue.push(req)
        self._inflight.setdefault(graph_id, req)
        return fut

    def _retry_after(self, queue: MicrobatchQueue) -> float:
        """How long until the bucket has likely drained one admission
        slot: recent flush wall clock (EWMA) times the flushes needed to
        work through the current depth."""
        ewma = self._flush_ewma.get(queue.key.label, 0.05)
        flushes = max(1, math.ceil(len(queue) / max(queue.max_batch, 1)))
        return ewma * flushes

    def _shed_queue(self, queue: MicrobatchQueue) -> int:
        """Drop every expired request from ``queue``, failing its futures
        with ``DeadlineExceeded`` — expired work never pays for a solve."""
        shed = queue.shed_expired()
        if not shed:
            return 0
        now = time.perf_counter()
        for req in shed:
            self.n_shed += 1
            counter("serve.shed", bucket=queue.key.label).inc()
            if self._inflight.get(req.graph_id) is req:
                del self._inflight[req.graph_id]
            err = DeadlineExceeded(
                req.graph_id, req.deadline_at - req.enqueued_at,
                now - req.enqueued_at, where="queue")
            for fut in req.futures:
                fut.set_exception(err)
        return len(shed)

    def _force_future(self, key: BucketKey, fut: MaxflowFuture) -> None:
        queue = self._buckets[key]
        while not fut.done() and len(queue):
            self._flush_bucket(key)

    # -- per-bucket mode policy ---------------------------------------------

    def _choose_mode(self, key: BucketKey,
                     meta) -> tuple[str, BucketModePolicy | None]:
        """The solver mode this flush runs: the fixed config mode, or
        (``mode='auto'``) the bucket policy's trial/pinned choice.  A pack
        without head-sorted segments disqualifies ``vc_kernel_bsearch``
        from this bucket before it can be chosen (a binary search over
        unsorted segments would silently drop pushes)."""
        if self.config.mode != "auto":
            return self.config.mode, None
        policy = self._policies.get(key)
        if policy is None:
            policy = self._policies[key] = BucketModePolicy(
                candidate_modes(self.config.layout),
                trials=self.config.mode_trials, label=key.label)
        if meta.layout != "batched-bcsr":
            policy.disqualify("vc_kernel_bsearch")
        return policy.choose(), policy

    def pin_modes(self) -> dict:
        """End the measuring phase NOW: every bucket policy pins its best
        mode from the samples it has (``'vc'`` when nothing was measured
        yet — new buckets created later still trial normally).  Returns
        ``{bucket: pinned mode}``.  Lets an operator cap trial overhead
        before a latency-sensitive window instead of waiting for every
        bucket to finish its trials."""
        out = {}
        for key, policy in self._policies.items():
            if policy.pinned is None:
                policy.pin_now()
            out[key.label] = policy.pinned
        return out

    # -- dispatch -----------------------------------------------------------

    def poll(self) -> int:
        """Release every due microbatch (full, oldest request past
        ``max_wait_s``, or most urgent deadline within
        ``deadline_slack_s``).  Expired requests are shed (not solved)
        even from buckets that are not otherwise due.  Returns the number
        of requests solved."""
        solved = 0
        for key, queue in list(self._buckets.items()):
            self._shed_queue(queue)
            while queue.ready():
                solved += self._flush_bucket(key)
        return solved

    def flush(self) -> int:
        """Drain all buckets regardless of readiness."""
        solved = 0
        for key, queue in list(self._buckets.items()):
            while len(queue):
                solved += self._flush_bucket(key)
        return solved

    def _flush_bucket(self, key: BucketKey) -> int:
        queue = self._buckets[key]
        self._shed_queue(queue)  # expired work is shed, never dispatched
        reqs = queue.pop_batch()
        if not reqs:
            return 0
        with span("serve.flush", bucket=key.label, live=len(reqs)):
            return self._dispatch_flush(key, queue, reqs)

    def _dispatch_flush(self, key: BucketKey, queue: MicrobatchQueue,
                        reqs: list[Request]) -> int:
        live = len(reqs)
        now = time.perf_counter()
        for req in reqs:
            histogram("serve.queue_wait_s",
                      bucket=key.label).observe(now - req.enqueued_at)
        B = queue.padded_batch_size(live, self.config.pad_full_batch)
        instances = [(req.residual, req.s, req.t) for req in reqs]
        states = []
        for req in reqs:
            if req.warm is not None:
                states.append(req.warm)
            else:  # cold: preflow == warm start from the initial residual
                states.append(batched.warm_start_arrays(
                    req.residual, req.residual.res0,
                    np.zeros(req.residual.n, batched.STATE_DTYPE), req.s))
        for _ in range(B - live):  # pad the batch dim: trivial s==t dummies
            instances.append((reqs[0].residual, 0, 0))
            states.append((np.zeros(0, batched.STATE_DTYPE),) * 3)
        bg, meta, _, trivial = batched.pack_instances(
            instances, n_pad=key.n_pad, A_pad=key.arc_pad,
            deg_max=key.deg_max, device=self.device)
        state0 = batched.pack_states(states, meta.n, meta.num_arcs,
                                     device=self.device)
        mode0, policy = self._choose_mode(key, meta)
        ladder = self._ladders.get(key)
        if ladder is None:
            ladder = self._ladders[key] = BucketLadder(
                demote_after=self.config.demote_after, label=key.label)

        def dispatch(m):
            compiled_before = self.executables.note(
                (key, B, m, self.config.cycle_chunk))
            t0 = time.perf_counter()
            with span("serve.solve", bucket=key.label, mode=m, batch=B,
                      live=live, compiled=compiled_before):
                out = batched.batched_resolve(
                    bg, meta, state0, trivial=trivial, mode=m,
                    cycle_chunk=self.config.cycle_chunk,
                    telemetry=self.config.telemetry)
            return out, time.perf_counter() - t0, compiled_before

        # graceful degradation ladder: retry each rung with exponential
        # backoff + jitter, then demote one mode down; the bottom rung is
        # the sequential host reference solver.  A rung that fails
        # repeatedly across flushes drops the bucket's ceiling for good
        # (BucketLadder).
        cur = ladder.clamp(mode0)
        attempts = 0
        tries_at_rung = 0
        while True:
            try:
                if cur == HOST_REF:
                    if self.faults is not None:
                        self.faults.before_dispatch(
                            HOST_REF, where=f"flush:{key.label}")
                    return self._host_flush(key, reqs)
                if self.faults is not None:
                    self.faults.before_dispatch(
                        cur, where=f"flush:{key.label}")
                out, secs, compiled_before = dispatch(cur)
                break
            except Exception as exc:
                attempts += 1
                counter("serve.dispatch_errors", bucket=key.label,
                        mode=cur).inc()
                if (self.device.type == "cuda"
                        and not isinstance(exc, (InjectedFault,
                                                 BudgetExhausted))):
                    # on the card only typed faults take the ladder: a
                    # kernel that fails to build or launch (or a sticky
                    # CUDA error, which no retry on this context clears)
                    # must not be served by a plain mode or the host
                    self._fail_requests(key, reqs, DispatchFailed(
                        key.label, attempts, repr(exc)))
                    raise
                if isinstance(exc, BudgetExhausted):
                    self.n_budget_exhausted += 1
                    counter("serve.budget_exhausted",
                            bucket=key.label).inc()
                if tries_at_rung < self.config.retry_limit:
                    tries_at_rung += 1
                    self.n_retries += 1
                    counter("serve.retries", bucket=key.label).inc()
                    delay = self._backoff_s(tries_at_rung - 1)
                    if delay > 0:
                        time.sleep(delay)
                    continue
                # rung exhausted: note the failure (may drop the sticky
                # ceiling) and step one mode down
                ladder.note_failure(cur)
                if policy is not None and ladder.clamp(cur) != cur:
                    # sticky demotion: the auto policy must re-pin
                    # without the mode this bucket cannot run
                    policy.disqualify(cur)
                nxt = demote_mode(cur)
                if nxt is None:
                    self._fail_requests(key, reqs, DispatchFailed(
                        key.label, attempts, repr(exc)))
                    return live
                self.n_transient_demotions += 1
                counter("serve.transient_demotions", bucket=key.label,
                        mode=cur).inc()
                cur, tries_at_rung = nxt, 0
        if policy is not None and cur == mode0:
            if policy.pinned is None and not compiled_before:
                # first dispatch under this (bucket, mode) paid the kernel
                # load and the allocator's growth: re-run the identical
                # pure solve warm so the recorded sample measures steady
                # execution
                out, secs, _ = dispatch(cur)
            policy.record(cur, secs, int(out.cycles.sum()))
        self.sweep_time_s += out.gr_time_s
        self.gr_sweeps += int(out.gr_sweeps)
        self._note_flush(key, live, out, secs)
        # one host read of each whole (B, ·) block, never one per row
        res_np = out.state.res.cpu().numpy()
        e_np = out.state.e.cpu().numpy()
        # deferred-but-batched phase 2: handles join the correction pool
        # uncorrected (holding only their own host arrays), and the first
        # entry that needs a genuine flow (a resubmit, a flows/min-cut
        # view) is corrected by one pooled batched_phase2 dispatch that
        # tops up with other pending handles — batches that are never
        # re-solved never pay at all
        per = []
        for i, req in enumerate(reqs):
            r = req.residual
            handle = WarmStartHandle(
                r, req.s, req.t, res_np[i, : r.num_arcs].copy(),
                e_np[i, : r.n].copy(), use_kernel=self._handle_kernel,
                device=self.device)
            # weakrefs only: the corrector must not pin the service, nor
            # the handle itself (a strong handle->corrector->handle cycle
            # would keep evicted entries alive until a gc pass).  If the
            # service is gone, arrays() falls back to the per-instance
            # device conversion.
            handle._corrector = functools.partial(
                _pooled_correction, weakref.ref(self), weakref.ref(handle))
            self._pending_correction.append(weakref.ref(handle))
            per.append((int(out.maxflows[i]), handle, int(out.cycles[i]),
                        int(out.rounds[i])))
        self._finish_requests(key, reqs, per)
        return live

    def _backoff_s(self, attempt: int) -> float:
        """Jittered exponential backoff: ``base * 2^attempt`` capped at
        ``retry_max_s``, scaled by a uniform [0.5, 1) draw so synchronized
        retries decorrelate.  Seeded rng -> reproducible schedules."""
        base = self.config.retry_base_s * (2 ** attempt)
        capped = min(base, self.config.retry_max_s)
        return capped * (0.5 + 0.5 * float(self._retry_rng.random()))

    def _host_flush(self, key: BucketKey, reqs: list[Request]) -> int:
        """Bottom rung of the degradation ladder: solve every request of
        the flush with the sequential host reference solver (Dinic).
        Answers are exact, handles come back corrected (zero excess, flow
        at ``t``) — slower, never wrong."""
        live = len(reqs)
        self.n_host_fallbacks += live
        counter("serve.host_fallbacks", bucket=key.label).inc(live)
        t0 = time.perf_counter()
        per = []
        with span("serve.host_solve", bucket=key.label, live=live):
            for req in reqs:
                flow, fresh = self._rebuild_cold(WarmStartHandle(
                    req.residual, req.s, req.t, req.residual.res0,
                    np.zeros(req.residual.n, batched.STATE_DTYPE),
                    use_kernel=self._handle_kernel, device=self.device))
                per.append((flow, fresh, 0, 0))
        secs = time.perf_counter() - t0
        lbl = key.label
        bc = self._bucket_counts.setdefault(lbl, {})
        for name, v in (("flushes", 1), ("solved", live),
                        ("host_solved", live)):
            bc[name] = bc.get(name, 0) + v
            counter(f"serve.{name}", bucket=lbl).inc(v)
        histogram("serve.flush_s", bucket=lbl).observe(secs)
        prev = self._flush_ewma.get(lbl)
        self._flush_ewma[lbl] = secs if prev is None \
            else 0.7 * prev + 0.3 * secs
        self._finish_requests(key, reqs, per)
        return live

    def _finish_requests(self, key: BucketKey, reqs: list[Request],
                         per: list) -> None:
        """Shared completion half of a flush: cache each solved handle,
        resolve coalesced futures, register stream versions.  ``per`` is
        one ``(maxflow, handle, cycles, rounds)`` tuple per request."""
        live = len(reqs)
        for req, (maxflow, handle, cycles, rounds) in zip(reqs, per):
            if self.faults is not None:
                # chaos: may poison the *cached* state in place.  The
                # answer (maxflow) is already extracted — corruption is
                # only ever observable to validation at reuse.
                self.faults.corrupt_handle(handle)
            entry = CacheEntry(graph_id=req.graph_id, maxflow=maxflow,
                               handle=handle)
            self.results.put(entry)
            if self._inflight.get(req.graph_id) is req:
                del self._inflight[req.graph_id]
            # streaming applies register the solved handle as a new chain
            # version before their futures resolve
            version = (req.on_solved(handle, maxflow)
                       if req.on_solved is not None else None)
            for fut in req.futures:
                fut.set_result(MaxflowResult(
                    graph_id=req.graph_id, maxflow=maxflow,
                    cycles=cycles, rounds=rounds,
                    warm=req.warm is not None, batch_size=live,
                    phase2_s=req.phase2_s, version=version))
                # full enqueue -> respond lifecycle as one complete event
                TRACER.complete("serve.request", fut.created_at,
                                fut.completed_at, graph=req.graph_id[:12],
                                bucket=key.label, maxflow=maxflow)
                histogram("serve.request_latency_s").observe(fut.latency_s)
        self.n_solved += live
        self.n_batches += 1
        if len(self._pending_correction) > 2 * self.config.cache_entries:
            # drop dead / already-corrected weakrefs so the pool cannot
            # grow unboundedly under never-resubmitted traffic
            self._pending_correction = deque(
                ref for ref in self._pending_correction
                if (h := ref()) is not None and not h.corrected)

    def _fail_requests(self, key: BucketKey, reqs: list[Request],
                       err: Exception) -> None:
        """Terminal failure of a whole flush (every ladder rung failed):
        the affected futures carry the typed error."""
        self.n_dispatch_failed += len(reqs)
        counter("serve.dispatch_failed", bucket=key.label).inc(len(reqs))
        for req in reqs:
            if self._inflight.get(req.graph_id) is req:
                del self._inflight[req.graph_id]
            for fut in req.futures:
                fut.set_exception(err)

    def _note_flush(self, key: BucketKey, live: int, out, secs: float) -> None:
        """Fold one flush's outcome into the per-bucket counter table and
        the metrics registry.  Device workload counters are present only
        when the dispatch ran with ``telemetry=True``; live lanes only —
        dummy pad lanes are trivial and contribute nothing anyway."""
        lbl = key.label
        delta = {"flushes": 1, "solved": live,
                 "cycles": int(out.cycles[:live].sum()),
                 "gr_sweeps": int(out.gr_sweeps)}
        if out.pushes is not None:
            delta["pushes"] = int(out.pushes[:live].sum())
            delta["relabels"] = int(out.relabels[:live].sum())
            delta["active_sum"] = int(out.active_sum[:live].sum())
            delta["frontier_sum"] = int(out.frontier_sum[:live].sum())
        bc = self._bucket_counts.setdefault(lbl, {})
        for name, v in delta.items():
            bc[name] = bc.get(name, 0) + v
            counter(f"serve.{name}", bucket=lbl).inc(v)
        histogram("serve.flush_s", bucket=lbl).observe(secs)
        # recent flush wall clock, EWMA'd: the basis of Overloaded's
        # retry-after hint
        prev = self._flush_ewma.get(lbl)
        self._flush_ewma[lbl] = secs if prev is None \
            else 0.7 * prev + 0.3 * secs

    # -- phase-2 correction pool --------------------------------------------

    def _correct_batch(self, target: WarmStartHandle) -> None:
        """Phase-2-correct ``target`` — and, in the same device dispatch,
        up to a batch's worth of the oldest other handles still awaiting
        correction, so later resubmits usually find their handle already
        corrected.  The group is packed to its own largest member, with
        no dummy lanes: the reference pads it to a canonical shape with
        2x headroom to bound its XLA compiles, which here would only add
        padded vertices and arcs to every sweep (the corrected rows are
        the same).  ``ServiceConfig.resolve_phase2_kernel`` decides
        whether the pooled sweeps run on the min-search kernel (one launch
        a step for the whole group) or the plain scan selector
        (identical results).
        """
        t0 = time.perf_counter()
        if self.config.validate_handles:
            # a poisoned preflow would fail the batched phase-2 leftover
            # check as a raw RuntimeError; surface the typed error instead
            target.validate()
        cap = batched.round_up_pow2(self.config.max_batch)
        group = [target]
        while self._pending_correction and len(group) < cap:
            h = self._pending_correction.popleft()()
            if h is None or h.corrected or h is target:
                continue
            if self.config.validate_handles:
                try:
                    h.validate()
                except HandleCorrupted:
                    # poisoned pool-mate: leave it out of the group — it
                    # will be quarantined if its entry is ever reused
                    counter("serve.pool_skipped_invalid").inc()
                    continue
            group.append(h)
        insts = [(h.residual, h.s, h.t) for h in group]
        states = [(h._res, np.zeros(h.residual.n, batched.STATE_DTYPE),
                   h._e) for h in group]
        bg, meta, res0, _ = batched.pack_instances(insts, device=self.device)
        state = batched.pack_states(states, meta.n, meta.num_arcs,
                                    device=self.device)
        shape = BucketKey(n_pad=meta.n, arc_pad=meta.num_arcs,
                          deg_max=meta.deg_max)
        with span("serve.phase2", group=len(group), batch=len(group),
                  shape=shape.label):
            if self.config.resolve_phase2_kernel():
                from repro_torch.kernels import ops as kops

                corrected, leftover = batched.batched_phase2(
                    bg, meta, res0, state,
                    minh_fn=kops.min_neighbor_minh_fn())
            else:
                corrected, leftover = batched.batched_phase2(
                    bg, meta, res0, state, scan=True)
            cres = corrected.res.cpu().numpy()
            ce = corrected.e.cpu().numpy()
            batched.check_phase2_leftover(leftover)
        counter("serve.phase2_corrections").inc(len(group))
        self.phase2_time_s += time.perf_counter() - t0
        for i, h in enumerate(group):
            h._install_corrected(cres[i, : h.residual.num_arcs].copy(),
                                 ce[i, : h.residual.n].copy())

    # -- streaming sessions -------------------------------------------------

    def open_stream(self, graph: Graph, s: int, t: int,
                    max_versions: int = 8) -> str:
        """Open a long-lived streaming session on ``graph``: solve it once
        (through the normal bucketed path — the initial solve microbatches
        with other traffic) and retain the result as version 0 of a
        bounded ``VersionChain``.  Returns the ``stream_id`` that
        addresses the session in ``stream_apply`` / ``stream_query``."""
        result = self.submit(graph, s, t).result()
        entry = self.results.get(result.graph_id)
        assert entry is not None, "initial stream solve not cached"
        self.n_streams_opened += 1
        stream_id = f"s{self.n_streams_opened}-{result.graph_id[:12]}"
        chain = VersionChain(max_versions)
        chain.append(entry.handle, entry.maxflow, parent=None)
        self._streams[stream_id] = StreamSession(
            stream_id=stream_id, s=int(s), t=int(t), chain=chain)
        counter("serve.streams_opened").inc()
        return stream_id

    def _stream(self, stream_id: str) -> StreamSession:
        sess = self._streams.get(stream_id)
        if sess is None:
            raise KeyError(f"unknown or closed stream {stream_id!r}")
        return sess

    def _drain_stream(self, sess: StreamSession) -> None:
        """Force the session's pending applies so the chain's latest
        version reflects every accepted event (applies chain linearly —
        the next one must warm-start from a solved base)."""
        while sess.pending:
            sess.pending.pop(0).result()

    def stream_apply(self, stream_id: str, events) -> MaxflowFuture:
        """Fold a batch of edit events into a new version of the stream.

        The incremental re-solve rides the SAME shape buckets as one-shot
        submissions, so update events from many concurrent streams pool
        into shared microbatched flushes.  An apply whose reroute already
        restores maximality resolves immediately, without any dispatch.
        The future's ``MaxflowResult.version`` is the chain version the
        apply created; exceptions (missing arc, capacity below zero,
        self-loops) raise here, at admission."""
        return self.stream_apply_many([(stream_id, events)])[0]

    def stream_apply_many(self, items) -> list:
        """``stream_apply`` over many ``(stream_id, events)`` pairs with
        the decrease-reroute drains POOLED: every stream's cancelled
        overflow is packed into one stacked batch and drained by a single
        engine dispatch per chunk (``reroute.drain_prepared``), instead
        of one device round-trip per stream.  Returns one future per
        item, in order; results are bit-for-bit what per-item
        ``stream_apply`` produces.  Items naming the same stream chain
        linearly (an apply must warm-start from its predecessor's solved
        base), so repeats of a stream fall into later pooled waves."""
        items = list(items)
        out: list = [None] * len(items)
        todo = list(range(len(items)))
        while todo:
            wave, defer, seen = [], [], set()
            for i in todo:
                sid = items[i][0]
                (defer if sid in seen else wave).append(i)
                seen.add(sid)
            pending, error = [], None
            for i in wave:
                try:
                    pending.append((i, self._stream_prepare(*items[i])))
                except Exception as exc:  # admission error: finish the
                    error = exc           # already-prepared wave first
                    break
            if pending:
                use_kernel = all(p.handle._use_kernel for _, p in pending)
                rrs = reroute.drain_prepared(
                    [p.prep for _, p in pending], use_kernel=use_kernel,
                    device=self.device)
                for (i, p), rr in zip(pending, rrs):
                    out[i] = self._stream_finish(p, rr)
            if error is not None:
                raise error
            todo = defer
        return out

    def _stream_prepare(self, stream_id: str, events) -> "_PendingApply":
        """Admission half of one stream apply: drain the session, fold
        structural inserts into a rebuilt handle, and stage the capacity
        deltas as a ``reroute.PreparedReroute`` — no solver dispatch.
        Raises at admission exactly like ``stream_apply``."""
        sess = self._stream(stream_id)
        self._drain_stream(sess)
        base = sess.chain.get(sess.chain.latest)
        handle = base.handle
        if self.config.validate_handles:
            try:
                handle.validate()
            except HandleCorrupted:
                # poisoned chain entry: quarantine + cold rebuild in
                # place, then apply the events on the pristine base
                handle = self._quarantine(record=base)
        with span("stream.apply", stream=stream_id, version=base.version):
            inserts, deltas = normalize_events(handle.residual, events)
            nev = len(inserts) + len(deltas)
            if nev == 0:
                raise ValueError("empty update event set")
            p2_before = self.phase2_time_s
            if inserts:
                sess.rebuilds += 1
                counter("stream.structural_rebuilds").inc()
                r2, res2, e2 = rebuild_with_state(
                    handle.residual, *handle.arrays(),
                    [(u, v) for u, v, _ in inserts])
                handle = WarmStartHandle(
                    r2, handle.s, handle.t, res2, e2, corrected=True,
                    use_kernel=handle._use_kernel, device=handle.device)
                deltas = deltas + [(u, v, cap) for u, v, cap in inserts]
            sess.applies += 1
            sess.events += nev
            prep = handle.prepare_updates(deltas)
        return _PendingApply(
            sess=sess, handle=handle, prep=prep,
            graph_id=f"{stream_id}/{sess.applies}", parent=base.version,
            events=nev, phase2_s=self.phase2_time_s - p2_before)

    def _stream_finish(self, p: "_PendingApply", rr) -> MaxflowFuture:
        """Completion half: turn one drained reroute back into a chained
        version — answered inline when the reroute already restored
        maximality, else enqueued onto the shape buckets."""
        sess = p.sess
        r2, warm = p.handle.finish_updates(rr)

        def register(solved_handle, maxflow: int) -> int:
            return sess.chain.append(solved_handle, maxflow,
                                     parent=p.parent, events=p.events)

        if warm is not None:
            res, _, e = warm
            inner = np.ones(r2.n, bool)
            inner[sess.t] = False
            if not (e[inner] > 0).any():
                # reroute restored maximality: answer without dispatch
                sess.noop_applies += 1
                counter("serve.stream_noop_applies").inc()
                h2 = WarmStartHandle(
                    r2, sess.s, sess.t, res, e, corrected=True,
                    use_kernel=p.handle._use_kernel, device=p.handle.device)
                version = register(h2, int(e[sess.t]))
                fut = MaxflowFuture()
                fut.set_result(MaxflowResult(
                    graph_id=p.graph_id, maxflow=int(e[sess.t]),
                    warm=True, phase2_s=p.phase2_s, version=version))
                return fut
        # warm is None only in the defensive reroute-stall case; the
        # request then enters the bucket cold (preflow from scratch)
        fut = self._enqueue(p.graph_id, r2, sess.s, sess.t, warm=warm,
                            phase2_s=p.phase2_s, on_solved=register)
        sess.pending.append(fut)
        return fut

    def stream_query(self, stream_id: str,
                     version: int | None = None) -> MaxflowResult:
        """Answer from the retained chain (default: latest version —
        pending applies are flushed first so the answer reflects every
        accepted event).  Raises ``KeyError`` for an evicted or
        never-issued version."""
        sess = self._stream(stream_id)
        if version is None or version not in sess.chain:
            self._drain_stream(sess)
        with span("stream.query", stream=stream_id):
            rec = sess.chain.get(
                sess.chain.latest if version is None else int(version))
        sess.queries += 1
        counter("serve.stream_queries").inc()
        return MaxflowResult(graph_id=stream_id, maxflow=rec.value,
                             warm=rec.parent is not None,
                             version=rec.version)

    def stream_pin(self, stream_id: str, version: int) -> None:
        """Hold ``version`` against chain eviction until unpinned."""
        sess = self._stream(stream_id)
        if version not in sess.chain:
            self._drain_stream(sess)
        sess.chain.pin(version)

    def stream_unpin(self, stream_id: str, version: int) -> None:
        self._stream(stream_id).chain.unpin(version)

    def close_stream(self, stream_id: str) -> dict:
        """Flush the session's pending applies, release every retained
        version and return the session's final stats."""
        sess = self._stream(stream_id)
        self._drain_stream(sess)
        del self._streams[stream_id]
        counter("serve.streams_closed").inc()
        return {"applies": sess.applies, "events": sess.events,
                "queries": sess.queries, "rebuilds": sess.rebuilds,
                "noop_applies": sess.noop_applies,
                "chain": sess.chain.stats()}

    # -- introspection ------------------------------------------------------

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._buckets.values())

    def stats(self) -> dict:
        return {
            "submitted": self.n_submitted,
            "resubmitted": self.n_resubmitted,
            "coalesced": self.n_coalesced,
            "solved": self.n_solved,
            "batches": self.n_batches,
            "pending": self.pending,
            "buckets": len(self._buckets),
            "phase2_time_s": self.phase2_time_s,
            "sweep_time_s": self.sweep_time_s,
            "gr_sweeps": self.gr_sweeps,
            "result_cache": {"entries": len(self.results),
                             "hits": self.results.hits,
                             "misses": self.results.misses},
            "executables": self.executables.stats(),
            # per-bucket device workload counters (live lanes only).
            # pushes/relabels/... appear when ServiceConfig.telemetry
            "bucket_counters": {lbl: dict(bc) for lbl, bc in
                                sorted(self._bucket_counts.items())},
            # per-bucket measured mode policy (empty under a fixed mode)
            "mode_policy": {k.label: p.stats()
                            for k, p in sorted(self._policies.items())},
            "streams": {
                "open": len(self._streams),
                "opened": self.n_streams_opened,
                "applies": sum(s.applies for s in self._streams.values()),
                "events": sum(s.events for s in self._streams.values()),
                "queries": sum(s.queries for s in self._streams.values()),
                "rebuilds": sum(s.rebuilds for s in self._streams.values()),
                "noop_applies": sum(s.noop_applies
                                    for s in self._streams.values()),
            },
            # overload / fault behaviour (docs/ROBUSTNESS.md)
            "robustness": {
                "rejected": self.n_rejected,
                "shed": self.n_shed,
                "expired_at_admission": self.n_expired_admission,
                "retries": self.n_retries,
                "transient_demotions": self.n_transient_demotions,
                "sticky_demotions": sum(
                    lad.demotions for lad in self._ladders.values()),
                "host_fallbacks": self.n_host_fallbacks,
                "quarantined": self.n_quarantined,
                "dispatch_failed": self.n_dispatch_failed,
                "budget_exhausted": self.n_budget_exhausted,
                "ladders": {k.label: lad.stats() for k, lad in
                            sorted(self._ladders.items())
                            if lad.demotions or lad.failures},
                "faults_injected": (self.faults.stats()
                                    if self.faults is not None else None),
            },
        }

    def telemetry_snapshot(self) -> dict:
        """One JSON-clean export: service ``stats()`` plus the full
        process-global metrics registry (``serve.*`` counters, cache and
        mode-policy counters, latency histograms).  This is what
        ``serve_maxflow --metrics-out`` writes."""
        return to_jsonable({"stats": self.stats(),
                            "metrics": REGISTRY.snapshot()})
