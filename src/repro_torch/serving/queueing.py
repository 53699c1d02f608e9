"""Shape-bucketed microbatch queueing for the max-flow service (a copy of
the JAX package's ``repro.serving.queueing``).

Every distinct padded shape is one dispatch signature, so admission
control's job is to map arbitrary incoming ``(n, A, deg_max)`` instances
onto a small, fixed set of shape classes.  ``bucket_for`` rounds each
dimension up to the next power of two (geometric bucketing: at most
~log2(max_n) * log2(max_A) classes ever exist, and padding waste is < 2x
per axis).  Requests queue per bucket and are released as microbatches —
either when ``max_batch`` are waiting or when the oldest request has waited
``max_wait_s`` (latency bound) — and the batch dimension itself is rounded
up to a power of two so batch-size jitter does not mint new signatures.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, NamedTuple

import numpy as np

from repro_torch.core.batched import round_up_pow2
from repro_torch.core.csr import ResidualCSR
from repro_torch.obs import metrics


class BucketKey(NamedTuple):
    """Padded shape class: every instance in the bucket fits these dims."""

    n_pad: int
    arc_pad: int
    deg_max: int

    @property
    def label(self) -> str:
        """The one human/JSON rendering of a bucket — ``stats()`` tables,
        ``pin_modes()`` and the benchmarks all key on this string."""
        return f"n{self.n_pad}a{self.arc_pad}d{self.deg_max}"


def bucket_for(r: ResidualCSR, min_n: int = 16, min_arcs: int = 32,
               min_deg: int = 4) -> BucketKey:
    return BucketKey(
        n_pad=round_up_pow2(r.n, min_n),
        arc_pad=round_up_pow2(max(r.num_arcs, 1), min_arcs),
        deg_max=round_up_pow2(max(r.deg_max, 1), min_deg),
    )


class MaxflowFuture:
    """Synchronous future: ``result()`` forces the service to flush the
    owning bucket if the value is not ready yet.

    A future resolves with either a value or a typed exception
    (``DeadlineExceeded`` when the request expired in queue,
    ``DispatchFailed`` when every rung of the degradation ladder failed);
    ``result()`` re-raises, ``exception()`` peeks without raising."""

    def __init__(self, force: Callable[[], None] | None = None):
        self._force = force
        self._done = False
        self._value = None
        self._exc: BaseException | None = None
        self.created_at = time.perf_counter()
        self.completed_at: float | None = None

    def done(self) -> bool:
        return self._done

    def set_result(self, value) -> None:
        self._value = value
        self._done = True
        self.completed_at = time.perf_counter()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._done = True
        self.completed_at = time.perf_counter()

    @property
    def latency_s(self) -> float | None:
        if self.completed_at is None:
            return None
        return self.completed_at - self.created_at

    def _resolve(self) -> None:
        if not self._done:
            if self._force is None:
                raise RuntimeError("result not ready and no flush hook")
            self._force()
        assert self._done, "service flush did not resolve this future"

    def exception(self) -> BaseException | None:
        self._resolve()
        return self._exc

    def result(self):
        self._resolve()
        if self._exc is not None:
            raise self._exc
        return self._value


@dataclasses.dataclass
class Request:
    """One queued solve.  ``warm`` carries ``(res, h, e)`` host arrays to
    enter the solver from a cached residual instead of a fresh preflow.
    ``futures`` holds every caller waiting on this instance — duplicate
    in-flight submissions coalesce onto one solve."""

    graph_id: str
    residual: ResidualCSR
    s: int
    t: int
    futures: list[MaxflowFuture]
    warm: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None
    phase2_s: float = 0.0  # device phase-2 time this admission triggered
    # streaming hook: called once with (handle, maxflow) when the request
    # solves, before its futures resolve; its return value (a chain
    # version id, or None) is surfaced as MaxflowResult.version
    on_solved: Callable | None = None
    enqueued_at: float = dataclasses.field(default_factory=time.perf_counter)
    # absolute ``time.perf_counter()`` expiry, or None = no deadline.
    # Expired requests are shed before dispatch (they never pay for a
    # solve) and their futures carry ``DeadlineExceeded``.
    deadline_at: float | None = None

    def expired(self, now: float | None = None) -> bool:
        if self.deadline_at is None:
            return False
        return (time.perf_counter() if now is None else now) \
            >= self.deadline_at


class MicrobatchQueue:
    """Per-bucket FIFO with batch-release policy, a bounded depth
    (admission control rejects pushes past ``max_queue`` — after shedding
    expired work first) and deadline awareness: the queue flushes early
    when its most urgent deadline is within ``deadline_slack_s``."""

    def __init__(self, key: BucketKey, max_batch: int = 8,
                 max_wait_s: float = float("inf"),
                 max_queue: int | None = None,
                 deadline_slack_s: float = 0.0):
        self.key = key
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_queue = max_queue
        self.deadline_slack_s = deadline_slack_s
        self._q: deque[Request] = deque()

    def push(self, req: Request) -> None:
        self._q.append(req)
        self._depth_gauge()

    def full(self) -> bool:
        return self.max_queue is not None and len(self._q) >= self.max_queue

    def _depth_gauge(self) -> None:
        metrics.gauge("serve.queue_depth",
                      bucket=self.key.label).set(len(self._q))

    def __len__(self) -> int:
        return len(self._q)

    def next_deadline(self) -> float | None:
        """Earliest ``deadline_at`` among queued requests, or None."""
        dls = [r.deadline_at for r in self._q if r.deadline_at is not None]
        return min(dls) if dls else None

    def shed_expired(self, now: float | None = None) -> list[Request]:
        """Remove and return every queued request whose deadline has
        passed.  The caller fails their futures with ``DeadlineExceeded``
        — shed work never reaches a solver."""
        now = time.perf_counter() if now is None else now
        if not any(r.expired(now) for r in self._q):
            return []
        shed = [r for r in self._q if r.expired(now)]
        self._q = deque(r for r in self._q if not r.expired(now))
        self._depth_gauge()
        return shed

    def ready(self, now: float | None = None) -> bool:
        if not self._q:
            return False
        if len(self._q) >= self.max_batch:
            return True
        now = time.perf_counter() if now is None else now
        if (now - self._q[0].enqueued_at) >= self.max_wait_s:
            return True
        # deadline pressure: flush before the most urgent request expires
        dl = self.next_deadline()
        return dl is not None and (dl - now) <= self.deadline_slack_s

    def pop_batch(self) -> list[Request]:
        out = []
        while self._q and len(out) < self.max_batch:
            out.append(self._q.popleft())
        self._depth_gauge()
        return out

    def padded_batch_size(self, live: int, pad_full: bool = True) -> int:
        """The dispatch batch dim.  ``pad_full`` (default) always pads to
        the bucket's full pow2 capacity — exactly one executable per
        bucket, dummy lanes converge instantly; otherwise round the live
        count to the next pow2 (fewer dummy lanes, up to log2(max_batch)
        executables per bucket)."""
        cap = round_up_pow2(self.max_batch)
        return cap if pad_full else min(round_up_pow2(live), cap)
