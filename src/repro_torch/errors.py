"""Typed error taxonomy of the solver tier (a copy of the JAX package's
``repro.errors``, kept whole so both packages raise the same types).

The robustness contract of ``MaxflowService`` is that **no raw exception
escapes the service**: every failure a caller can observe is one of the
types below, each carrying the structured fields a client (or a retry
policy) needs to react — a rejected request knows *when to retry*, an
expired one knows *how late it was*, an exhausted solve knows *how much
budget it burned*.  Internal faults (injected or real) are absorbed by
the degradation ladder (retry -> mode demotion -> host reference solve)
and surface only as counters; see ``docs/ROBUSTNESS.md``.

This module is import-cycle-free by design (stdlib only):
``repro_torch.core`` and ``repro_torch.api`` raise through it.
"""
from __future__ import annotations

__all__ = [
    "ServiceError", "Overloaded", "DeadlineExceeded", "HandleCorrupted",
    "DispatchFailed", "BudgetExhausted",
]


class ServiceError(Exception):
    """Base of every typed error the serving/solver stack raises.

    Callers that want blanket handling catch this; the subclasses carry
    the structured fields.  ``details()`` renders them JSON-clean for
    logs and test assertions.
    """

    def details(self) -> dict:
        return {k: v for k, v in vars(self).items()
                if not k.startswith("_")}


class Overloaded(ServiceError):
    """Admission rejected: the target bucket's queue is full even after
    shedding expired work.  ``retry_after_s`` is the service's estimate
    of when the queue will have drained enough to admit again (based on
    the bucket's recent flush wall clock)."""

    def __init__(self, bucket: str, depth: int, limit: int,
                 retry_after_s: float):
        self.bucket = bucket
        self.depth = int(depth)
        self.limit = int(limit)
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"bucket {bucket} overloaded ({depth}/{limit} queued); "
            f"retry after {self.retry_after_s:.3f}s")


class DeadlineExceeded(ServiceError):
    """The request's deadline passed before it was solved.

    ``where`` is ``'admission'`` (the deadline was already <= 0 at
    submit) or ``'queue'`` (the request expired waiting and was shed
    before dispatch — expired work never pays for a solve).
    """

    def __init__(self, graph_id: str, deadline_s: float, waited_s: float,
                 where: str = "queue"):
        self.graph_id = graph_id
        self.deadline_s = float(deadline_s)
        self.waited_s = float(waited_s)
        self.where = where
        super().__init__(
            f"deadline of {self.deadline_s:.3f}s exceeded at {where} "
            f"(waited {self.waited_s:.3f}s) for {graph_id!r}")


class HandleCorrupted(ServiceError):
    """A cached ``WarmStartHandle`` failed its pre-reuse invariant checks
    (negative residuals, broken pair-capacity conservation, negative or
    non-conserved excess).  The serving tier quarantines the handle and
    falls back to a cold solve instead of warm-starting from garbage."""

    def __init__(self, reasons: list[str]):
        self.reasons = list(reasons)
        super().__init__(
            "warm-start handle failed validation: " + "; ".join(reasons))


class DispatchFailed(ServiceError):
    """Every rung of the degradation ladder — retries at each mode down
    to the host reference solver — failed for one flush.  Terminal: the
    affected requests' futures carry this error."""

    def __init__(self, bucket: str, attempts: int, cause: str):
        self.bucket = bucket
        self.attempts = int(attempts)
        self.cause = cause
        super().__init__(
            f"dispatch failed for bucket {bucket} after {attempts} "
            f"attempts across the degradation ladder: {cause}")


class BudgetExhausted(ServiceError, RuntimeError):
    """The solver's exact ``max_cycles`` budget ran out before
    convergence.  Subclasses ``RuntimeError`` so pre-taxonomy callers
    (``pytest.raises(RuntimeError)``) keep working.

    ``cycles_spent`` is the bulk-synchronous cycle count actually
    executed; ``partial`` records that the solver state at the raise is a
    valid *partial* preflow (further cycles could continue from it), so a
    serving layer can degrade — e.g. re-enter with a bigger budget or
    fall back to the host reference — instead of failing the request.
    """

    def __init__(self, msg: str, cycles_spent: int, limit: int,
                 partial: bool = True):
        self.cycles_spent = int(cycles_spent)
        self.limit = int(limit)
        self.partial = bool(partial)
        super().__init__(msg)
