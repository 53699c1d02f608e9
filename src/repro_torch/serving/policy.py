"""Measured per-bucket kernel-mode policy for the serving tier (a copy of
the JAX package's ``repro.serving.policy``).

Which push-relabel step strategy is fastest is a *per-shape-class*
question: the fused discharge kernel amortises launch overhead on small
padded buckets but serialises over vertices, the min-search kernel wins
where the search dominates, and the plain PyTorch ``vc`` chain wins
wherever the scatter stages dominate.  Pinning
one global mode therefore leaves throughput behind on every bucket the
pin is wrong for.

``BucketModePolicy`` turns the choice into a measurement: under
``ServiceConfig(mode="auto")`` each shape bucket spends its first few
flushes trialling the candidate modes (``vc``, ``vc_kernel``,
``vc_fused``, plus ``vc_kernel_bsearch`` when the packed layout is
head-sorted), records the **per-cycle** cost of each (normalising by the
work the flush happened to carry, so trials on different microbatches
compare fairly), and pins the winner for every later flush.  Samples of
a signature's first dispatch (kernel-library load, allocator growth) are
excluded — the service re-dispatches such a flush once, warm, before
recording (results are identical: the solve is a pure function of the
packed batch).

The table is observable end-to-end: ``MaxflowService.stats()`` embeds
``stats()`` of every bucket's policy, and each trial dispatch is also a
signature in the ``ExecutableCache`` audit.  A fixed
``ServiceConfig.mode`` (the escape hatch) bypasses all of this.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.pushrelabel import ALL_MODES, KERNEL_MODES
from repro_torch.obs import metrics

#: modes the auto policy trials, in trial order.  'tc' is excluded by
#: design: it is the paper's imbalance baseline, strictly dominated on
#: every workload the serving tier targets.
CANDIDATE_MODES = ("vc", "vc_kernel", "vc_fused")


def candidate_modes(layout: str) -> tuple[str, ...]:
    """Candidates for a bucket under the service's residual layout:
    the binary-search reverse lookup joins only when segments are
    head-sorted (``bcsr``)."""
    if layout == "bcsr":
        return CANDIDATE_MODES + ("vc_kernel_bsearch",)
    return CANDIDATE_MODES


@dataclasses.dataclass
class BucketModePolicy:
    """Trial-then-pin mode choice for one shape bucket.

    ``choose()`` returns the mode the next flush should run: the first
    candidate still missing a clean sample while measuring, the pinned
    winner afterwards.  ``record()`` files one clean (non-compile)
    sample and pins as soon as every surviving candidate has
    ``trials`` of them.
    """

    candidates: tuple[str, ...]
    trials: int = 1
    pinned: str | None = None
    flushes: int = 0
    samples: dict[str, list[float]] = dataclasses.field(
        default_factory=dict)
    #: optional bucket label; when set, trial/pin outcomes are mirrored
    #: into the metrics registry under ``serve.mode_trials{bucket,mode}``
    #: and ``serve.mode_pins{bucket,mode}``
    label: str | None = None

    def __post_init__(self):
        bad = [m for m in self.candidates if m not in ALL_MODES]
        if bad:
            raise ValueError(f"unknown candidate modes {bad}")
        if self.trials < 1:
            raise ValueError(f"trials must be >= 1, got {self.trials}")
        self.candidates = tuple(self.candidates)
        for m in self.candidates:
            self.samples.setdefault(m, [])

    def choose(self) -> str:
        if self.pinned is not None:
            return self.pinned
        for m in self.candidates:
            if len(self.samples[m]) < self.trials:
                return m
        self._pin()
        return self.pinned

    def record(self, mode: str, seconds: float, cycles: int) -> None:
        """File one clean measurement of ``mode``: ``seconds`` of flush
        wall clock over ``cycles`` push-relabel iterations executed (the
        normaliser that makes trials on different microbatches
        comparable)."""
        self.flushes += 1
        if self.pinned is not None or mode not in self.samples:
            return
        self.samples[mode].append(seconds / max(int(cycles), 1))
        if self.label is not None:
            metrics.counter("serve.mode_trials",
                            bucket=self.label, mode=mode).inc()
        if all(len(self.samples[m]) >= self.trials
               for m in self.candidates):
            self._pin()

    def disqualify(self, mode: str) -> None:
        """Remove a candidate this bucket cannot run (e.g. a pack came
        out without head-sorted segments, so ``vc_kernel_bsearch`` could
        corrupt residuals).  Conservative: once disqualified, the mode
        never rejoins this bucket's trials."""
        self.candidates = tuple(m for m in self.candidates if m != mode)
        self.samples.pop(mode, None)
        if self.pinned == mode:
            self.pinned = None

    def pin_now(self) -> None:
        """Stop measuring immediately: pin the best mode seen so far
        (``'vc'`` when no clean sample exists yet)."""
        self._pin()

    def _pin(self) -> None:
        measured = [m for m in self.candidates if self.samples[m]]
        if not measured:  # nothing survived (all disqualified): fall back
            self.pinned = "vc"
        else:
            self.pinned = min(
                measured, key=lambda m: min(self.samples[m]))
        if self.label is not None:
            metrics.counter("serve.mode_pins", bucket=self.label,
                            mode=self.pinned).inc()

    @property
    def cost(self) -> dict[str, float]:
        """Best measured per-cycle seconds per candidate (measured only)."""
        return {m: min(v) for m, v in self.samples.items() if v}

    def uses_kernels(self) -> bool:
        return self.pinned in KERNEL_MODES

    def stats(self) -> dict:
        """JSON-safe rendering for ``MaxflowService.stats()``."""
        return {
            "pinned": self.pinned,
            "flushes": self.flushes,
            "candidates": list(self.candidates),
            "per_cycle_s": {m: round(c, 9) for m, c in self.cost.items()},
        }


# -- graceful degradation ladder ---------------------------------------------

#: sentinel "mode" below every device mode: the sequential host reference
#: solver (Dinic).  Never trialled, never pinned — only reached by demotion.
HOST_REF = "host_ref"

#: demotion order, most- to least-specialised.  A dispatch failure at one
#: rung retries at the next; 'tc' (not listed) demotes straight to 'vc''s
#: rung since both are plain PyTorch chains of equivalent generality.
LADDER = ("vc_fused", "vc_kernel_bsearch", "vc_kernel", "vc", HOST_REF)


def ladder_rank(mode: str) -> int:
    """Position of ``mode`` on the ladder ('tc' ranks with 'vc')."""
    if mode == "tc":
        return LADDER.index("vc")
    return LADDER.index(mode)


def demote_mode(mode: str) -> str | None:
    """The next-less-specialised mode to retry with after ``mode``
    failed, or None when ``mode`` is already the host reference."""
    rank = ladder_rank(mode)
    if rank + 1 >= len(LADDER):
        return None
    return LADDER[rank + 1]


@dataclasses.dataclass
class BucketLadder:
    """Sticky degradation state for one bucket.

    Within a single flush, failures walk down ``LADDER`` transiently
    (retry the flush one rung lower).  Across flushes, ``note_failure``
    accumulates; once a mode has failed ``demote_after`` times total, the
    bucket's *ceiling* drops below it permanently — later flushes start
    from the capped rung instead of re-learning the failure.  Successes
    do not raise the ceiling (conservative: a flaky kernel that works
    sometimes is still flaky)."""

    demote_after: int = 2
    #: highest ladder rank this bucket may start a flush from (0 = top)
    ceiling: int = 0
    failures: dict[str, int] = dataclasses.field(default_factory=dict)
    demotions: int = 0
    label: str | None = None

    def clamp(self, mode: str) -> str:
        """The mode a flush should actually start with: ``mode`` unless
        the sticky ceiling has dropped below it."""
        if mode == HOST_REF:
            return mode
        rank = ladder_rank(mode)
        return mode if rank >= self.ceiling else LADDER[self.ceiling]

    def note_failure(self, mode: str) -> None:
        """Record one dispatch failure of ``mode``; may lower the sticky
        ceiling (a permanent demotion, counted + mirrored to metrics)."""
        self.failures[mode] = self.failures.get(mode, 0) + 1
        rank = ladder_rank(mode)
        if (self.failures[mode] >= self.demote_after
                and rank + 1 < len(LADDER) and self.ceiling <= rank):
            self.ceiling = rank + 1
            self.demotions += 1
            if self.label is not None:
                metrics.counter("serve.demotions", bucket=self.label,
                                mode=mode).inc()

    def stats(self) -> dict:
        return {
            "ceiling_mode": LADDER[self.ceiling],
            "demotions": self.demotions,
            "failures": dict(self.failures),
        }
