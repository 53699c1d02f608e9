"""Fault tolerance runtime (a copy of the JAX package's
``repro.runtime.fault``): injected-fault plans for the serving tier, plus
the training loop's checkpoint/restart watchdog.

:class:`FaultPlan` is a seed-deterministic fault injector
``MaxflowService`` accepts (``MaxflowService(cfg, faults=plan)``).  It
can

* raise :class:`InjectedFault` from solve dispatches (transient, or
  pinned to specific kernel modes to force the degradation ladder),
* corrupt freshly cached warm-start handles (negative/overflowed
  residuals, broken excess conservation — the int-domain analogue of
  NaN poisoning) so the pre-reuse validation and quarantine paths are
  exercised end-to-end,
* stretch dispatches (``slow_solve_s``) so deadline expiry and shedding
  trigger under test.

Queue floods are a *workload* shape, not a fault: use
``repro_torch.serving.workload.synthesize(process="flood")``.  Every
injection is counted (``stats()``) so chaos tests can assert the planned
faults actually fired.

**Training loop** — steps are deterministic, so the recovery contract
is simple: on any step failure (device loss, preemption, injected fault)
-> restore the latest committed checkpoint (params, optimizer,
data-pipeline state) and replay.  ``run_loop`` is the single-process
embodiment; on a real cluster the same loop runs under a process-restart
supervisor and ``restore`` picks up the shared filesystem checkpoint.
Straggler mitigation: per-step wall times feed an EWMA; steps slower than
``straggler_factor`` x EWMA are counted and surfaced.  The loss is read
to the host once a step (``LoopReport.last_loss``), as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.checkpoint import checkpoint as C


class InjectedFault(RuntimeError):
    """A deliberately injected dispatch failure.  Distinguishable from
    organic errors in logs/tests; the service sends it down the
    degradation ladder (retry -> demote -> host fallback), which on the
    card takes no other exception but ``BudgetExhausted``."""


#: handle-corruption flavours ``FaultPlan.corrupt_handle`` cycles through —
#: each violates a different invariant ``WarmStartHandle.validate`` checks
CORRUPTION_KINDS = ("negative_res", "pair_overflow", "negative_excess",
                    "conservation")


@dataclasses.dataclass
class FaultPlan:
    """A seed-deterministic chaos schedule for ``MaxflowService``.

    Rates are per-opportunity probabilities drawn from one
    ``numpy`` generator seeded by ``seed`` — the same plan against the
    same workload injects the same faults, so chaos tests are exactly
    reproducible.

    * ``dispatch_error_rate`` — chance any solve dispatch raises
      ``InjectedFault`` (transient; retries usually clear it).
    * ``fail_modes`` + ``fail_mode_rate`` — targeted persistent failures:
      dispatches running one of these solver modes fail with probability
      ``fail_mode_rate`` (1.0 = always), until ``fail_mode_limit`` total
      injections.  This is how a test forces the ladder to demote
      ``vc_fused -> vc_kernel -> vc`` (or to the host reference when
      ``'vc'`` is included).
    * ``corrupt_handle_rate`` — chance a freshly cached warm-start handle
      has its residual/excess arrays poisoned in place (see
      ``CORRUPTION_KINDS``); caught by validation at reuse, never served.
    * ``slow_solve_rate`` / ``slow_solve_s`` — chance a dispatch sleeps
      ``slow_solve_s`` first (deadline pressure).
    """

    seed: int = 0
    dispatch_error_rate: float = 0.0
    fail_modes: tuple = ()
    fail_mode_rate: float = 1.0
    fail_mode_limit: int | None = None
    corrupt_handle_rate: float = 0.0
    slow_solve_rate: float = 0.0
    slow_solve_s: float = 0.0

    def __post_init__(self):
        for name in ("dispatch_error_rate", "fail_mode_rate",
                     "corrupt_handle_rate", "slow_solve_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        self.fail_modes = tuple(self.fail_modes)
        self._rng = np.random.default_rng(self.seed)
        self.injected = {"dispatch_errors": 0, "mode_failures": 0,
                         "corruptions": 0, "slow_solves": 0}

    # -- dispatch-side hooks ------------------------------------------------

    def before_dispatch(self, mode: str, where: str = "") -> None:
        """Called right before every protected solve dispatch.  May sleep
        (slow-solve injection) and/or raise ``InjectedFault``."""
        if self.slow_solve_rate and self._rng.random() < self.slow_solve_rate:
            self.injected["slow_solves"] += 1
            time.sleep(self.slow_solve_s)
        if (mode in self.fail_modes
                and (self.fail_mode_limit is None
                     or self.injected["mode_failures"] < self.fail_mode_limit)
                and self._rng.random() < self.fail_mode_rate):
            self.injected["mode_failures"] += 1
            raise InjectedFault(
                f"injected persistent failure of mode {mode!r} ({where})")
        if (self.dispatch_error_rate
                and self._rng.random() < self.dispatch_error_rate):
            self.injected["dispatch_errors"] += 1
            raise InjectedFault(f"injected dispatch error ({where})")

    # -- state poisoning ----------------------------------------------------

    def corrupt_handle(self, handle) -> str | None:
        """Maybe poison a freshly cached ``WarmStartHandle`` in place.
        Returns the corruption kind applied, or None.  Each kind breaks
        one invariant of ``WarmStartHandle.validate`` — the int-domain
        analogues of NaN/overflow poisoning on a float pipeline."""
        if not (self.corrupt_handle_rate
                and self._rng.random() < self.corrupt_handle_rate):
            return None
        # handle arrays may be read-only views of device buffers; replace
        # them with writable copies so the poison actually lands
        res = np.array(handle._res)
        e = np.array(handle._e)
        handle._res, handle._e = res, e
        if res.size == 0 or e.size <= 2:
            return None
        kind = CORRUPTION_KINDS[
            self.injected["corruptions"] % len(CORRUPTION_KINDS)]
        a = int(self._rng.integers(res.size))
        others = [v for v in range(e.size) if v not in (handle.s, handle.t)]
        v = int(others[self._rng.integers(len(others))]) if others \
            else handle.t
        if kind == "negative_res":
            res[a] = -1 - int(self._rng.integers(100))
        elif kind == "pair_overflow":  # breaks pair-capacity conservation
            res[a] += np.int32(1) << 29
        elif kind == "negative_excess":
            e[v] = -7
        else:  # "conservation": excess without matching flow
            e[v] += 3
        self.injected["corruptions"] += 1
        return kind

    def stats(self) -> dict:
        """JSON-clean injection counts (what actually fired)."""
        return dict(self.injected)


#: training-loop section below ------------------------------------------------


@dataclasses.dataclass
class LoopReport:
    steps_done: int = 0
    restarts: int = 0
    straggler_steps: int = 0
    last_loss: float = float("nan")
    step_times: list = dataclasses.field(default_factory=list)


def run_loop(*, ckpt_dir: str, total_steps: int, make_state: Callable,
             step_fn: Callable, pipeline, ckpt_every: int = 20,
             max_restarts: int = 5, straggler_factor: float = 3.0,
             fault_hook: Callable | None = None,
             device=None) -> LoopReport:
    """Run ``total_steps`` of training with checkpoint/restart.

    make_state() -> (params, opt_state) freshly initialised.
    step_fn(params, opt_state, batch) -> (params, opt_state, metrics).
    fault_hook(step) may raise to inject failures (tests).
    ``device`` is where a restored checkpoint's leaves go (``None``: the
    card).  Each of ``step_times`` ends after the step's loss is read, so
    on the card it holds the step's device work, not only its enqueue.
    """
    report = LoopReport()
    restarts = 0
    while True:
        try:
            tree, extra = C.restore(ckpt_dir, device=device)
            if tree is None:
                params, opt_state = make_state()
                start = 0
            else:
                params, opt_state = tree["params"], tree["opt_state"]
                pipeline.load_state_dict(extra["pipeline"])
                start = int(extra["step"])
            ewma = None
            for step in range(start, total_steps):
                t0 = time.time()
                if fault_hook is not None:
                    fault_hook(step)
                batch = pipeline.next()
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
                # the loss read waits for the step on the card, so ``dt``
                # is the step's time there, not only its host enqueue
                report.last_loss = float(metrics["loss"])
                dt = time.time() - t0
                report.step_times.append(dt)
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
                if dt > straggler_factor * ewma:
                    report.straggler_steps += 1
                report.steps_done = step + 1
                if (step + 1) % ckpt_every == 0 or step + 1 == total_steps:
                    C.save(ckpt_dir, step + 1,
                           {"params": params, "opt_state": opt_state},
                           extra={"step": step + 1,
                                  "pipeline": pipeline.state_dict()})
                    C.prune(ckpt_dir)
            return report
        except KeyboardInterrupt:
            raise
        except Exception:
            restarts += 1
            report.restarts = restarts
            if restarts > max_restarts:
                raise
            # fall through: restore from latest checkpoint and replay
