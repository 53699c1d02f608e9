"""The sweep engine: ONE bulk-synchronous loop runner (port of the JAX
package's ``repro.core.engine``).

Every device loop of the solver has the same shape — a bulk-synchronous
step iterated under an early-exit condition: push-relabel cycles and the
global relabel's Bellman-Ford sweeps.  ``run_bulk_loop`` runs them in
**chunks** of K steps.  Inside a chunk nothing reads the device: each step
evaluates the loop condition on its carry as a 0-d tensor and keeps the
old carry wherever it has gone false (``torch.where(live, new, old)`` on
every tensor of the carry).  The host reads the condition once per chunk
to decide whether to run the next one.

Bit-for-bit parity with a per-step loop comes from that **whole-carry
gating**: a converged state is a fixpoint of every step function here,
and the gate also freezes counters and cycle budgets, so every carry
element equals the exact per-step loop's — the chunked trajectory is the
ungated trajectory, merely evaluated in batches of K.  Cycle and sweep
counts, and exact ``max_cycles`` budgets, therefore match the reference.

Carry contract: the carry is a (named) tuple tree of tensors, ``None``
leaves riding along untouched.  ``cond_fn(carry)`` returns a 0-d bool
tensor computed from the carry alone; ``step_fn(carry)`` keeps the tree
structure, shapes and dtypes.  A step may update a carry leaf in place
and return that same tensor; the gate then leaves it as it is
(``torch.where(live, x, x)`` is ``x``), so such a step must itself leave
the leaf unchanged wherever the gate is closed.  It learns the gate from
the engine: with ``pass_gate=True`` the engine calls ``step_fn(carry,
live)``, ``live`` the 0-d condition it has just computed for this step
(the ``vc_fused`` cycle loops, whose kernel updates the solver state in
place under that gate).  Every other loop keeps ``step_fn(carry)`` and
its out-of-place steps.

``minh_fn`` contract: the segmented-min hot spot of every sweep family is
pluggable (``resolve_minh_fn``): ``None`` selects the plain PyTorch path
(flat-frontier / ``scatter_reduce``), kernel modes route it to the CUDA
warp-per-vertex kernel — one launch per sweep step.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.kernels.runtime import census_loop, census_step

__all__ = ["DEFAULT_CHUNK", "normalize_chunk", "run_chunk", "run_bulk_loop",
           "fill_at", "fixpoint_loop", "run_to_fixpoint", "resolve_minh_fn"]

#: steps per chunk.  Small on purpose: the final chunk executes its gated
#: tail steps as (discarded) compute, so the expected waste is chunk/2
#: step bodies per loop; the host reads the condition once per chunk.
DEFAULT_CHUNK = 4


def normalize_chunk(chunk: int | None, budget: int | None = None) -> int:
    """The chunk length to run: ``chunk`` (default ``DEFAULT_CHUNK``),
    never exceeding the loop's total step ``budget`` when one is known
    (stepping past a known budget would be pure gated waste)."""
    c = DEFAULT_CHUNK if chunk is None else max(1, int(chunk))
    if budget is not None:
        c = max(1, min(c, int(budget)))
    return c


def _gate(live: torch.Tensor, new: Any, old: Any) -> Any:
    """Whole-carry select: keep ``new`` where ``live``, else ``old``.  A
    leaf the step returned as it was given (updated in place) is kept
    without a select."""
    if new is None or new is old:
        return new
    if isinstance(new, torch.Tensor):
        return torch.where(live, new, old)
    items = [_gate(live, a, b) for a, b in zip(new, old)]
    return type(new)(*items) if hasattr(new, "_fields") else type(new)(items)


def _step(step_fn: Callable, carry: Any, live: torch.Tensor,
          pass_gate: bool) -> Any:
    census_step()
    return step_fn(carry, live) if pass_gate else step_fn(carry)


def run_chunk(step_fn: Callable, carry: Any, *,
              cond_fn: Callable[[Any], torch.Tensor], chunk: int,
              pass_gate: bool = False) -> Any:
    """``chunk`` gated steps with no host read: each step keeps the old
    carry wherever ``cond_fn`` has gone false (``pass_gate``: the step
    gets that condition as its gate, see the module docstring)."""
    for _ in range(chunk):
        live = cond_fn(carry)
        carry = _gate(live, _step(step_fn, carry, live, pass_gate), carry)
    return carry


def run_bulk_loop(step_fn: Callable, carry: Any, *,
                  cond_fn: Callable[[Any], torch.Tensor],
                  chunk: int | None = None, pass_gate: bool = False) -> Any:
    """Iterate ``carry = step_fn(carry)`` while ``cond_fn(carry)``, in
    chunks of ``chunk`` gated steps (:func:`run_chunk`) with one host read
    of the condition per chunk.  Semantically identical to a per-step
    while loop (see the module docstring).  Returns the final carry."""
    chunk = normalize_chunk(chunk)
    with census_loop(chunk, step_fn, cond_fn, carry, pass_gate):
        while True:
            live = cond_fn(carry)
            if not bool(live):  # the one host read per chunk
                return carry
            if chunk == 1:
                # the outer check already guards this step exactly: its
                # gate is open
                carry = _step(step_fn, carry, live, pass_gate)
            else:
                carry = run_chunk(step_fn, carry, cond_fn=cond_fn,
                                  chunk=chunk, pass_gate=pass_gate)


def fill_at(x: torch.Tensor, i: int, value) -> torch.Tensor:
    """``x[i] = value`` in place as a device fill kernel.  Python's
    ``x[i] = value`` copies the value from the host, which synchronises;
    inside a chunk nothing may."""
    x[i:i + 1].fill_(value)
    return x


def fixpoint_loop(sweep_fn: Callable[[Any], Any], x0: torch.Tensor, *,
                  cap: int):
    """The ``(step_fn, cond_fn, carry)`` of a sweep-to-fixpoint loop over
    ``(x, changed, sweeps)`` carries: iterate ``x = sweep_fn(x)`` until
    no element changes or ``cap`` sweeps ran."""

    def step(carry):
        x, _, it = carry
        nx = sweep_fn(x)
        return nx, torch.any(nx != x), it + 1

    def cond(carry):
        _, changed, it = carry
        return changed & (it < cap)

    dev = x0.device
    carry = (x0, torch.ones((), dtype=torch.bool, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev))
    return step, cond, carry


def run_to_fixpoint(sweep_fn: Callable[[Any], Any], x0: torch.Tensor, *,
                    cap: int, chunk: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Iterate ``x = sweep_fn(x)`` until unchanged (or ``cap`` sweeps)
    through :func:`run_bulk_loop` — the shell of every Bellman-Ford-style
    sweep family.  Returns ``(x, sweeps)``, ``sweeps`` a 0-d int32 tensor
    counting executed sweeps, the final no-change sweep included."""
    step, cond, carry = fixpoint_loop(sweep_fn, x0, cap=cap)
    x, _, sweeps = run_bulk_loop(step, carry, cond_fn=cond,
                                 chunk=normalize_chunk(chunk, cap))
    return x, sweeps


def resolve_minh_fn(mode: str):
    """The segmented-min hook a solver mode implies: kernel modes
    (``pushrelabel.KERNEL_MODES``) route the min search through the CUDA
    kernel; other modes return ``None``, the plain PyTorch path."""
    from repro_torch.core import pushrelabel as pr

    if mode in pr.KERNEL_MODES:
        from repro_torch.kernels import ops as kops

        return kops.min_neighbor_minh_fn()
    return None
