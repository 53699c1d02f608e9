"""Fused discharge — ``k`` whole push-relabel cycles per launch: the CUDA
kernel ``csrc/discharge.cu`` behind the JAX package's
``fused_discharge_batched`` signature.

Semantics are bit for bit ``k`` applications of
``pushrelabel.vc_step`` per instance: in each cycle every active vertex
pushes along its smallest-height residual arc (the smallest such arc on
ties) or relabels, reading the state the cycle started from; pushes move
excess by integer adds, and a relabel writes only the owner's height.
The batch is one launch.  Besides the new state the call reports
per-instance live-cycle counts (cycles that began with an active vertex,
which keep the drivers' cycle counts those of the unfused loop) and an
any-push flag, and with ``counters=True`` the per-cycle workload counts
of ``repro_torch.obs.solvercounters``.

Two entries.  :func:`fused_discharge_batched_` updates ``res/h/e`` in
place, as the TPU kernel does under input/output aliasing, under a 0-d
device gate: where the gate is closed it leaves the state as it is and
reports zeros.  That is the step the ``vc_fused`` drivers run (the
engine passes its loop condition as the gate; the drivers clone the
caller's state once on entry, so no caller sees its tensors change).
:func:`fused_discharge_batched` keeps the JAX function's out-of-place
contract: it clones ``res/h/e`` and runs the in-place entry with the
gate open.

CUDA tensors launch the kernel on the current stream (or raise); CPU
tensors take the plain version, :func:`fused_discharge_batched_plain_`
(which copies :func:`fused_discharge_batched_plain`'s state into
``res/h/e`` under the gate).
``fused_discharge_batched.launches`` counts kernel launches of both
entries.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import check_operand

#: discharge cycles fused into one launch by default (the ``vc_fused``
#: drivers clamp this to the cycle budget)
K_DEFAULT = 8

#: per-row accumulators ahead of the queue in ``DischargeScratch.queue``:
#: queue length, pushes, frontier arcs, max degree
N_ACC = 4

_I32 = torch.int32


class DischargeScratch(NamedTuple):
    """What one launch of the kernel works in, allocated once per loop by
    :func:`discharge_scratch`.  ``queue`` must start zeroed: the kernel
    returns its accumulators to 0 after reading them.  ``live``,
    ``pushed`` and ``counts`` are the outputs of the in-place entry, which
    returns them as they are: the next launch with this scratch
    overwrites them."""

    queue: torch.Tensor  # (B, N_ACC + n): accumulators, then the AVQ
    decision: torch.Tensor  # (B, 2n): (arc, d) of a push, (-1, height)
    live: torch.Tensor  # (B,)
    pushed: torch.Tensor  # (B,)
    counts: torch.Tensor  # (4, B, k): active, pushes, frontier, maxdeg


def discharge_scratch(bsz: int, n: int, k: int, device) -> DischargeScratch:
    """The scratch of a ``(B, n)`` state and ``k`` cycles a launch."""
    def empty(*shape):
        return torch.empty(shape, dtype=_I32, device=device)

    return DischargeScratch(
        queue=torch.zeros((bsz, N_ACC + n), dtype=_I32, device=device),
        decision=empty(bsz, 2 * n), live=empty(bsz), pushed=empty(bsz),
        counts=empty(4, bsz, k))


def _check(s, t, indptr, heads, rev, res, h, e, n, k, gate, scratch):
    """Raise on an operand the kernel does not take; returns ``(B, A)``."""
    if res.ndim != 2:
        raise ValueError(f"res must be (B, A), got {tuple(res.shape)}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    bsz, a = res.shape
    dev = res.device
    for name, x, shape in (("s", s, (bsz,)), ("t", t, (bsz,)),
                           ("indptr", indptr, (bsz, n + 1)),
                           ("heads", heads, (bsz, a)), ("rev", rev, (bsz, a)),
                           ("res", res, (bsz, a)), ("h", h, (bsz, n)),
                           ("e", e, (bsz, n))):
        check_operand(name, x, shape, dev)
    if gate is not None and (gate.dtype != torch.bool or gate.ndim != 0
                             or gate.device != dev):
        raise ValueError("gate must be a 0-d bool tensor on the state's "
                         f"device, got {gate.dtype} {tuple(gate.shape)} on "
                         f"{gate.device}")
    if scratch is not None:
        for name, x, shape in zip(
                DischargeScratch._fields, scratch,
                ((bsz, N_ACC + n), (bsz, 2 * n), (bsz,), (bsz,),
                 (4, bsz, k))):
            check_operand(f"scratch.{name}", x, shape, dev)
    return bsz, a


def fused_discharge_batched_(s, t, indptr, heads, rev, res, h, e, *, n: int,
                             k: int, gate, scratch=None,
                             counters: bool = False):
    """Run ``k`` fused discharge cycles on a batch, updating ``res``,
    ``h`` and ``e`` in place where the 0-d bool ``gate`` (a device tensor,
    or ``None`` for open) is true; where it is false the state is left as
    it is and every output is 0.

    Operands as in :func:`fused_discharge_batched`.  ``scratch`` is a
    :func:`discharge_scratch` of the same ``(B, n, k)``, allocated once
    per loop (``None`` allocates one for this call).  Returns ``(live,
    pushed)``, plus the four ``(B, k)`` per-cycle counts with
    ``counters=True``, all views into the scratch."""
    bsz, _ = _check(s, t, indptr, heads, rev, res, h, e, n, k, gate, scratch)
    dev = res.device
    if scratch is None:
        scratch = discharge_scratch(bsz, n, k, dev)
    if dev.type == "cpu":
        return fused_discharge_batched_plain_(
            s, t, indptr, heads, rev, res, h, e, n=n, k=k, gate=gate,
            scratch=scratch, counters=counters)
    if dev.type == "cuda":
        fn = build.entry("discharge", "fused_discharge_launch")
        with torch.cuda.device(dev):
            code = fn(*(x.data_ptr() for x in (s, t, indptr, heads, rev, res,
                                               h, e)),
                      None if gate is None else gate.data_ptr(),
                      *(x.data_ptr() for x in scratch), bsz, n, res.shape[1],
                      k, torch.cuda.current_stream(dev).cuda_stream)
        build.check(code, "fused_discharge_batched")
        fused_discharge_batched.launches += 1
    else:
        raise ValueError(f"unsupported device {dev}")
    return _outputs(scratch, counters)


def _outputs(scratch, counters):
    if counters:
        return scratch.live, scratch.pushed, tuple(scratch.counts.unbind(0))
    return scratch.live, scratch.pushed


def fused_discharge_batched_plain_(s, t, indptr, heads, rev, res, h, e, *,
                                   n: int, k: int, gate, scratch,
                                   counters: bool = False):
    """The plain version of :func:`fused_discharge_batched_`, on whatever
    device the tensors are: :func:`fused_discharge_batched_plain`'s state
    copied into ``res/h/e`` and its outputs into ``scratch`` under the
    gate.  Same arguments (``scratch`` required) and results."""
    new = fused_discharge_batched_plain(s, t, indptr, heads, rev, res, h, e,
                                        n=n, k=k, counters=True)
    outs = (*new[3:5], torch.stack(new[5]))
    if gate is not None:
        new = [torch.where(gate, x, y) for x, y in zip(new[:3], (res, h, e))]
        outs = [torch.where(gate, x, 0) for x in outs]
    for x, y in zip((res, h, e, *scratch[2:]), (*new[:3], *outs)):
        x.copy_(y)
    return _outputs(scratch, counters)


def fused_discharge_batched(s, t, indptr, heads, rev, res, h, e, *, n: int,
                            k: int = K_DEFAULT, counters: bool = False):
    """Run ``k`` fused discharge cycles on a batch of instances.

    ``s``/``t``: (B,) int32 terminals; ``indptr``: (B, n+1);
    ``heads``/``rev``/``res``: (B, A); ``h``/``e``: (B, n).  Unlike the
    TPU kernel, ``heads``/``rev`` come unpadded: the 128-lane safety tail
    of the JAX package's ``pad_arcs`` serves the TPU's 128-wide windows
    and has no use here.  Returns ``(res, h, e, live, pushed)``, new
    tensors (the inputs are left as they are): ``live[b]`` counts the
    cycles instance ``b`` still had active vertices for, and
    ``pushed[b]`` is 1 iff any cycle of the launch moved excess — equal
    ``e`` across a k-cycle launch does not imply pushes stopped (a
    push/relabel ping-pong with a period dividing k restores ``e``), so
    drivers use this flag for their relabel-only early exit.

    ``counters=True`` additionally returns a 6th element: four ``(B, k)``
    int32 per-cycle counts ``(active, pushes, frontier, maxdeg)`` —
    active vertices, pushes (relabels = active - pushes), scanned
    frontier arcs and the max active degree of each cycle (zero for
    cycles after an instance converged).

    It clones ``res/h/e`` and runs :func:`fused_discharge_batched_` on
    the clones with the gate open.
    """
    state = tuple(x.clone() for x in (res, h, e))
    out = fused_discharge_batched_(s, t, indptr, heads, rev, *state, n=n,
                                   k=k, gate=None, counters=counters)
    return state + tuple(out)


fused_discharge_batched.launches = 0


def fused_discharge_batched_plain(s, t, indptr, heads, rev, res, h, e, *,
                                  n: int, k: int = K_DEFAULT,
                                  counters: bool = False):
    """The plain PyTorch version of the kernel: ``k`` cycles of the batched
    core's plain ``vc`` step over all rows at once (each row's cycle is
    ``pushrelabel.vc_step`` on that row), with ``live``, ``pushed`` and
    the four counters of ``solvercounters.cycle_stats`` and the relabel
    count.  Same arguments and results as
    :func:`fused_discharge_batched`, on whatever device the tensors
    are, without a host read."""
    from repro_torch.core import batched
    from repro_torch.core import pushrelabel as pr
    from repro_torch.obs import solvercounters as sc

    a = res.shape[1]
    meta = pr.GraphMeta(n=n, num_arcs=a, deg_max=0, layout="batched")
    rows = pr.DeviceGraph(indptr=indptr, heads=heads, tails=None, rev=rev)
    bg = batched.BatchedDeviceGraph(indptr=indptr, heads=heads, tails=None,
                                    rev=rev, n=None, num_arcs=None, s=s, t=t)
    flat = batched._flat(rows, meta)
    state = batched.BatchedPRState(res, h, e)
    cnt = []
    for _ in range(k):
        nact, fr, md = sc.cycle_stats(rows, meta, state, s, t)
        new = batched._kernel_batch_step(bg, meta, state, "vc", flat)
        cnt.append((nact, nact - sc.count_relabels(state.h, new.h), fr, md))
        state = new
    act, psh, fr, md = (torch.stack(c, dim=1) for c in zip(*cnt))
    live = (act > 0).sum(dim=1, dtype=_I32)
    pushed = (psh > 0).any(dim=1).to(_I32)
    if counters:
        return (*state, live, pushed, (act, psh, fr, md))
    return (*state, live, pushed)


def fused_discharge(g, meta, state, s, t, *, k: int = K_DEFAULT,
                    counters: bool = False):
    """Single-instance wrapper: ``k`` fused cycles on a ``DeviceGraph`` /
    ``PRState`` pair (the ``B == 1`` case of the batched launch).  ``s``
    and ``t`` are ints or ``(1,)`` int32 tensors on the state's device
    (a loop passes tensors built once).  Returns ``(res, h, e,
    live_cycles, pushed)``, plus the four ``(k,)`` per-cycle counts with
    ``counters=True``."""
    dev = state.res.device
    s_b, t_b = (x if torch.is_tensor(x)
                else torch.full((1,), x, dtype=_I32, device=dev)
                for x in (s, t))
    out = fused_discharge_batched(
        s_b, t_b, g.indptr[None], g.heads[None], g.rev[None],
        state.res[None], state.h[None], state.e[None], n=meta.n, k=k,
        counters=counters)
    first = tuple(x[0] for x in out[:5])
    if counters:
        return first + (tuple(c[0] for c in out[5]),)
    return first
