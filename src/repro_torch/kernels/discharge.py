"""Fused discharge — ``k`` whole push-relabel cycles per launch: the CUDA
kernel ``csrc/discharge.cu`` behind the JAX package's
``fused_discharge_batched`` signature.

Semantics are bit for bit ``k`` applications of
``pushrelabel.vc_step`` per instance: each cycle snapshots ``res/h/e``,
every active vertex pushes along its smallest-height residual arc (the
smallest such arc on ties) or relabels, pushes are tail-owned and move
excess by integer adds, and a relabel writes only the owner's height.
The batch is one launch.  Besides the new state the call reports
per-instance live-cycle counts (cycles that began with an active vertex,
which keep the drivers' cycle counts those of the unfused loop) and an
any-push flag, and with ``counters=True`` the per-cycle workload counts
of ``repro_torch.obs.solvercounters``.

CUDA tensors launch the kernel on the current stream (or raise); CPU
tensors take the plain version, :func:`fused_discharge_batched_plain`.
``fused_discharge_batched.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import check_operand

#: discharge cycles fused into one launch by default (the ``vc_fused``
#: drivers clamp this to the cycle budget)
K_DEFAULT = 8

_I32 = torch.int32


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
    """
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
    if dev.type == "cpu":
        return fused_discharge_batched_plain(s, t, indptr, heads, rev, res,
                                             h, e, n=n, k=k,
                                             counters=counters)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    res2, h2, e2 = (torch.empty_like(x) for x in (res, h, e))
    live = torch.empty(bsz, dtype=_I32, device=dev)
    pushed = torch.empty_like(live)
    cnt = torch.empty((4, bsz, k), dtype=_I32, device=dev)
    snap = [torch.empty_like(x) for x in (res, h, e)]
    fn = build.entry("discharge", "fused_discharge_launch")
    with torch.cuda.device(dev):
        code = fn(*(x.data_ptr() for x in (s, t, indptr, heads, rev, res, h,
                                           e, res2, h2, e2, live, pushed,
                                           cnt, *snap)),
                  bsz, n, a, k, torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "fused_discharge_batched")
    fused_discharge_batched.launches += 1
    if counters:
        return res2, h2, e2, live, pushed, tuple(cnt.unbind(0))
    return res2, h2, e2, live, pushed


fused_discharge_batched.launches = 0


def fused_discharge_batched_plain(s, t, indptr, heads, rev, res, h, e, *,
                                  n: int, k: int = K_DEFAULT,
                                  counters: bool = False):
    """The plain PyTorch version of the kernel: ``k`` cycles of the port's
    own ``vc_step`` per row (row by row), with ``live``, ``pushed`` and
    the four counters of ``solvercounters.cycle_stats`` and the
    relabel count.  Same arguments and results as
    :func:`fused_discharge_batched`, on whatever device the tensors are;
    it reads ``s``/``t`` on the host."""
    from repro_torch.core import pushrelabel as pr
    from repro_torch.obs import solvercounters as sc

    bsz, a = res.shape
    meta = pr.GraphMeta(n=n, num_arcs=a, deg_max=0, layout="batched")
    rows = []
    for b in range(bsz):
        g = pr.DeviceGraph(indptr=indptr[b], heads=heads[b], tails=None,
                           rev=rev[b])
        sb, tb = int(s[b]), int(t[b])
        state = pr.PRState(res=res[b], h=h[b], e=e[b])
        cnt = []
        for _ in range(k):
            nact, fr, md = sc.cycle_stats(g, meta, state, sb, tb)
            new = pr.vc_step(g, meta, state, sb, tb)
            cnt.append((nact, nact - sc.count_relabels(state.h, new.h), fr,
                        md))
            state = new
        act, psh, fr, md = (torch.stack(c) for c in zip(*cnt))
        rows.append((*state, (act > 0).sum(dtype=_I32),
                     (psh > 0).any().to(_I32), act, psh, fr, md))
    res2, h2, e2, live, pushed, *cnt = (torch.stack(c) for c in zip(*rows))
    if counters:
        return res2, h2, e2, live, pushed, tuple(cnt)
    return res2, h2, e2, live, pushed


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
