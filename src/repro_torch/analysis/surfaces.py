"""The dispatch-surface registry: every device entry point of the port,
run once on tiny fixtures under the census and held to the contract rules
(the port of ``repro.analysis.surfaces``, under the same 25 names).

* ``run_cycles/<mode>/<layout>`` — the single-instance cycle loop for
  every mode and residual layout (``vc_kernel_bsearch``: bcsr only);
* ``batched_run_cycles/<mode>`` — the stacked ``(B, ...)`` cycle loop
  (the serving flush path), padded dummy lane included;
* ``global_relabel/{single,batched}[/kernel]`` — the Bellman-Ford
  distance sweeps, plain and on the min search's dense gather entry;
* ``phase2/{single,batched}[/kernel]`` — preflow -> flow;
* ``streaming/drain_prepared[/kernel]`` — the pooled decrease drain
  behind ``streaming.reroute.drain_prepared``;
* ``distributed/superstep`` — 8 steps and a relabel on a one-rank
  process group (the one the caller has, else one opened for the run).

The census runs the surface (:mod:`repro_torch.analysis.ir`): its counts
are of the steps the fixture took.  Where the reference's abstract trace
counts ``(whiles, scans, pallas_calls)``, the port counts engine loops,
loops chunked over more than one step, and kernel launches a step:

==========================  =====================  ======================
surface family              reference              port
==========================  =====================  ======================
run_cycles, batched         (1, 1, L)               1 loop, 1 chunked,
                            (``tc``: (1, 2, 0))     L launches a step
global_relabel              (1, 1, 0 or 1)          1, 1, 0 or 1
phase2                      (3, 2, 0 or 2)          3, 2, 0 or 1
streaming                   (6, 4, 0 or 4)          6, 4, 0 or 1
distributed                 (2, 2, 0)               2, 2, 0
==========================  =====================  ======================

``L`` is :data:`LAUNCHES_PER_STEP`; ``vc_kernel_bsearch`` is 1 where the
reference has 2, since its reverse search runs inside the min search's
rev entry.  The reference's phase 2 and drain count the ``pallas_call``
equations of their whole program (a height sweep's and a selection's);
the port counts launches a step, and each step of a sweep or a
cancellation is one launch.  ``tc``'s column scan is a Python loop inside
the step, not a loop of the engine.

The streaming surface drains a real overflow: the reference's fixture
(the batched preflow's heights as the imbalance) drains nothing when it
runs, which its abstract trace does not notice.  Its fixture is the
batched fixture's two instances solved and corrected, then on each the
arc between inner vertices that carries the most flow zeroed (a deficit
to drain at its head, an excess at its tail; where no such arc carries
flow, the arc into an inner vertex that carries the most).

The ``op-budget`` ceilings are about twice the counts measured on the CPU
(:data:`OP_CEILINGS`).  The reference re-seeds its ceilings from a live
``BENCH_kernels.json``; the port has no such artifact, so they are static.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import tempfile
from typing import Callable, ContextManager, Iterator

import numpy as np
import torch

from repro_torch.analysis import ir
from repro_torch.analysis.rules import (
    ChunkShape,
    Int32Lattice,
    LaunchBudget,
    NoHostSync,
    NoPerRowLaunch,
    OpBudget,
    Rule,
    Violation,
    check_rules,
)

__all__ = ["Surface", "iter_surfaces", "trace_surface", "analyze_surface",
           "one_rank_group", "LAUNCHES_PER_STEP",
           "REFERENCE_LAUNCHES_PER_STEP", "LOOPS", "OP_CEILINGS"]

#: cycles per surface: small; a step's census does not depend on the cap
_MAX_CYCLES = 32

#: kernel launches per engine step, by mode
LAUNCHES_PER_STEP = {"vc": 0, "tc": 0, "vc_kernel": 1,
                     "vc_kernel_bsearch": 1, "vc_fused": 1}
#: the reference's (``repro.analysis.surfaces._LAUNCHES_PER_STEP``)
REFERENCE_LAUNCHES_PER_STEP = {"vc": 0, "tc": 0, "vc_kernel": 1,
                               "vc_kernel_bsearch": 2, "vc_fused": 1}

#: engine loops each family runs: phase 2 is [heights -> cancel to
#: fixpoint] passes (outer, height sweeps, cancellations); the drain is
#: a deficit drain of that shape, then phase 2; the superstep is its
#: steps, then the relabel's sweeps
LOOPS = {"run_cycles": 1, "batched_run_cycles": 1, "global_relabel": 1,
         "phase2": 3, "streaming": 6, "distributed": 2}

#: aten ops per engine step outside kernel brackets: about twice the
#: counts measured on the CPU at these fixtures (README "Contract
#: analysis" lists them)
OP_CEILINGS = {
    "run_cycles": {"vc": 280, "tc": 220, "vc_kernel": 150,
                   "vc_kernel_bsearch": 150, "vc_fused": 60},
    "batched_run_cycles": {"vc": 370, "tc": 280, "vc_kernel": 260,
                           "vc_kernel_bsearch": 260, "vc_fused": 80},
    "global_relabel": 55,
    "phase2": 150,
    "streaming": 155,
    "distributed": 210,
}


@dataclasses.dataclass(frozen=True)
class Surface:
    """One registered dispatch surface on one device.  ``build()``
    returns ``(fn, args)`` (fresh tensors each call); ``session()``,
    where given, is the context the build and the run need (the process
    group)."""

    name: str
    family: str
    tags: tuple[tuple[str, str], ...]
    build: Callable[[], tuple[Callable, tuple]]
    rules: tuple[Rule, ...]
    device: torch.device
    session: Callable[[], ContextManager] | None = None

    def tag_dict(self) -> dict:
        return dict(self.tags)


def _tags(**kw) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in kw.items()))


# ---------------------------------------------------------------------------
# tiny fixtures (cached per device; the builders hand out clones)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def single_fixture(layout: str, device: str):
    """``random_sparse(24, 96, seed=7)`` after preflow and a global
    relabel: ``(g, meta, state, s, t, r, res0)``."""
    from repro_torch.core import globalrelabel
    from repro_torch.core import pushrelabel as pr
    from repro_torch.core.csr import build_residual
    from repro_torch.graphs import generators as G

    adj, s, t = G.random_sparse(24, 96, seed=7)
    r = build_residual(adj, layout)
    g, meta, res0 = pr.to_device(r, device)
    state = pr.preflow(g, meta, res0, s)
    state, _, _ = globalrelabel.global_relabel_impl(g, meta, state, s, t)
    return g, meta, state, s, t, r, res0


def _batched_instances():
    from repro_torch.core.csr import build_residual
    from repro_torch.graphs import generators as G

    out = []
    for seed in (1, 2):
        adj, s, t = G.random_sparse(20, 70, seed=seed)
        out.append((adj, build_residual(adj, "bcsr"), s, t))
    return out


@functools.lru_cache(maxsize=None)
def batched_fixture(device: str):
    """Seeds 1 and 2 of ``random_sparse(20, 70)`` and a padded dummy lane
    (``s == t``), after the batched preflow: ``(bg, meta, res0,
    state)``."""
    from repro_torch.core import batched

    insts = [(r, s, t) for _, r, s, t in _batched_instances()]
    insts.append((insts[0][0], 0, 0))
    bg, meta, res0, _ = batched.pack_instances(insts, device=device)
    return bg, meta, res0, batched.batched_preflow(bg, meta, res0)


@functools.lru_cache(maxsize=None)
def drain_fixture(device: str):
    """The batched fixture's two instances solved and corrected, then on
    each the arc between inner vertices (else into one) that carries the
    most flow zeroed, packed as ``drain_prepared`` packs a pool: ``(rows,
    meta, res0, res, b, e, s, t)``."""
    from repro_torch.core import batched
    from repro_torch.streaming import reroute

    insts = _batched_instances()
    sol = batched.batched_solve_impl([(r, s, t) for _, r, s, t in insts],
                                     phase2=True, device=device)
    state = [x.cpu().numpy() for x in sol.state]
    preps = []
    for i, (_, r, s, t) in enumerate(insts):
        res = state[0][i, :r.num_arcs]
        # zero the arc that carries the most flow between inner vertices
        # (an excess at its tail, a deficit at its head), else into one
        into = ~np.isin(r.heads, (s, t)) & (r.tails != t)
        inner = into & (r.tails != s)
        flow = r.res0 - res
        flow = np.where(inner if (flow[inner] > 0).any() else into, flow, 0)
        a = int(np.argmax(flow))
        u, v = int(r.tails[a]), int(r.heads[a])
        preps.append(reroute.prepare_signed(
            r, res, state[2][i, :r.n], s, t,
            [(u, v, -int(r.res0[a]))]))
    if not all(p.overflow for p in preps):
        raise RuntimeError("the drain fixture's updates overflow no flow")
    bg, meta, res0, _ = batched.pack_instances(
        [(p.residual, p.s, p.t) for p in preps], device=device)
    state = batched.pack_states(
        [(batched.as_state_dtype(p.res, "res"),
          batched.as_state_dtype(p.b, "b"), batched.as_state_dtype(p.e, "e"))
         for p in preps], meta.n, meta.num_arcs, device=res0.device)
    return (batched._rows(bg), meta, res0, state.res, state.h, state.e,
            bg.s, bg.t)


def _clones(*xs):
    return tuple(x.clone() for x in xs)


def _hook(kernel: bool):
    if not kernel:
        return None
    from repro_torch.kernels import ops as kops

    return kops.min_neighbor_minh_fn()


# ---------------------------------------------------------------------------
# surface builders
# ---------------------------------------------------------------------------

def _build_run_cycles(mode: str, layout: str, device):
    from repro_torch.core import pushrelabel as pr

    g, meta, state, s, t, _, _ = single_fixture(layout, str(device))

    def fn(res, h, e):
        return pr.run_cycles(g, meta, pr.PRState(res, h, e), s, t, mode=mode,
                             max_cycles=_MAX_CYCLES)

    return fn, _clones(*state)


def _build_batched_run_cycles(mode: str, device):
    from repro_torch.core import batched

    bg, meta, _, state = batched_fixture(str(device))

    def fn(res, h, e):
        return batched.batched_run_cycles(
            bg, meta, batched.BatchedPRState(res, h, e), mode=mode,
            max_cycles=_MAX_CYCLES)

    return fn, _clones(*state)


def _build_global_relabel(batch: bool, kernel: bool, device):
    hook = _hook(kernel)
    if batch:
        from repro_torch.core import batched

        bg, meta, _, state = batched_fixture(str(device))

        def fn(res, h, e):
            return batched.batched_global_relabel(
                bg, meta, batched.BatchedPRState(res, h, e), minh_fn=hook)

        return fn, _clones(*state)
    from repro_torch.core import globalrelabel
    from repro_torch.core import pushrelabel as pr

    g, meta, state, s, t, _, _ = single_fixture("bcsr", str(device))

    def fn(res, h, e):
        return globalrelabel.global_relabel_impl(
            g, meta, pr.PRState(res, h, e), s, t, minh_fn=hook)

    return fn, _clones(*state)


def _build_phase2(batch: bool, kernel: bool, device):
    hook = _hook(kernel)
    if batch:
        from repro_torch.core import batched

        bg, meta, res0, state = batched_fixture(str(device))

        def fn(res, h, e):
            return batched.batched_phase2(
                bg, meta, res0, batched.BatchedPRState(res, h, e),
                minh_fn=hook)

        return fn, _clones(*state)
    from repro_torch.core import phase2

    g, meta, state, s, t, _, res0 = single_fixture("bcsr", str(device))

    def fn(res, e):
        return phase2.phase2_impl(g, meta, res0, res, e, s, t, minh_fn=hook)

    return fn, _clones(state.res, state.e)


def _build_streaming_drain(kernel: bool, device):
    from repro_torch.streaming import reroute

    hook = _hook(kernel)
    rows, meta, res0, res, b, e, s, t = drain_fixture(str(device))

    def fn(res, b, e):
        return reroute._batched_reroute_impl(rows, meta, res0, res, b, e, s,
                                             t, minh_fn=hook)

    return fn, _clones(res, b, e)


@contextlib.contextmanager
def one_rank_group(device) -> Iterator[None]:
    """The default process group for a one-rank run on ``device``: the
    caller's, if one exists (it must be of one rank and carry the
    device's tensors), else one opened over a ``FileStore`` in a
    temporary directory and destroyed on exit, leaving the process as it
    was found."""
    import torch.distributed as dist

    from repro_torch.core import distributed as D

    if dist.is_available() and dist.is_initialized():
        D.check_group(None, device)
        if dist.get_world_size() != 1:
            raise RuntimeError("the distributed surface runs on one rank; "
                               f"this group has {dist.get_world_size()}")
        yield
        return
    dev = torch.device(device)
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        kw = {}
        if dev.type == "cuda":  # NCCL binds the rank to a numbered card
            kw["device_id"] = torch.device(
                dev.type, torch.cuda.current_device() if dev.index is None
                else dev.index)
        dist.init_process_group(D.BACKENDS[dev.type], store=store, rank=0,
                                world_size=1, **kw)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _build_distributed_superstep(device):
    from repro_torch.core import distributed as D
    from repro_torch.core.csr import build_residual
    from repro_torch.graphs import generators as G

    adj, s, t = G.random_sparse(16, 48, seed=9)
    r = build_residual(adj, "bcsr")
    slabs, meta, res0 = D.partition_graph(r, 1, s, t, "replicated")
    g = slabs[0].to(device)
    superstep = D.make_superstep(meta, g, cycles=8)
    res = torch.from_numpy(res0).to(device)
    h = torch.zeros(meta.n, dtype=torch.int32, device=device)
    h[s] = meta.n
    e = torch.zeros(meta.n, dtype=torch.int32, device=device)
    return superstep, (res, h, e)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def _rules(rows: int, loops: int, launches: int, ceiling: float
           ) -> tuple[Rule, ...]:
    return (NoPerRowLaunch(rows), NoHostSync(), Int32Lattice(),
            ChunkShape(loops=loops, launches=launches),
            LaunchBudget(launches), OpBudget(ceiling))


def iter_surfaces(modes: tuple[str, ...] | None = None, device=None
                  ) -> Iterator[Surface]:
    """Every registered dispatch surface on ``device`` (``None``: the
    card), built lazily."""
    from repro_torch.core.pushrelabel import ALL_MODES
    from repro_torch.kernels.runtime import resolve_device

    modes = tuple(modes) if modes is not None else ALL_MODES
    dev = resolve_device(device)
    batch = 3  # two instances and the dummy lane

    for mode in modes:
        layouts = ("bcsr",) if mode == "vc_kernel_bsearch" else ("bcsr",
                                                                 "rcsr")
        for layout in layouts:
            yield Surface(
                name=f"run_cycles/{mode}/{layout}", family="run_cycles",
                tags=_tags(mode=mode, layout=layout, batched=False),
                build=functools.partial(_build_run_cycles, mode, layout,
                                        dev),
                rules=_rules(1, LOOPS["run_cycles"], LAUNCHES_PER_STEP[mode],
                             OP_CEILINGS["run_cycles"][mode]),
                device=dev)

    for mode in modes:
        yield Surface(
            name=f"batched_run_cycles/{mode}", family="batched_run_cycles",
            tags=_tags(mode=mode, layout="bcsr", batched=True),
            build=functools.partial(_build_batched_run_cycles, mode, dev),
            rules=_rules(batch, LOOPS["batched_run_cycles"],
                         LAUNCHES_PER_STEP[mode],
                         OP_CEILINGS["batched_run_cycles"][mode]),
            device=dev)

    for family, builder in (("global_relabel", _build_global_relabel),
                            ("phase2", _build_phase2)):
        for batched in (False, True):
            for kernel in (False, True):
                kind = "batched" if batched else "single"
                rows = batch if batched else 1
                yield Surface(
                    name=f"{family}/{kind}{'/kernel' if kernel else ''}",
                    family=family, tags=_tags(batched=batched, kernel=kernel),
                    build=functools.partial(builder, batched, kernel, dev),
                    rules=_rules(rows, LOOPS[family], int(kernel),
                                 OP_CEILINGS[family]),
                    device=dev)

    for kernel in (False, True):
        yield Surface(
            name=f"streaming/drain_prepared{'/kernel' if kernel else ''}",
            family="streaming", tags=_tags(batched=True, kernel=kernel),
            build=functools.partial(_build_streaming_drain, kernel, dev),
            rules=_rules(2, LOOPS["streaming"], int(kernel),
                         OP_CEILINGS["streaming"]), device=dev)

    yield Surface(
        name="distributed/superstep", family="distributed",
        tags=_tags(batched=False, kernel=False),
        build=functools.partial(_build_distributed_superstep, dev),
        rules=_rules(1, LOOPS["distributed"], 0, OP_CEILINGS["distributed"]),
        device=dev, session=functools.partial(one_rank_group, dev))


def trace_surface(surface: Surface) -> tuple[object, ir.OpCensus]:
    """Run one surface once under the census; returns its result and
    census."""
    with surface.session() if surface.session else contextlib.nullcontext():
        fn, args = surface.build()
        return ir.record(fn, *args)


def analyze_surface(surface: Surface) -> tuple[ir.OpCensus, list[Violation]]:
    _, census = trace_surface(surface)
    return census, check_rules(census, surface.rules, surface.name)
