"""``Solver``: runs problems under a fixed ``SolverOptions`` (port of the
JAX package's ``repro.api.solver``).  ``Solver.solve`` runs a single
problem, ``Solver.solve_many`` advances a whole batch together (the
batched core) and corrects it to flows in the same call, and
``Solver.resolve`` re-solves warm from a ``WarmStartHandle`` after
signed capacity updates (a decrease below the routed flow is drained on
the device first), and ``Solver.open_stream`` opens a versioned
streaming session (``repro_torch.streaming``).  ``backend="distributed"``
solves on the ranks of the default ``torch.distributed`` process group
(``repro_torch.core.distributed``)."""
from __future__ import annotations

from collections.abc import Iterable, Sequence

import numpy as np

from repro_torch.api.options import SolverOptions
from repro_torch.api.problem import MaxflowProblem
from repro_torch.api.solution import (Solution, SolveStats, WarmStartHandle,
                                      _normalize_updates)
from repro_torch.core import batched
from repro_torch.core import pushrelabel as pr
from repro_torch.core.csr import ResidualCSR

_DISTRIBUTED_GUIDANCE = (
    "backend='distributed' solves on the ranks of a torch.distributed "
    "process group, and none is initialised.  Launch one process per rank "
    "with torchrun (e.g. torchrun --nproc-per-node 2 -m "
    "repro_torch.launch.maxflow --backend distributed --device cpu "
    "--smoke), or call torch.distributed.init_process_group first: NCCL "
    "for the card, gloo for device='cpu'.  Or use "
    "backend='single'/'batched'.")


class Solver:
    """Executes problems under a fixed ``SolverOptions``.

    ``Solver()`` uses the defaults (on the card);
    ``Solver(backend="batched", mode="vc_fused", device="cpu")`` is
    shorthand for ``Solver(SolverOptions(backend="batched", ...))``.
    """

    def __init__(self, options: SolverOptions | None = None, **overrides):
        if options is None:
            options = SolverOptions(**overrides)
        elif overrides:
            options = options.replace(**overrides)
        self.options = options

    def _handle(self, r: ResidualCSR, s: int, t: int, res, e,
                corrected: bool, device) -> WarmStartHandle:
        """A handle on the host copies ``res``/``e`` of a solve that ran
        on ``device``, where its lazy phase 2 will run."""
        return WarmStartHandle(r, s, t, res, e, corrected=corrected,
                               use_kernel=self.options.mode
                               in pr.KERNEL_MODES, device=device)

    # -- single problem -----------------------------------------------------

    def solve(self, problem) -> Solution:
        opts = self.options
        if opts.backend == "distributed":
            return self._solve_distributed(problem)
        if opts.backend == "batched":
            return self.solve_many([problem])[0]
        return self._solve_single(problem, problem.residual(opts.layout))

    def _solve_single(self, problem, r: ResidualCSR) -> Solution:
        opts = self.options
        out = pr.solve_impl(
            r, problem.s, problem.t, mode=opts.mode,
            cycle_chunk=opts.global_relabel_cadence,
            max_rounds=opts.max_rounds(r.n), instrument=opts.telemetry,
            device=opts.device, max_cycles=opts.max_cycles,
            scan_chunk=opts.scan_chunk)
        tel = opts.telemetry
        stats = SolveStats(
            cycles=out.cycles, rounds=out.rounds,
            global_relabels=out.global_relabels, gr_sweeps=out.gr_sweeps,
            backend="single", mode=opts.mode, layout=r.layout,
            pushes=out.pushes, relabels=out.relabels,
            active_history=out.active_history if tel else None,
            frontier_history=out.frontier_history if tel else None,
            maxdeg_history=out.maxdeg_history if tel else None)
        handle = self._handle(r, problem.s, problem.t,
                              pr.host_array(out.state.res),
                              pr.host_array(out.state.e), corrected=False,
                              device=out.state.res.device)
        return Solution(problem, out.maxflow, stats, handle, out.state)

    # -- batched ------------------------------------------------------------

    def solve_many(self, problems: Iterable) -> list[Solution]:
        """Solve B problems in one padded batch (the batched core), then
        correct the whole batch to flows in one phase-2 pass: every
        handle comes back ``corrected``.  Per-problem values match
        ``solve`` exactly."""
        problems = list(problems)
        if not problems:
            return []
        opts = self.options
        if opts.backend == "distributed":
            return [self.solve(p) for p in problems]
        residuals = [p.residual(opts.layout) for p in problems]
        insts = [(r, p.s, p.t) for r, p in zip(residuals, problems)]
        n_max = max(r.n for r in residuals)
        out = batched.batched_solve_impl(
            insts, mode=opts.mode, cycle_chunk=opts.global_relabel_cadence,
            max_rounds=opts.max_rounds(n_max), phase2=True,
            device=opts.device, telemetry=opts.telemetry,
            max_cycles=opts.max_cycles, scan_chunk=opts.scan_chunk)
        return self._batched_solutions(problems, residuals, out, warm=False)

    def _batched_solutions(self, problems: Sequence,
                           residuals: Sequence[ResidualCSR],
                           out: batched.BatchedSolveResult,
                           warm: bool) -> list[Solution]:
        opts = self.options
        res_np = pr.host_array(out.state.res)
        e_np = pr.host_array(out.state.e)
        dev = out.state.res.device
        sols = []
        for i, (p, r) in enumerate(zip(problems, residuals)):
            if out.trivial[i]:
                # packed with zero capacities — the row is not the
                # instance's state; the idle state (no flow) is
                res0 = batched.as_state_dtype(r.res0, "res0")
                zeros = np.zeros(r.n, batched.STATE_DTYPE)
                handle = self._handle(r, p.s, p.t, res0, zeros,
                                      corrected=True, device=dev)
                state = pr.state_from_numpy(res0, zeros, zeros, dev)
            else:
                handle = self._handle(r, p.s, p.t,
                                      res_np[i, :r.num_arcs].copy(),
                                      e_np[i, :r.n].copy(),
                                      corrected=out.corrected, device=dev)
                state = pr.PRState(res=out.state.res[i, :r.num_arcs],
                                   h=out.state.h[i, :r.n],
                                   e=out.state.e[i, :r.n])
            stats = SolveStats(
                cycles=int(out.cycles[i]), rounds=int(out.rounds[i]),
                global_relabels=out.global_relabels, backend="batched",
                mode=opts.mode, layout=r.layout, warm=warm,
                batch_size=len(problems), gr_sweeps=out.gr_sweeps,
                pushes=(int(out.pushes[i]) if out.pushes is not None
                        else 0),
                relabels=(int(out.relabels[i]) if out.relabels is not None
                          else 0))
            sols.append(Solution(p, int(out.maxflows[i]), stats, handle,
                                 state))
        return sols

    # -- incremental re-solves ----------------------------------------------

    def resolve(self, handle: WarmStartHandle, updates) -> Solution:
        """Re-solve after signed capacity updates, warm for both signs.

        Increases re-enter the solver (the batched core, on this
        solver's device) from the handle's phase-2-corrected residual
        with the injected excess budgeted by the update total, so only
        the new capacity gets routed.  Decreases cancel the overflowed
        flow and drain the imbalance on the handle's device
        (``repro_torch.streaming.reroute``), then re-enter with the
        drained value as budget.  Either way, a warm start that injects
        no excess is answered directly — the flow is already maximal and
        no solve runs (``stream.noop_resolves``).  Where the drain stalls
        (the handle did not hold a corrected flow;
        ``stream.reroute.stalls``) the updated graph is solved cold, on
        this solver's device.
        """
        ups = _normalize_updates(updates)
        rerouted = any(d < 0 for _, _, d in ups)
        r2, warm = handle.apply(ups)
        problem = MaxflowProblem.from_residual(r2, handle.s, handle.t)
        if warm is None:  # the drain stalled: cold solve
            return self._solve_single(problem, r2)
        sol = self._warm_solution(problem, r2, handle, warm)
        sol.stats.rerouted = rerouted
        return sol

    def _warm_solution(self, problem, r2: ResidualCSR,
                       handle: WarmStartHandle, warm) -> Solution:
        """Finish a warm re-solve from an ``apply`` triple."""
        opts = self.options
        res, h, e = warm
        inner = np.ones(r2.n, bool)
        inner[handle.t] = False  # e[s] is zero by construction
        if not (e[inner] > 0).any():
            # no injected excess: no augmenting path can exist (either
            # the budget was zero or every source arc is saturated), so
            # the warm state IS the maximum flow — skip the solve
            from repro_torch.obs import counter

            counter("stream.noop_resolves").inc()
            state = pr.state_from_numpy(res, h, e, opts.device)
            h2 = self._handle(r2, handle.s, handle.t, res, e,
                              corrected=True, device=state.res.device)
            stats = SolveStats(backend="batched", mode=opts.mode,
                               layout=r2.layout, warm=True)
            return Solution(problem, int(e[handle.t]), stats, h2, state)
        bg, meta, _, trivial = batched.pack_instances(
            [(r2, handle.s, handle.t)], device=opts.device)
        state0 = batched.pack_states([warm], meta.n, meta.num_arcs,
                                     device=opts.device)
        out = batched.batched_resolve(
            bg, meta, state0, trivial=trivial, mode=opts.mode,
            cycle_chunk=opts.global_relabel_cadence,
            max_rounds=opts.max_rounds(r2.n), telemetry=opts.telemetry,
            max_cycles=opts.max_cycles, scan_chunk=opts.scan_chunk)
        return self._batched_solutions([problem], [r2], out, warm=True)[0]

    # -- distributed --------------------------------------------------------

    def _solve_distributed(self, problem) -> Solution:
        """One solve on every rank of the default process group (each rank
        calls it with the same problem).  The final state stays
        partitioned on the ranks: the solution has no warm-start handle,
        so its views raise, and no ``state``."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise NotImplementedError(_DISTRIBUTED_GUIDANCE)
        from repro_torch.core import distributed

        opts = self.options
        r = problem.residual(opts.layout)
        cycles = opts.global_relabel_cadence or 64
        out = distributed.distributed_solve_impl(
            r, problem.s, problem.t, mode="replicated", cycles=cycles,
            device=opts.device)
        stats = SolveStats(cycles=out.supersteps * cycles,
                           rounds=out.supersteps,
                           global_relabels=out.supersteps,
                           gr_sweeps=out.gr_sweeps, backend="distributed",
                           mode=opts.mode, layout=r.layout)
        return Solution(problem, out.value, stats, warm_start=None,
                        state=None)

    # -- streaming ----------------------------------------------------------

    def open_stream(self, problem, max_versions: int = 8):
        """Open a long-lived streaming session: solve ``problem`` once,
        then fold edge insert / delete / re-weight events into new
        warm-started versions via ``StreamHandle.apply(events)`` and
        answer ``query(version)`` from the retained chain.  Returns a
        ``repro_torch.streaming.StreamHandle`` (see
        ``repro_torch.streaming.stream`` for the event vocabulary and
        version semantics)."""
        from repro_torch.streaming.stream import StreamingGraph

        return StreamingGraph(problem, solver=self,
                              max_versions=max_versions)
