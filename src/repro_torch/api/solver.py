"""``Solver``: runs problems under a fixed ``SolverOptions`` (port of the
JAX package's ``repro.api.solver``).  ``Solver.solve`` runs a single
problem, ``Solver.solve_many`` advances a whole batch together (the
batched core)."""
from __future__ import annotations

from collections.abc import Iterable

import torch

from repro_torch.api.options import SolverOptions
from repro_torch.api.solution import Solution, SolveStats
from repro_torch.core import batched
from repro_torch.core import pushrelabel as pr


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

    # -- single problem -----------------------------------------------------

    def solve(self, problem) -> Solution:
        opts = self.options
        if opts.backend == "distributed":
            raise NotImplementedError(
                "backend 'distributed' is not ported yet (see ROADMAP.md "
                "Queue 1, 'Distributed')")
        if opts.backend == "batched":
            return self.solve_many([problem])[0]
        r = problem.residual(opts.layout)
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
        return Solution(problem, out.maxflow, stats, out.state)

    # -- batched ------------------------------------------------------------

    def solve_many(self, problems: Iterable) -> list[Solution]:
        """Solve B problems in one padded batch (the batched core).
        Per-problem values match ``solve`` exactly.  Each ``Solution``'s
        state is its instance's unpadded slice of the batch's final
        preflow (phase 2, which would turn it into a flow, is not ported
        yet)."""
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
            max_rounds=opts.max_rounds(n_max), device=opts.device,
            telemetry=opts.telemetry, max_cycles=opts.max_cycles,
            scan_chunk=opts.scan_chunk)
        sols = []
        for i, (p, r) in enumerate(zip(problems, residuals)):
            if out.trivial[i]:
                # packed with zero capacities: the slice is not the
                # instance's state; the idle state (no flow) is
                res = torch.from_numpy(
                    batched.as_state_dtype(r.res0, "res0")).to(
                        out.state.res.device)
                zeros = torch.zeros(r.n, dtype=torch.int32,
                                    device=res.device)
                state = pr.PRState(res=res, h=zeros, e=zeros.clone())
            else:
                state = pr.PRState(res=out.state.res[i, :r.num_arcs],
                                   h=out.state.h[i, :r.n],
                                   e=out.state.e[i, :r.n])
            stats = SolveStats(
                cycles=int(out.cycles[i]), rounds=int(out.rounds[i]),
                global_relabels=out.global_relabels, backend="batched",
                mode=opts.mode, layout=r.layout, batch_size=len(problems),
                gr_sweeps=out.gr_sweeps,
                pushes=(int(out.pushes[i]) if out.pushes is not None
                        else 0),
                relabels=(int(out.relabels[i]) if out.relabels is not None
                          else 0))
            sols.append(Solution(p, int(out.maxflows[i]), stats, state))
        return sols
