"""``Solver``: runs problems under a fixed ``SolverOptions`` (port of the
JAX package's ``repro.api.solver`` for ``backend="single"``)."""
from __future__ import annotations

from repro_torch.api.options import SolverOptions
from repro_torch.api.solution import Solution, SolveStats
from repro_torch.core import pushrelabel as pr

_BACKEND_QUEUE = {
    "batched": "Queue 1, 'Batched core'",
    "distributed": "Queue 1, 'Distributed'",
}


class Solver:
    """Executes problems under a fixed ``SolverOptions``.

    ``Solver()`` uses the defaults (on the card);
    ``Solver(mode="vc_kernel", device="cpu")`` is shorthand for
    ``Solver(SolverOptions(mode="vc_kernel", device="cpu"))``.
    """

    def __init__(self, options: SolverOptions | None = None, **overrides):
        if options is None:
            options = SolverOptions(**overrides)
        elif overrides:
            options = options.replace(**overrides)
        self.options = options

    def solve(self, problem) -> Solution:
        opts = self.options
        if opts.backend != "single":
            raise NotImplementedError(
                f"backend {opts.backend!r} is not ported yet (see "
                f"ROADMAP.md {_BACKEND_QUEUE[opts.backend]})")
        r = problem.residual(opts.layout)
        out = pr.solve_impl(
            r, problem.s, problem.t, mode=opts.mode,
            cycle_chunk=opts.global_relabel_cadence,
            max_rounds=opts.max_rounds(r.n), instrument=opts.telemetry,
            device=opts.device, max_cycles=opts.max_cycles,
            scan_chunk=opts.scan_chunk)
        stats = SolveStats(
            cycles=out.cycles, rounds=out.rounds,
            global_relabels=out.global_relabels, gr_sweeps=out.gr_sweeps,
            backend="single", mode=opts.mode, layout=r.layout)
        return Solution(problem, out.maxflow, stats, out.state)
