"""Max-flow launcher: the paper's workload end-to-end, through the
``repro_torch.api`` facade (port of ``python -m repro.launch.maxflow``).

``python -m repro_torch.launch.maxflow --generator washington --n 65536``
``python -m repro_torch.launch.maxflow --smoke --device cpu``
``python -m repro_torch.launch.maxflow --backend batched --mode vc_fused --device cpu --smoke``
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core.pushrelabel import ALL_MODES


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--generator", default="powerlaw",
                    choices=["powerlaw", "washington", "genrmf", "grid",
                             "dimacs"])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--layout", default="bcsr", choices=["rcsr", "bcsr"])
    ap.add_argument("--mode", default="vc", choices=list(ALL_MODES))
    ap.add_argument("--backend", default="single",
                    choices=["single", "batched"])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--cycle-chunk", type=int, default=None,
                    help="push-relabel cycles between global relabels")
    ap.add_argument("--dimacs-file", default=None)
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="small instance + --verify")
    args = ap.parse_args(argv)
    if args.smoke:
        args.n = min(args.n, 400)
        args.verify = True

    from repro_torch.api import MaxflowProblem, Solver, SolverOptions
    from repro_torch.graphs import generators as G

    if args.generator == "powerlaw":
        g, s, t = G.powerlaw(args.n, 4, seed=args.seed)
    elif args.generator == "washington":
        k = max(4, int(args.n ** 0.5))
        g, s, t = G.washington_rlg(k, k, seed=args.seed)
    elif args.generator == "genrmf":
        a = max(3, int((args.n / 8) ** (1 / 3)))
        g, s, t = G.genrmf(a, 8, seed=args.seed)
    elif args.generator == "grid":
        k = max(4, int(args.n ** 0.5))
        g, s, t = G.grid_road(k, k, seed=args.seed)
    else:
        from repro_torch.graphs.dimacs import read_dimacs
        g, s, t = read_dimacs(args.dimacs_file)

    solver = Solver(SolverOptions(
        mode=args.mode, layout=args.layout, backend=args.backend,
        device=args.device,
        global_relabel_cadence=args.cycle_chunk))
    problem = MaxflowProblem(g, s, t)
    t0 = time.perf_counter()
    sol = solver.solve(problem)
    dt = time.perf_counter() - t0
    print(f"V={g.n} E={g.m} layout={args.layout} mode={args.mode} "
          f"backend={args.backend} device={sol.state.res.device} "
          f"maxflow={sol.value} "
          f"cycles={sol.stats.cycles} "
          f"global_relabels={sol.stats.global_relabels} time={dt:.3f}s")
    if args.verify:
        from repro_torch.core.ref_maxflow import dinic_maxflow
        want = dinic_maxflow(g, s, t)
        if sol.value != want:
            raise SystemExit(f"max-flow {sol.value} != Dinic oracle {want}")
        print(f"verified against Dinic oracle: {want}")
        if args.smoke:
            print("SMOKE PASS")


if __name__ == "__main__":
    main()
