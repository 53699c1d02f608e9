#!/usr/bin/env python3
"""Host and device time of one engine step on one CUDA card, for a tree of
the port given by its ``src`` directory (two trees are compared in one
session by running this once per tree, in turns).

    python3 chip_steptime.py                      # this checkout
    python3 chip_steptime.py --src OTHER/src --label parent --repeats 5

At the mid-solve state ``chip_smoke.py``'s ``step_timing`` uses (the
main graph ``washington_rlg(1024, 1024, seed=7)``, exact labels, then
256 cycles of ``vc_kernel_bsearch``) it times one engine chunk of the
``vc_kernel_bsearch`` cycle and of the relabel sweep on the min-search
kernel, ``--repeats`` times each in turns, with ``chip_smoke.py``'s
``chunk_timing``, and prints one JSON line a timing, then one with each
loop's median and spread (max - min) of the host ms a step.  It uses
only functions every slice of the port has.  It imports neither ``jax``
nor the JAX package, and exits 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the tree to time")
    ap.add_argument("--label", default="change")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_steptime: no CUDA device is visible", file=sys.stderr)
        return 1
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    import repro_torch
    from repro_torch.core import engine, globalrelabel
    from repro_torch.core import pushrelabel as pr
    from repro_torch.core.csr import build_residual
    from repro_torch.graphs.generators import washington_rlg
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops

    if not pathlib.Path(repro_torch.__file__).resolve().is_relative_to(src):
        print(f"chip_steptime: imported {repro_torch.__file__}, not {src}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all()
    graph, s, t = washington_rlg(1024, 1024, seed=chip_smoke.SEED)
    r = build_residual(graph, "bcsr")
    g, meta, res0 = pr.to_device(r)
    minh_fn = kops.min_neighbor_minh_fn()
    state = pr.preflow(g, meta, res0, s)
    state, _, _ = globalrelabel.global_relabel_impl(g, meta, state, s, t,
                                                    minh_fn)
    state, _ = pr.run_cycles(g, meta, state, s, t, mode="vc_kernel_bsearch",
                             max_cycles=256)
    zero = torch.zeros((), dtype=torch.int32, device=state.res.device)
    body, cond = pr.cycle_loop(g, meta, s, t, "vc_kernel_bsearch",
                               cap=2**30)
    sweep, dist0 = globalrelabel.distance_sweep(g, meta, state.res, t,
                                                minh_fn)
    fp_step, fp_cond, fp_carry = engine.fixpoint_loop(sweep, dist0,
                                                      cap=2**30)
    chunk = engine.DEFAULT_CHUNK
    loops = {"cycle[vc_kernel_bsearch]": (body, cond, (state, zero)),
             "sweep[kernel]": (fp_step, fp_cond, fp_carry)}
    host = {name: [] for name in loops}
    for rep in range(args.repeats):
        for name, (step, cnd, carry) in loops.items():
            def run(step=step, cnd=cnd, carry=carry):
                return engine.run_chunk(step, carry, cond_fn=cnd,
                                        chunk=chunk)

            row = chip_smoke.chunk_timing(torch, run, chunk)
            host[name].append(row["host_ms_per_step"])
            print(json.dumps({"label": args.label, "repeat": rep,
                              "loop": name, **row}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"label": args.label, "src": str(src),
                      "nvidia_smi": smi, "summary": {
                          name: {"host_ms_per_step_median":
                                 statistics.median(v),
                                 "spread": max(v) - min(v), "all": v}
                          for name, v in host.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
