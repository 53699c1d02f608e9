"""Run a cell under a planted fault or a control, on several seeds in one
process, and print what the check read on each.

    python3 bench/control.py --workload rlg1m-solve --inject preflow_flows \
        --seeds 11 12 13 --seconds 1

``--inject none`` runs the program as it is (the sound readings).  The
benchmark's own runs never run this.  One JSON line a seed: the seed,
``correct``, each number compared and the requests attempted.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from run import ROOT, _environment  # noqa: F401 (bench/ is on sys.path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--inject", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    _environment()
    import contextlib

    import torch

    from bench.lib import faults, harness, spec

    cell = spec.load_cell(args.workload)
    device = torch.device("cpu" if args.quick else "cuda")
    inject = (contextlib.nullcontext if args.inject == "none"
              else faults.INJECT[args.inject])
    for seed in args.seeds:
        with inject():
            out = harness.run(cell, seed, args.seconds, False, device,
                              time.perf_counter(), quick=args.quick)
        print(json.dumps({"seed": seed, "inject": args.inject,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": {k: v["value"]
                                     for k, v in out["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
