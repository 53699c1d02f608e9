"""Run one cell of the benchmark once.

    python3 bench/run.py --workload rlg1m-solve --seed 7 --seconds 51 --trace 0

from the root of a checkout that holds the program under ``src/``.  The
cell's configuration, traffic mix and metrics are found by name from
``BENCHMARK.json`` (``bench/lib/spec.py``).  The last line of standard
output is the result, one JSON object; the numbers the check compared,
each beside its limit, are the last lines of standard error and the
result's last key.

Exits 1 without a result where no CUDA card is visible or fewer than the
cell asks for, and 2 where the run has loaded JAX, the JAX package or a
module of ``benchmarks/``.  ``--quick`` is the CPU rehearsal the tests
drive: the cell's code at the configuration's and the traffic's
``quick`` sizes on the plain PyTorch path, with no time or device metric.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Import the program from this checkout's ``src/`` and the harness
    from ``bench/``; keep every build and kernel cache inside the
    checkout, at fixed paths."""
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    # one process, few threads: the host's share of the noise
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--quick", action="store_true",
                    help="CPU rehearsal at the quick sizes (tests only)")
    args = ap.parse_args(argv)
    _environment()

    from bench.lib import guard, spec

    cell = spec.load_cell(args.workload)
    import torch

    if args.quick:
        device = torch.device("cpu")
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA card(s); "
                  f"{have} visible", file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    import repro_torch

    if ROOT not in pathlib.Path(repro_torch.__file__).resolve().parents:
        print(f"the program was imported from {repro_torch.__file__}, "
              "not from this checkout", file=sys.stderr)
        return 1

    from bench.lib import harness

    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      device, T_START, quick=args.quick)
    loaded = guard.forbidden_modules(ROOT)
    if loaded:
        print("the run loaded modules it may not: " + ", ".join(loaded),
              file=sys.stderr)
        return 2
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
