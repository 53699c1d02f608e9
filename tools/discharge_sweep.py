#!/usr/bin/env python3
"""Time builds of the port's fused-discharge kernel with other
compile-time constants beside the default one, on one CUDA card.

    python3 tools/discharge_sweep.py            # washington_rlg(1024, 1024)
    python3 tools/discharge_sweep.py --quick    # at 128 x 128

Each build rewrites ``kTile`` (the decide tile's width W), ``kThreads``
(threads a block) and ``kBlocksPerSm`` in a copy of
``src/repro_torch/kernels/csrc/discharge.cu`` under the package's build
directory and compiles it with the package's ``nvcc`` flags, every build
at once.  Each is held bit for bit against the plain version at the state
``chip_smoke.py`` times the kernel at (a global relabel and 256
``vc_kernel_bsearch`` cycles into the solve of ``washington_rlg(1024,
1024, seed=7)``) and timed there and on the idle state (no excess, the
design's floor) by CUDA events, k = 8 cycles a launch.  Prints the card's
name and power limit, then one JSON line a build.  Exits non-zero without
a CUDA card or on a build that disagrees.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: (kTile, kThreads, kBlocksPerSm); the first is the source's own
BUILDS = ((8, 1024, 1), (16, 1024, 1), (32, 1024, 1), (8, 512, 1),
          (8, 512, 2), (8, 256, 4), (8, 256, 8))
CONSTANTS = ("kTile", "kThreads", "kBlocksPerSm")


def build_variants(build) -> dict[tuple[int, int, int], ctypes._CFuncPtr]:
    """Compile every build of :data:`BUILDS` at once and load its entry."""
    src = (build.CSRC / "discharge.cu").read_text()
    out_dir = build.BUILD_DIR / "discharge_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for values in BUILDS:
        text = src
        for name, v in zip(CONSTANTS, values):
            text, hits = re.subn(rf"constexpr int {name} = \d+;",
                                 f"constexpr int {name} = {v};", text)
            if hits != 1:
                raise RuntimeError(f"discharge.cu defines no single {name}")
        stem = "discharge_w{}_t{}_b{}".format(*values)
        (out_dir / f"{stem}.cu").write_text(text)
        lib = out_dir / f"lib{stem}.so"
        procs[values] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
             str(out_dir / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for values, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {values}:\n{log}")
        fn = ctypes.CDLL(str(lib)).fused_discharge_launch
        fn.argtypes = list(
            build.SIGNATURES["discharge"]["fused_discharge_launch"])
        fn.restype = ctypes.c_int
        fns[values] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="a rehearsal at 128 x 128")
    args = ap.parse_args(argv)
    rows, cols = (128, 128) if args.quick else (1024, 1024)

    import torch

    if not torch.cuda.is_available():
        print("discharge_sweep: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.api import MaxflowProblem
    from repro_torch.core import globalrelabel
    from repro_torch.core import pushrelabel as pr
    from repro_torch.graphs.generators import washington_rlg
    from repro_torch.kernels import build, discharge
    from repro_torch.kernels import ops as kops

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    fns = build_variants(build)

    graph, s, t = washington_rlg(rows, cols, seed=cs.SEED)
    g, meta, res0 = pr.to_device(MaxflowProblem(graph, s, t).residual("bcsr"))
    state = pr.preflow(g, meta, res0, s)
    state, _, _ = globalrelabel.global_relabel_impl(
        g, meta, state, s, t, kops.min_neighbor_minh_fn())
    state, _ = pr.run_cycles(g, meta, state, s, t, mode="vc_kernel_bsearch",
                             max_cycles=256)
    n, a, k, dev = meta.n, meta.num_arcs, discharge.K_DEFAULT, g.heads.device
    one = torch.ones(1, dtype=torch.int32, device=dev)
    fargs = (one * s, one * t, g.indptr[None], g.heads[None], g.rev[None],
             state.res[None], state.h[None], state.e[None])
    idle = (*fargs[5:7], torch.zeros_like(fargs[7]))
    work = [x.clone() for x in fargs[5:]]
    scratch = discharge.discharge_scratch(1, n, k, dev)
    gate = torch.ones((), dtype=torch.bool, device=dev)
    want = discharge.fused_discharge_batched_plain(*fargs, n=n, k=k)

    def restore(src):
        for x, y in zip(work, src):
            x.copy_(y)

    for values, fn in fns.items():
        def launch(fn=fn):
            code = fn(*(x.data_ptr() for x in (*fargs[:5], *work)),
                      gate.data_ptr(), *(x.data_ptr() for x in scratch), 1,
                      n, a, k, torch.cuda.current_stream(dev).cuda_stream)
            build.check(code, f"discharge build {values}")
            return (*work, scratch.live, scratch.pushed)

        restore(fargs[5:])
        err = cs.max_abs_err(torch, launch(), want)
        cs.require(err == 0, f"build {values} disagrees with the plain "
                   f"version (max |err| {err})")
        cs.emit({"tile": values[0], "threads": values[1],
                 "blocks_per_sm": values[2], "max_abs_err": err,
                 "ms": cs.device_ms(torch, launch, cs.REPS,
                                    setup=lambda: restore(fargs[5:])),
                 "idle_ms": cs.device_ms(torch, launch, cs.REPS,
                                         setup=lambda: restore(idle)),
                 "graph": f"washington_rlg({rows}, {cols}, seed={cs.SEED})",
                 "k": k, "active": int(pr.active_mask(state, n, s, t).sum())})
    return 0


if __name__ == "__main__":
    sys.exit(main())
