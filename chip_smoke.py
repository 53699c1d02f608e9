#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py            # the full run: washington_rlg(1024, 1024)
    python3 chip_smoke.py --quick    # a rehearsal at 128 x 128; no result

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc``, holds each kernel bit for bit against its plain PyTorch version
on the card (sentinel edge cases, batched rows, and the main path's own
shapes), and drives three paths, each with the launch counts set to 0
just before it and read just after:

* the main path — ``Solver(mode="vc_kernel_bsearch",
  layout="bcsr").solve(...)`` on a DIMACS Washington random-level graph
  of about a million vertices — whose value is held against scipy's
  Dinic and whose final state against the plain ``vc`` mode;
* the fused path — ``Solver(mode="vc_fused").solve(...)`` on the same
  graph, held against the plain ``vc`` mode bit for bit (its cadence of
  1024 cycles is a multiple of K = 8);
* the batched path — ``Solver(backend="batched", mode=m).solve_many(...)``
  on 8 instances of ``washington_rlg(256, 256)`` for ``m`` in
  ``vc_fused``, ``vc_kernel_bsearch`` and ``vc``, each value held against
  scipy's Dinic, and a telemetry solve against its own counters.

The fused discharge is also held against its plain version at the
batched path's own shapes (after the first global relabel and mid-solve)
and on more rows than the card holds resident blocks, through both its
entries: the in-place one the drivers run, with its gate open and closed,
and the out-of-place one.  It checks that one engine chunk of cycles
(``vc_kernel_bsearch`` and ``vc_fused``, single and batched) and of
global-relabel sweeps never synchronises with the host,
and times every kernel beside its plain version, a PyTorch yardstick call
where one exists and its memory bound, the min search's hook with its key
built by eager ops against the entry that gathers the key itself
(``hook_timing``), and each step's host, wall and device time.  The min
search has two entries into one CUDA source, ``tile_min_neighbor`` (key
in, the TPU kernel's function, which no path launches: it is timed against
``scatter_reduce`` and is the gather entry's oracle) and
``tile_min_neighbor_gather`` (the solver's); each is held and timed in
both forms, and each path must leave the key-in entry's count at 0.

Prints one JSON line per phase, the card's name and power limit, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
``--quick`` runs every phase on smaller graphs and leaves out those two
last lines, so a reduced run never passes for the main path.
Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, without a CUDA card or outside the repo.
It imports neither ``jax`` nor the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
#: H100 SXM device-memory rate (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12
#: the JAX package's Pallas kernels each CUDA kernel replaces
REPLACES = {
    "segmin": "src/repro/kernels/segmin.py:104",
    "revsearch": "src/repro/kernels/revsearch.py:67",
    "discharge": "src/repro/kernels/discharge.py:182",
}
SEED = 7
#: CUDA-event timings per median
REPS = 25
#: (rows, cols) of the main path's washington_rlg graph, of the smaller
#: one that ``vc_kernel`` solves, and of each instance of the batched
#: path: the full run and ``--quick``
SIZES = {False: ((1024, 1024), (256, 256), (256, 256)),
         True: ((128, 128), (64, 64), (32, 32))}
#: instances of the batched path (seeds SEED, SEED + 1, ...)
BATCH = 8
#: the batched path's modes
BATCH_MODES = ("vc_fused", "vc_kernel_bsearch", "vc")
#: the kernels' launch counters, by the name the ``kernels`` line uses:
#: the min search's two forms by the key-in entry, the same by the entry
#: that gathers its key itself, the reverse search, the discharge
KERNELS = ("tile_min_neighbor[avq]", "tile_min_neighbor[dense]",
           "tile_min_neighbor_gather[avq]", "tile_min_neighbor_gather[dense]",
           "bcsr_rev_search", "fused_discharge_batched")
#: the kernels each kernel-mode path must launch
MAIN_KERNELS = KERNELS[2:5]
FUSED_KERNELS = ("fused_discharge_batched", "tile_min_neighbor_gather[dense]")
#: the key-in entry, which no path may launch (the solver's hook builds
#: no key array)
KEY_IN = KERNELS[:2]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def device_ms(torch, fn, reps: int, sleep_cycles: int = 5_000_000,
              setup=None) -> float:
    """Median device time of ``fn`` over ``reps`` single calls, by CUDA
    events.  A ``torch.cuda._sleep`` of ``sleep_cycles`` ahead of each call
    keeps the card busy while the host enqueues the call, so the events
    bracket device work only, not host launch gaps.  ``setup()`` runs
    before each call, outside the events (an in-place kernel's restore)."""
    setup = setup or (lambda: None)
    setup()
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        setup()
        torch.cuda._sleep(sleep_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def max_abs_err(torch, got, want) -> int:
    """Largest |got - want| over int32 outputs (0 when bit-equal)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"shape/dtype mismatch {g.shape}/{g.dtype} vs "
                f"{w.shape}/{w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def top_device_ops(torch, fn, steps: int, top: int = 6) -> dict:
    """The device time per step of the ``top`` costliest device kernels
    in one call of ``fn`` (``steps`` steps), by ``torch.profiler``, in µs
    (names cut to 80 characters; ``aten::`` entries are the host-side
    operators around those kernels and are left out)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sorted(((e.key[:80], e.self_device_time_total / steps)
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0
                  and not e.key.startswith("aten::")),
                 key=lambda kv: -kv[1])
    return {k: v for k, v in ops[:top]}


def scipy_maxflow(n, edges, cap, s, t):
    """scipy's Dinic on the same edges (duplicates summed, as
    ``csr_matrix`` does): the independent oracle of the main path.
    Returns ``(value, seconds)``."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_flow

    t0 = time.perf_counter()
    caps = csr_matrix((cap.astype(np.int32), (edges[:, 0], edges[:, 1])),
                      shape=(n, n))
    value = int(maximum_flow(caps, s, t, method="dinic").flow_value)
    return value, time.perf_counter() - t0


def reset_counts() -> None:
    """Every kernel wrapper's launch counter to 0."""
    from repro_torch.kernels.discharge import fused_discharge_batched
    from repro_torch.kernels.revsearch import bcsr_rev_search
    from repro_torch.kernels.segmin import (tile_min_neighbor,
                                            tile_min_neighbor_gather)

    for fn in (tile_min_neighbor, tile_min_neighbor_gather):
        fn.launches = fn.dense_launches = 0
    bcsr_rev_search.launches = fused_discharge_batched.launches = 0


def launch_counts() -> dict:
    """The kernels' launch counters, by the names of ``KERNELS``."""
    from repro_torch.kernels.discharge import fused_discharge_batched
    from repro_torch.kernels.revsearch import bcsr_rev_search
    from repro_torch.kernels.segmin import (tile_min_neighbor,
                                            tile_min_neighbor_gather)

    seg, gat = tile_min_neighbor, tile_min_neighbor_gather
    return dict(zip(KERNELS, (
        seg.launches - seg.dense_launches, seg.dense_launches,
        gat.launches - gat.dense_launches, gat.dense_launches,
        bcsr_rev_search.launches, fused_discharge_batched.launches)))


def driven(torch, fn, expect=()):
    """Run one path, ``fn()``, with the launch counts set to 0 just before
    it and read just after; fail if a kernel of ``expect`` never launched
    or the key-in min search launched at all.  Returns ``(result, wall
    seconds, counts)``."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    for name in expect:
        require(counts[name] > 0, f"{name} never launched on this path")
    for name in KEY_IN:
        require(counts[name] == 0, f"{name} launched on a path")
    return out, wall, counts


def same_solution(torch, sol_a, sol_b, what):
    """Two solutions agree in value, counts and final ``res/h/e``."""
    for f in ("cycles", "rounds", "global_relabels", "gr_sweeps"):
        require(getattr(sol_a.stats, f) == getattr(sol_b.stats, f),
                f"{what}: {f} {getattr(sol_a.stats, f)} != "
                f"{getattr(sol_b.stats, f)}")
    require(sol_a.value == sol_b.value, f"{what}: value differs")
    for f in ("res", "h", "e"):
        require(torch.equal(getattr(sol_a.state, f),
                            getattr(sol_b.state, f)),
                f"{what}: final {f} differs")


def main_path_and_modes(small, torch, problem, batch, oracles):
    """Phases 4 and 5: the main path's solve, the kernel modes and the
    fused path against the plain ``vc`` path, the batched path, and last
    every value against the scipy ``oracles`` (``AsyncResult``s, computed
    meanwhile: the main graph's, then one per batched instance).
    Returns the kernels' launch counts of each path."""
    from repro_torch.api import MaxflowProblem, Solver, SolverOptions
    from repro_torch.core import batched
    from repro_torch.graphs.generators import washington_rlg

    def solve(mode, prob, expect=()):
        return driven(torch, lambda: Solver(SolverOptions(
            mode=mode, layout="bcsr")).solve(prob), expect)

    main, wall, launches = solve("vc_kernel_bsearch", problem, MAIN_KERNELS)
    st = main.stats
    emit({"phase": "main_path", "mode": "vc_kernel_bsearch", "wall_s": wall,
          "value": main.value, "cycles": st.cycles, "rounds": st.rounds,
          "global_relabels": st.global_relabels, "gr_sweeps": st.gr_sweeps,
          "launches": launches,
          "ms_per_cycle_plus_sweep": 1e3 * wall / (st.cycles + st.gr_sweeps)})
    paths = {"main": launches}

    # -- 5. kernel modes and the fused path against the plain torch path ---
    plain, wall_vc, _ = solve("vc", problem)
    same_solution(torch, main, plain, "vc_kernel_bsearch vs vc")
    g_s, s_s, t_s = washington_rlg(*small, seed=SEED)
    p_small = MaxflowProblem(g_s, s_s, t_s)
    p_small.residual("bcsr")
    k_small, wall_k, _ = solve("vc_kernel", p_small)
    v_small, wall_v, _ = solve("vc", p_small)
    same_solution(torch, k_small, v_small, "vc_kernel vs vc")
    emit({"phase": "modes_vs_plain", "ok": True, "vc_wall_s": wall_vc,
          "small_graph": f"washington_rlg({small[0]}, {small[1]}, "
          f"seed={SEED})",
          "small_value": k_small.value, "small_cycles": k_small.stats.cycles,
          "small_vc_kernel_wall_s": wall_k, "small_vc_wall_s": wall_v})

    fused, wall_f, paths["fused"] = solve("vc_fused", problem,
                                          FUSED_KERNELS)
    same_solution(torch, fused, plain, "vc_fused vs vc")
    emit({"phase": "fused_path", "mode": "vc_fused", "wall_s": wall_f,
          "value": fused.value, "cycles": fused.stats.cycles,
          "rounds": fused.stats.rounds, "gr_sweeps": fused.stats.gr_sweeps,
          "launches": paths["fused"], "same_as_vc": True})

    # -- 5b. the batched path -----------------------------------------------
    sols = {}
    expect = {"vc_fused": FUSED_KERNELS, "vc_kernel_bsearch": MAIN_KERNELS,
              "vc": ()}
    for mode in BATCH_MODES:
        sols[mode], wall_b, paths[f"batched[{mode}]"] = driven(
            torch, lambda mode=mode: Solver(
                backend="batched", mode=mode).solve_many(batch),
            expect[mode])
        emit({"phase": "batched_path", "mode": mode, "batch": len(batch),
              "wall_s": wall_b, "values": [x.value for x in sols[mode]],
              "cycles": [x.stats.cycles for x in sols[mode]],
              "global_relabels": sols[mode][0].stats.global_relabels,
              "gr_sweeps": sols[mode][0].stats.gr_sweeps,
              "launches": paths[f"batched[{mode}]"]})
    for i, (a, b) in enumerate(zip(sols["vc_kernel_bsearch"], sols["vc"])):
        same_solution(torch, a, b, f"batched vc_kernel_bsearch vs vc [{i}]")
    # the fused mode's pushed-flag exit looks at whole launches, so a row
    # may run up to K - 1 cycles more; where a row's cycles and the batch's
    # rounds match, its final state must match too
    same_rows = 0
    for i, (a, b) in enumerate(zip(sols["vc_fused"], sols["vc"])):
        require(a.value == b.value, "batched vc_fused value differs")
        if (a.stats.cycles == b.stats.cycles
                and a.stats.rounds == b.stats.rounds
                and a.stats.gr_sweeps == b.stats.gr_sweeps):
            same_solution(torch, a, b, f"batched vc_fused vs vc [{i}]")
            same_rows += 1
    emit({"phase": "batched_fused_vs_vc", "rows_state_equal": same_rows,
          "rows": len(batch)})
    insts = [(p.residual("bcsr"), p.s, p.t) for p in batch]
    tel = batched.batched_solve_impl(insts, mode="vc_fused", telemetry=True)
    require((tel.pushes + tel.relabels == tel.active_sum).all(),
            "telemetry: pushes + relabels != active")
    require(tel.maxflows.tolist() == [x.value for x in sols["vc_fused"]]
            and tel.cycles.tolist() == [x.stats.cycles
                                        for x in sols["vc_fused"]],
            "telemetry changed the batched vc_fused solve")
    emit({"phase": "batched_telemetry", "ok": True,
          "pushes": tel.pushes.tolist(), "relabels": tel.relabels.tolist(),
          "active_sum": tel.active_sum.tolist(),
          "frontier_sum": tel.frontier_sum.tolist()})

    want, t_scipy = oracles[0].get()
    emit({"phase": "oracle", "scipy_dinic_s": t_scipy, "scipy_value": want})
    require(main.value == want,
            f"vc_kernel_bsearch value {main.value} != scipy Dinic {want}")
    got = [o.get() for o in oracles[1:]]
    emit({"phase": "batched_oracle", "scipy_values": [v for v, _ in got],
          "scipy_dinic_s": [x for _, x in got]})
    for mode in BATCH_MODES:
        require([x.value for x in sols[mode]] == [v for v, _ in got],
                f"batched {mode} values != scipy Dinic")
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="rehearse on small graphs; prints no result")
    args = ap.parse_args(argv)
    (rows, cols), small, bsize = SIZES[args.quick]

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()

    # -- 1. device ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from repro_torch.kernels import build

    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "nvcc": next(ln for ln in nvcc if "release" in ln),
          "python": sys.version.split()[0]})

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    ptxas = [line.strip() for log in logs.values()
             for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: build.library_path(n).name
                        for n in build.SIGNATURES}, "ptxas": ptxas})

    import numpy as np

    from repro_torch.api import MaxflowProblem
    from repro_torch.core import batched, engine, globalrelabel
    from repro_torch.core import pushrelabel as pr
    from repro_torch.core.csr import Graph, build_residual
    from repro_torch.graphs.generators import random_sparse, washington_rlg
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import discharge
    from repro_torch.kernels.discharge import (K_DEFAULT,
                                               fused_discharge_batched,
                                               fused_discharge_batched_,
                                               fused_discharge_batched_plain)
    from repro_torch.kernels.revsearch import bcsr_rev_search, search_steps
    from repro_torch.kernels.segmin import (tile_min_neighbor,
                                            tile_min_neighbor_gather,
                                            tile_min_neighbor_gather_plain,
                                            tile_min_neighbor_plain)

    dev = torch.device("cuda")
    inf = kref.INF
    errs = dict.fromkeys(KERNELS, 0)

    def hold(name, got, want, what):
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        require(err == 0, f"{name} differs from its plain version on {what} "
                f"(max |err| {err})")
        errs[name] = max(errs[name], err)

    # -- 3. kernels against their plain versions: edge cases ----------------
    rng = np.random.default_rng(SEED)
    n_e = 64
    deg = rng.integers(0, 12, size=n_e)
    deg[[3, 9]] = 0  # empty segments
    deg[17] = 3000  # a segment longer than 1024 arcs
    indptr = torch.tensor(np.concatenate([[0], np.cumsum(deg)]),
                          dtype=torch.int32, device=dev)
    a_e = int(deg.sum())
    key_np = rng.integers(0, n_e + 3, size=(3, a_e)).astype(np.int64)
    key_np[:, rng.random(a_e) < 0.3] = inf
    ends = np.concatenate([[0], np.cumsum(deg)])
    key_np[:, ends[20]:ends[21]] = inf  # an all-INF segment
    key = torch.tensor(key_np, dtype=torch.int32, device=dev)
    avq_np = np.full((3, n_e), n_e, np.int64)  # u >= n padding
    special = [3, 17, 20, 9]  # empty, long, all-INF, empty
    others = np.setdiff1d(np.arange(n_e), special)
    for b in range(3):  # distinct entries, as an AVQ holds
        avq_np[b, :40] = np.concatenate(
            [special, np.sort(rng.choice(others, size=36, replace=False))])
    avq = torch.tensor(avq_np, dtype=torch.int32, device=dev)
    ind3 = indptr.expand(3, -1).contiguous()
    for a_row, k_row, what in ((avq[0], key[0], "1-D"),
                               (avq, key, "B=3")):
        ip = indptr if a_row.ndim == 1 else ind3
        hold("tile_min_neighbor[avq]",
             tile_min_neighbor(a_row, ip, k_row, n=n_e),
             tile_min_neighbor_plain(a_row, ip, k_row, n=n_e), what)
        hold("tile_min_neighbor[dense]",
             tile_min_neighbor(None, ip, k_row, n=n_e),
             tile_min_neighbor_plain(None, ip, k_row, n=n_e), what)
    # dense form == avq of arange(n), bit for bit
    hold("tile_min_neighbor[dense]",
         tile_min_neighbor(None, indptr, key[1], n=n_e),
         tile_min_neighbor(torch.arange(n_e, dtype=torch.int32, device=dev),
                           indptr, key[1], n=n_e), "arange(n) avq")
    # the tiled dense form and the ballot AVQ form, both entries: rows of
    # 600 vertices (not a multiple of the dense tile of 256) with a hub of
    # 3000 arcs, a tile of empty segments only (vertices 256..511), empty
    # and all-INF segments, heads out of range inside segments and on each
    # row's padded arcs, INF heights; queues of Q = 40, n and 2n + 13 whose
    # valid entries are not a prefix, among u >= n and u < 0 sentinels
    n_r, ips = 600, []
    for _ in range(3):
        deg = rng.integers(0, 10, size=n_r)
        deg[[4, 40]] = 0
        deg[256:512] = 0
        deg[7] = 3000
        ips.append(np.concatenate([[0], np.cumsum(deg)]))
    a_r = max(int(x[-1]) for x in ips) + 17
    heads_np = rng.integers(-3, n_r + 3, size=(3, a_r))
    res_np = rng.integers(-1, 3, size=(3, a_r))
    for b, ip_ in enumerate(ips):
        res_np[b, ip_[11]:ip_[12]] = 0  # an all-INF segment
        res_np[b, ip_[-1]:] = 1  # padded arcs
    h_np = rng.integers(0, n_r + 2, size=(3, n_r))
    h_np[rng.random((3, n_r)) < 0.1] = inf
    key_np = np.where(res_np > 0, np.take_along_axis(
        h_np, np.clip(heads_np, 0, n_r - 1), axis=1), inf)
    ip_r, heads_r, res_r, h_r, key_r = (
        torch.tensor(x, dtype=torch.int32, device=dev)
        for x in (np.stack(ips), heads_np, res_np, h_np, key_np))
    special = [7, 4, 11, 300]  # hub, empty, all-INF, in the empty tile
    others = np.setdiff1d(np.arange(n_r), special)
    queues = []
    for q in (40, n_r, 2 * n_r + 13):
        live = min(q // 2, n_r - len(special))
        queues.append(torch.tensor(np.stack([rng.permutation(np.concatenate([
            special[:live], rng.choice(others, size=live - min(live, 4),
                                       replace=False),
            rng.choice([n_r, n_r + 7, -1, -5], size=q - live)]))
            for _ in range(3)]), dtype=torch.int32, device=dev))
    for q_r in queues + [None]:
        form = "dense" if q_r is None else "avq"
        for sl, what in ((0, "1-D"), (slice(None), "B=3")):
            avq_s = None if q_r is None else q_r[sl]
            what = f"{what}, Q={n_r if q_r is None else q_r.shape[-1]}"
            gargs = (avq_s, ip_r[sl], heads_r[sl], res_r[sl], h_r[sl])
            got = tile_min_neighbor(avq_s, ip_r[sl], key_r[sl], n=n_r)
            hold(f"tile_min_neighbor[{form}]", got,
                 tile_min_neighbor_plain(avq_s, ip_r[sl], key_r[sl], n=n_r),
                 what)
            hold(f"tile_min_neighbor_gather[{form}]",
                 tile_min_neighbor_gather(*gargs, n=n_r),
                 tile_min_neighbor_gather_plain(*gargs, n=n_r), what)
            hold(f"tile_min_neighbor_gather[{form}]",
                 tile_min_neighbor_gather(*gargs, n=n_r), got,
                 f"{what}, against the key entry")

    # reverse search: three BCSR rows padded to one arc count, a hub
    # vertex of degree > 1024 for deep searches, arcs >= A as sentinels
    bcsr_rows = []
    for b in range(3):
        g0, _, _ = random_sparse(1500, 4000, seed=SEED + b)
        hub = np.stack([np.zeros(1300, np.int64), np.arange(1, 1301)], axis=1)
        bcsr_rows.append(build_residual(Graph(1500, np.concatenate([g0.edges, hub]),
                                         np.ones(5300, np.int64)), "bcsr"))
    a_r = max(r.num_arcs for r in bcsr_rows)
    deg_max = max(r.deg_max for r in bcsr_rows)

    def padded(field):
        return torch.tensor(np.stack([np.pad(getattr(r, field),
                                             (0, a_r - r.num_arcs))
                                      for r in bcsr_rows]), dtype=torch.int32,
                            device=dev)

    heads3, tails3, rev3 = padded("heads"), padded("tails"), padded("rev")
    indptr3 = torch.tensor(np.stack([r.indptr for r in bcsr_rows]),
                           dtype=torch.int32, device=dev)
    arcs3 = torch.tensor(np.stack([
        np.where(q < r.num_arcs, q, a_r) for r, q in
        ((r, rng.integers(0, r.num_arcs + 8, size=4 * a_r)) for r in bcsr_rows)]),
        dtype=torch.int32, device=dev)
    steps = search_steps(deg_max)
    for sl, what in ((0, "1-D"), (slice(None), "B=3")):
        got = bcsr_rev_search(arcs3[sl], indptr3[sl], heads3[sl], tails3[sl],
                              deg_max=deg_max)
        hold("bcsr_rev_search", got,
             kref.rev_search_bsearch_ref(arcs3[sl], indptr3[sl], heads3[sl],
                                         tails3[sl], steps=steps), what)
        if what == "1-D":
            hold("bcsr_rev_search", got,
                 kref.rev_search_ref(arcs3[0], rev3[0], a_r), "rev table")

    # fused discharge: k in {1, 3, 8}, counters off and on, on three
    # washington rows of different sizes (padded vertices and arcs) whose
    # last is trivial (s == t), and on a hub of 3000 arcs; the states right
    # after preflow (an all-relabel first cycle), after a global relabel,
    # and an idle one (no excess); both entries, the in-place one with its
    # gate open (the plain version's state and outputs) and closed (the
    # state untouched, every output 0), one launch a call
    def in_place(args, n_b, k, counters, want, what):
        """The in-place entry on a copy of ``args``' state, against
        ``want``, the plain version's flattened outputs."""
        for gate in (True, False):
            st = [x.clone() for x in args[5:]]
            before = fused_discharge_batched.launches
            out = fused_discharge_batched_(
                *args[:5], *st, n=n_b, k=k, counters=counters,
                gate=torch.tensor(gate, device=dev))
            require(fused_discharge_batched.launches == before + 1,
                    "the in-place entry did not count one launch")
            out = tuple(out[:2]) + (tuple(out[2]) if counters else ())
            hold("fused_discharge_batched", (*st, *out), tuple(want) if gate
                 else tuple(args[5:]) + tuple(map(torch.zeros_like, out)),
                 f"{what}, in place, gate {'open' if gate else 'closed'}")

    def fused_cases(insts, what):
        bg, meta_b, res0_b, triv = batched.pack_instances(insts)
        pre = batched.batched_preflow(bg, meta_b, res0_b)
        post = batched.batched_global_relabel(bg, meta_b, pre)[0]
        idle = batched.BatchedPRState(post.res, post.h,
                                      torch.zeros_like(post.e))
        for name, st in (("preflow", pre), ("global_relabel", post),
                         ("idle", idle)):
            args = (bg.s, bg.t, bg.indptr, bg.heads, bg.rev, *st)
            for k in (1, 3, 8):
                for counters in (False, True):
                    got = fused_discharge_batched(*args, n=meta_b.n, k=k,
                                                  counters=counters)
                    want = fused_discharge_batched_plain(
                        *args, n=meta_b.n, k=k, counters=counters)
                    if counters:
                        got, want = got[:5] + got[5], want[:5] + want[5]
                    hold("fused_discharge_batched", tuple(got), tuple(want),
                         f"{what}, {name}, k={k}, counters={counters}")
                    require(all(torch.equal(a, b) for a, b in
                                zip(args[5:], st)),
                            "the out-of-place entry changed its inputs")
                    in_place(args, meta_b.n, k, counters, want,
                             f"{what}, {name}, k={k}, counters={counters}")
                    live, pushed = got[3].tolist(), got[4].tolist()
                    require(all(x == 0 for x, tr in zip(live, triv) if tr),
                            "a trivial lane lived")
                    if name == "idle":
                        require(live == [0] * len(live) and not any(pushed)
                                and all(torch.equal(a, b) for a, b in
                                        zip(got[:3], st)),
                                "the idle state changed")
                    if name == "preflow" and k == 1:
                        require(not any(pushed) and all(
                            x == 1 for x, tr in zip(live, triv) if not tr),
                            "the first cycle after preflow pushed")

    wash = []
    for i, (r_, c_) in enumerate(((12, 12), (9, 14), (12, 12))):
        g0, s0, t0_ = washington_rlg(r_, c_, seed=SEED + i)
        wash.append((build_residual(g0, "bcsr"), s0, s0 if i == 2 else t0_))
    fused_cases(wash, "B=3")
    g0, _, _ = random_sparse(3500, 6000, seed=SEED)
    spokes = np.arange(2, 3002)
    hub_edges = np.concatenate([
        g0.edges, [[0, 1]], np.stack([np.ones_like(spokes), spokes], 1),
        np.stack([spokes, np.full_like(spokes, 3499)], 1)])
    hub_cap = np.concatenate([g0.cap, [200], np.ones(6000, np.int64)])
    hub = build_residual(Graph(3500, hub_edges, hub_cap), "bcsr")
    require(int(np.diff(hub.indptr)[1]) >= 3000, "the hub is short")
    fused_cases([(hub, 0, 3499)], "hub of 3000 arcs")
    # more rows than blocks of 256 threads can be resident at once: the
    # cooperative grid holds min(B, resident) rows and runs the rest in
    # rounds (the plain version runs on the host's CPU, for speed)
    props = torch.cuda.get_device_properties(dev)
    most = (getattr(props, "max_threads_per_multi_processor", 2048) // 256
            * props.multi_processor_count)
    bg3, meta3, res03, _ = batched.pack_instances(wash)
    st3 = batched.batched_global_relabel(
        bg3, meta3, batched.batched_preflow(bg3, meta3, res03))[0]
    reps = most // 3 + 1
    many = tuple(x.repeat(reps, *([1] * (x.ndim - 1))) for x in
                 (bg3.s, bg3.t, bg3.indptr, bg3.heads, bg3.rev, *st3))
    got = fused_discharge_batched(*many, n=meta3.n, k=3, counters=True)
    want = fused_discharge_batched_plain(*(x.cpu() for x in many),
                                         n=meta3.n, k=3, counters=True)
    want = tuple(w.to(dev) for w in want[:5] + want[5])
    hold("fused_discharge_batched", tuple(got[:5] + got[5]), want,
         f"B={3 * reps} rows > {most} resident blocks")
    in_place(many, meta3.n, 3, True, want,
             f"B={3 * reps} rows > {most} resident blocks")
    emit({"phase": "kernels_edge_cases", "ok": True, "max_abs_err": errs})

    # -- 4. the main path at full size --------------------------------------
    t0 = time.perf_counter()
    graph, s, t = washington_rlg(rows, cols, seed=SEED)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    problem = MaxflowProblem(graph, s, t)
    r = problem.residual("bcsr")
    t_csr = time.perf_counter() - t0
    emit({"phase": "main_graph", "graph": f"washington_rlg({rows}, "
          f"{cols}, seed={SEED})", "n": r.n, "edges": graph.m,
          "arcs": r.num_arcs, "deg_max": r.deg_max, "gen_s": t_gen,
          "csr_s": t_csr})
    t0 = time.perf_counter()
    bgraphs = [washington_rlg(*bsize, seed=SEED + i) for i in range(BATCH)]
    batch = [MaxflowProblem(*bg_) for bg_ in bgraphs]
    for p_ in batch:
        p_.residual("bcsr")
    emit({"phase": "batch_graphs", "graph": f"washington_rlg({bsize[0]}, "
          f"{bsize[1]}, seed={SEED}..{SEED + BATCH - 1})",
          "n": [p_.residual("bcsr").n for p_ in batch],
          "arcs": [p_.residual("bcsr").num_arcs for p_ in batch],
          "gen_s": time.perf_counter() - t0})
    # scipy's Dinic takes minutes at the main graph's size: it runs in a
    # process of its own while the card solves, and a second process
    # solves the batched instances; leaving the block terminates both
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        oracles = [pool.apply_async(scipy_maxflow, (graph.n, graph.edges,
                                                    graph.cap, s, t))]
        oracles += [pool.apply_async(scipy_maxflow, (g_.n, g_.edges, g_.cap,
                                                     s_, t_))
                    for g_, s_, t_ in bgraphs]
        paths = main_path_and_modes(small, torch, problem, batch, oracles)
    emit({"phase": "launches_by_path", **paths})

    # -- 6. no host sync inside an engine chunk -----------------------------
    g, meta, res0 = pr.to_device(r)
    state = pr.preflow(g, meta, res0, s)
    minh_fn = kops.min_neighbor_minh_fn()
    sweep, dist0 = globalrelabel.distance_sweep(g, meta, state.res, t,
                                                minh_fn)
    fp_step, fp_cond, fp_carry = engine.fixpoint_loop(sweep, dist0, cap=r.n)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    loops = {mode: pr.cycle_loop(g, meta, s, t, mode, cap=1024)
             for mode in ("vc_kernel_bsearch", "vc_fused")}
    # the fused step updates its carry's state in place: its own copy
    carries = {"vc_kernel_bsearch": (state, zero),
               "vc_fused": (pr.PRState(*(x.clone() for x in state)), zero)}
    bbg, bmeta, bres0, _ = batched.pack_instances(
        [(p_.residual("bcsr"), p_.s, p_.t) for p_ in batch])
    bstate = batched.batched_global_relabel(
        bbg, bmeta, batched.batched_preflow(bbg, bmeta, bres0))[0]
    b_step, b_cond, b_carry = batched.batched_cycle_loop(
        bbg, bmeta, bstate, "vc_fused", 1024)
    # the fused kernel at the batched path's shapes: 8 rows of 65,538
    # vertices, many blocks per row
    bargs = (bbg.s, bbg.t, bbg.indptr, bbg.heads, bbg.rev)
    for counters in (False, True):
        got = fused_discharge_batched(*bargs, *bstate, n=bmeta.n,
                                      k=K_DEFAULT, counters=counters)
        want = fused_discharge_batched_plain(*bargs, *bstate, n=bmeta.n,
                                             k=K_DEFAULT, counters=counters)
        if counters:
            got, want = got[:5] + got[5], want[:5] + want[5]
        hold("fused_discharge_batched", tuple(got), tuple(want),
             f"batched path, post-relabel, counters={counters}")
        in_place((*bargs, *bstate), bmeta.n, K_DEFAULT, counters, want,
                 f"batched path, post-relabel, counters={counters}")
    # the min search at the batched path's shapes, both entries and forms
    bavq = batched.row_avq(batched.active_rows(bstate.h, bstate.e, bmeta.n,
                                               bbg.s, bbg.t))
    bkey = torch.where(bstate.res > 0, torch.gather(
        bstate.h, 1, torch.clamp(bbg.heads, 0, bmeta.n - 1).long()), inf)
    for q_b, form in ((bavq, "avq"), (None, "dense")):
        gargs = (q_b, bbg.indptr, bbg.heads, bstate.res, bstate.h)
        hold(f"tile_min_neighbor[{form}]",
             tile_min_neighbor(q_b, bbg.indptr, bkey, n=bmeta.n),
             tile_min_neighbor_plain(q_b, bbg.indptr, bkey, n=bmeta.n),
             "batched path, post-relabel")
        hold(f"tile_min_neighbor_gather[{form}]",
             tile_min_neighbor_gather(*gargs, n=bmeta.n),
             tile_min_neighbor_gather_plain(*gargs, n=bmeta.n),
             "batched path, post-relabel")
    chunk = engine.DEFAULT_CHUNK
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fp_carry = engine.run_chunk(fp_step, fp_carry, cond_fn=fp_cond,
                                    chunk=chunk)
        for mode, (body, cond) in loops.items():
            carries[mode] = engine.run_chunk(body, carries[mode],
                                             cond_fn=cond, chunk=chunk,
                                             pass_gate=mode == "vc_fused")
        b_carry = engine.run_chunk(b_step, b_carry, cond_fn=b_cond,
                                   chunk=chunk, pass_gate=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    require(int(fp_carry[2]) == chunk
            and int(carries["vc_kernel_bsearch"][1]) == chunk
            and int(carries["vc_fused"][1]) == chunk * K_DEFAULT
            and int(b_carry[2]) == chunk * K_DEFAULT,
            "the sync-free chunks did not run their steps")
    emit({"phase": "no_host_sync", "ok": True, "chunk": chunk,
          "loops": ["sweep[kernel]", "cycle[vc_kernel_bsearch]",
                    "cycle[vc_fused]", "batched cycle[vc_fused]"]})
    # and mid-solve, at the state the batched chunk left
    got = fused_discharge_batched(*bargs, *b_carry[0], n=bmeta.n,
                                  k=K_DEFAULT, counters=True)
    want = fused_discharge_batched_plain(*bargs, *b_carry[0], n=bmeta.n,
                                         k=K_DEFAULT, counters=True)
    hold("fused_discharge_batched", tuple(got[:5] + got[5]),
         tuple(want[:5] + want[5]), "batched path, mid-solve")
    emit({"phase": "fused_batched_shapes", "ok": True, "B": BATCH,
          "n_pad": bmeta.n, "A_pad": int(bbg.heads.shape[1]),
          "live_mid_solve": got[3].tolist()})

    # -- 3b. kernels at the main path's shapes, timed -----------------------
    # a mid-solve state: exact labels, then 256 cycles of the main mode
    state, _, _ = globalrelabel.global_relabel_impl(g, meta, state, s, t,
                                                    minh_fn)
    state, _ = pr.run_cycles(g, meta, state, s, t, mode="vc_kernel_bsearch",
                             max_cycles=256)
    n, a = meta.n, meta.num_arcs
    act = pr.active_mask(state, n, s, t)
    avq = torch.nonzero_static(act, size=n, fill_value=n).view(-1).to(
        torch.int32)
    key = torch.where(state.res > 0, state.h[g.heads], inf)
    n_active = int(act.sum())
    frontier = int((g.indptr[1:] - g.indptr[:-1])[act].sum())
    dist = torch.clamp(globalrelabel.residual_distances_impl(
        g, meta, state.res, t, minh_fn)[0] + 1, max=inf)
    dkey = torch.where(state.res > 0, dist[g.heads], inf)
    # arcs with res > 0, of the frontier (the AVQ gather reads their head)
    # and of the graph (the dense gather's), and the distinct heads among
    # them, whose heights each gather reads once
    f_mask = act[g.tails.long()] & (state.res > 0)
    frontier_pos = int(f_mask.sum())
    frontier_heads = int(torch.unique(g.heads[f_mask]).numel())
    res_pos = int((state.res > 0).sum())
    res_heads = int(torch.unique(g.heads[state.res > 0]).numel())
    minh, argarc = tile_min_neighbor(avq, g.indptr, key, n=n)
    u_c = torch.clamp(avq, max=n - 1)
    _, do_push = pr._push_decision(state.h, u_c, avq < n, minh)
    push = torch.where(do_push, torch.clamp(argarc, 0, a - 1), a)
    n_push = int(do_push.sum())
    steps = search_steps(meta.deg_max)
    tails64 = g.tails.long()
    pair = tails64 * n + g.heads.long()  # sorted under BCSR
    pv = torch.clamp(push, max=a - 1).long()
    query = g.heads.long()[pv] * n + g.tails.long()[pv]
    cases = {
        "tile_min_neighbor[avq]": dict(
            kernel=lambda: tile_min_neighbor(avq, g.indptr, key, n=n),
            plain=lambda: tile_min_neighbor_plain(avq, g.indptr, key, n=n),
            # every entry: read avq, write two outputs; active entries
            # also read two indptr words; each frontier arc one key
            library=None, bytes=12 * n + 8 * n_active + 4 * frontier,
            source="segmin", shape={"Q": n, "A": a, "active": n_active,
                                    "frontier_arcs": frontier}),
        "tile_min_neighbor[dense]": dict(
            kernel=lambda: tile_min_neighbor(None, g.indptr, dkey, n=n),
            plain=lambda: tile_min_neighbor_plain(None, g.indptr, dkey, n=n),
            library=lambda: torch.full((n,), inf, dtype=torch.int32,
                                       device=dev).scatter_reduce_(
                0, tails64, dkey, "amin"),
            bytes=4 * (n + 1) + 4 * a + 8 * n, source="segmin",
            shape={"Q": n, "A": a}),
        "tile_min_neighbor_gather[avq]": dict(
            kernel=lambda: tile_min_neighbor_gather(
                avq, g.indptr, g.heads, state.res, state.h, n=n),
            plain=lambda: tile_min_neighbor_gather_plain(
                avq, g.indptr, g.heads, state.res, state.h, n=n),
            # the key-in form's bytes with res for each frontier arc, the
            # head of each with res > 0 and each such head's height once
            library=None, bytes=12 * n + 8 * n_active + 4 * frontier
            + 4 * frontier_pos + 4 * frontier_heads, source="segmin",
            shape={"Q": n, "A": a, "active": n_active,
                   "frontier_arcs": frontier,
                   "frontier_arcs_res_pos": frontier_pos,
                   "their_heads": frontier_heads}),
        "tile_min_neighbor_gather[dense]": dict(
            kernel=lambda: tile_min_neighbor_gather(
                None, g.indptr, g.heads, state.res, dist, n=n),
            plain=lambda: tile_min_neighbor_gather_plain(
                None, g.indptr, g.heads, state.res, dist, n=n),
            # indptr, every res, the head of each arc with res > 0 and each
            # such head's height once, two outputs per vertex
            library=None, bytes=4 * (n + 1) + 4 * a + 4 * res_pos
            + 4 * res_heads + 8 * n, source="segmin",
            shape={"Q": n, "A": a, "arcs_res_pos": res_pos,
                   "their_heads": res_heads}),
        "bcsr_rev_search": dict(
            kernel=lambda: bcsr_rev_search(push, g.indptr, g.heads, g.tails,
                                           deg_max=meta.deg_max),
            plain=lambda: kref.rev_search_bsearch_ref(
                push, g.indptr, g.heads, g.tails, steps=steps),
            library=lambda: torch.searchsorted(pair, query),
            # every lane: read its arc, write its result; a pushing lane
            # also reads tail, head, two indptr words, steps + 1 probes
            bytes=8 * n + 4 * n_push * (5 + steps), source="revsearch",
            shape={"P": n, "pushes": n_push, "steps": steps}),
    }
    # the fused discharge's bytes come from this state's own cycles: the
    # plain vc_step run K times gives each cycle's vertices with excess,
    # active vertices, frontier arcs, those of them with res > 0 and the
    # distinct heads of those, held against the kernel's counters
    one = torch.ones(1, dtype=torch.int32, device=dev)
    fargs = (one * s, one * t, g.indptr[None], g.heads[None], g.rev[None],
             state.res[None], state.h[None], state.e[None])
    fcnt = [c[0].cpu().numpy().astype(np.int64) for c in
            fused_discharge_batched(*fargs, n=n, k=K_DEFAULT,
                                    counters=True)[5]]
    f_act, f_push, f_fr, _ = fcnt
    f_ex, f_pos, f_heads, st_c = [], [], [], state
    for c in range(K_DEFAULT):
        act_c = pr.active_mask(st_c, n, s, t)
        on = act_c[g.tails.long()]
        require(int(act_c.sum()) == f_act[c] and int(on.sum()) == f_fr[c],
                "the fused counters disagree with the plain cycles")
        ex = st_c.e > 0
        ex[[s, t]] = False
        on_pos = on & (st_c.res > 0)
        f_ex.append(int(ex.sum()))
        f_pos.append(int(on_pos.sum()))
        f_heads.append(int(torch.unique(g.heads[on_pos]).numel()))
        st_c = pr.vc_step(g, meta, st_c, s, t)
    f_ex, f_pos, f_heads = (np.array(x, np.int64)
                            for x in (f_ex, f_pos, f_heads))
    # the in-place launch the drivers make, on its own copy of the state
    # (restored from ``fargs`` before each call, outside the timed events)
    # with a loop's scratch and an open gate on the device; and the same
    # launch on the idle state (no excess), the design's floor
    fwork = [x.clone() for x in fargs[5:]]
    fscratch = discharge.discharge_scratch(1, n, K_DEFAULT, dev)
    gate_open = torch.ones((), dtype=torch.bool, device=dev)
    idle_state = (*fargs[5:7], torch.zeros_like(fargs[7]))

    def restore(src):
        for x, y in zip(fwork, src):
            x.copy_(y)

    def fused_launch():
        return (*fwork, *fused_discharge_batched_(
            *fargs[:5], *fwork, n=n, k=K_DEFAULT, gate=gate_open,
            scratch=fscratch))

    cases["fused_discharge_batched"] = dict(
        kernel=fused_launch, setup=lambda: restore(fargs[5:]),
        plain=lambda: fused_discharge_batched_plain(*fargs, n=n,
                                                    k=K_DEFAULT),
        # per cycle: e of every vertex and h of each with e > 0 (not s or
        # t); two indptr words of each active one; res of each frontier
        # arc, the head of each with res > 0 and each such head's height
        # once; each push's rev and four updates; each relabel's height
        library=None,
        bytes=int(K_DEFAULT * 4 * n + 4 * f_ex.sum() + 8 * f_act.sum()
                  + 4 * f_fr.sum() + 4 * f_pos.sum() + 4 * f_heads.sum()
                  + 20 * f_push.sum() + 4 * (f_act - f_push).sum()),
        source="discharge",
        shape={"B": 1, "n": n, "A": a, "k": K_DEFAULT,
               "active": f_act.tolist(), "pushes": f_push.tolist(),
               "frontier_arcs": f_fr.tolist(),
               "excess_vertices": f_ex.tolist(),
               "frontier_arcs_res_pos": f_pos.tolist(),
               "their_heads": f_heads.tolist(),
               # what the design moves besides, per active vertex and
               # cycle: its queue slot written once and read twice, its
               # int2 decision written and read once
               "queue_and_decision_bytes": int(28 * f_act.sum())})
    cases["fused_discharge_batched[idle]"] = dict(
        kernel=fused_launch, setup=lambda: restore(idle_state),
        plain=lambda: fused_discharge_batched_plain(*fargs[:5], *idle_state,
                                                    n=n, k=K_DEFAULT),
        # e of every vertex, read once: no vertex is active, so the state
        # is a fixpoint
        library=None, bytes=4 * n, source="discharge",
        shape={"B": 1, "n": n, "A": a, "k": K_DEFAULT, "active": 0})
    # the least time the CUDA-event pair reports for any launch
    tiny = torch.zeros(1, dtype=torch.int32, device=dev)
    emit({"phase": "timing_floor", "what": "one-element fill_",
          "ms": device_ms(torch, lambda: tiny.fill_(0), REPS)})
    rows_out = []
    for name, c in cases.items():
        setup = c.get("setup", lambda: None)
        kernel = name.split("[idle]")[0]
        setup()
        hold(kernel, c["kernel"](), c["plain"](), f"main-path shapes, {name}")
        if name == "bcsr_rev_search":
            hold(name, c["kernel"](), kref.rev_search_ref(push, g.rev, a),
                 "main-path rev table")
        ms = device_ms(torch, c["kernel"], REPS, setup=setup)
        plain_ms = device_ms(torch, c["plain"], REPS)
        lib_ms = (device_ms(torch, c["library"], REPS)
                  if c["library"] else None)
        bound_ms = 1e3 * c["bytes"] / HBM_BYTES_PER_S
        emit({"phase": "kernel_timing", "name": name, "shape": c["shape"],
              "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
              "bound_ms": bound_ms, "bytes": c["bytes"],
              "bound_share": bound_ms / ms})
        if name not in KERNELS:
            continue
        rows_out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{c['source']}.cu",
            "replaces": REPLACES[c["source"]],
            "launches": paths["fused" if name == "fused_discharge_batched"
                              else "main"][name],
            "on_path": name not in KEY_IN,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms})

    # the solver's hook before and after the fusion, at this state: the
    # key built by two eager ops and read by the key-in kernel, against the
    # gather entry (the sweep's pseudo-height ``dist`` in the dense form)
    for form, q_h, h_h in (("avq", avq, state.h), ("dense", None, dist)):
        def unfused(q_h=q_h, h_h=h_h):
            key_h = torch.where(state.res > 0, h_h[g.heads], inf)
            return tile_min_neighbor(q_h, g.indptr, key_h, n=n)

        def gather(q_h=q_h, h_h=h_h):
            return tile_min_neighbor_gather(q_h, g.indptr, g.heads,
                                            state.res, h_h, n=n)

        hold(f"tile_min_neighbor_gather[{form}]", gather(), unfused(),
             "main-path shapes, against the unfused hook")
        unfused_ms = device_ms(torch, unfused, REPS)
        gather_ms = device_ms(torch, gather, REPS)
        emit({"phase": "hook_timing", "form": form, "unfused_ms": unfused_ms,
              "gather_ms": gather_ms, "unfused_over_gather":
              unfused_ms / gather_ms})

    # -- 7. where a step's time goes: host enqueue, wall, device ---------
    # every run of a loop starts from the mid-solve state; vc_fused's step
    # updates its carry in place, so each of its runs takes a copy of its
    # own, made ahead of the timed window
    loops = {}
    for mode in ("vc_kernel_bsearch", "vc_fused", "vc"):
        body, cond = pr.cycle_loop(g, meta, s, t, mode, cap=2**30)
        if mode == "vc_fused":
            pool = iter([(pr.PRState(*(x.clone() for x in state)), zero)
                         for _ in range(13 + REPS)])
            loops[f"cycle[{mode}]"] = (body, cond, pool.__next__, True)
        else:
            loops[f"cycle[{mode}]"] = (body, cond, lambda: (state, zero),
                                       False)
    for name, fn in (("sweep[kernel]", minh_fn), ("sweep[plain]", None)):
        sweep, dist0 = globalrelabel.distance_sweep(g, meta, state.res, t, fn)
        step, cond, carry = engine.fixpoint_loop(sweep, dist0, cap=2**30)
        loops[name] = (step, cond, lambda carry=carry: carry, False)
    chunk = engine.DEFAULT_CHUNK
    timed = []
    for name, (step, cond, carry, gated) in loops.items():
        def run(step=step, cond=cond, carry=carry, gated=gated):
            return engine.run_chunk(step, carry(), cond_fn=cond, chunk=chunk,
                                    pass_gate=gated)

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            run()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / (10 * chunk)
        dev_step = device_ms(torch, run, REPS, 100_000_000) / chunk
        # a vc_fused step is one launch of K cycles; the rest one cycle
        per = K_DEFAULT if name == "cycle[vc_fused]" else 1
        timed.append((run, {
            "phase": "step_timing", "loop": name, "cycles_per_step": per,
            "host_ms_per_step": 1e3 * (t1 - t0) / (10 * chunk),
            "wall_ms_per_step": wall, "device_ms_per_step": dev_step,
            "host_ms_per_cycle": 1e3 * (t1 - t0) / (10 * chunk * per),
            "wall_ms_per_cycle": wall / per,
            "device_ms_per_cycle": dev_step / per,
            "device_idle_share": max(0.0, 1 - dev_step / wall)}))
    # a whole global relabel from this state, as the solve runs it (one
    # host read per chunk of sweeps): its wall time per sweep
    for name, fn in (("kernel", minh_fn), ("plain", None)):
        globalrelabel.global_relabel_impl(g, meta, state, s, t, fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweeps = int(globalrelabel.global_relabel_impl(g, meta, state, s, t,
                                                       fn)[2])
        wall = time.perf_counter() - t0
        emit({"phase": "relabel_timing", "minh": name, "sweeps": sweeps,
              "wall_s": wall, "wall_ms_per_sweep": 1e3 * wall / sweeps})
    # the profiler last, so that no host timing follows a profiled window
    for run, row in timed:
        emit({**row, "top_device_us_per_step": top_device_ops(torch, run,
                                                              chunk)})

    emit({"phase": "done", "quick": args.quick,
          "seconds": time.perf_counter() - t_start})
    if args.quick:
        return 0
    print(smi, flush=True)
    emit({"kernels": rows_out})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
