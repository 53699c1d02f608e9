#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py            # the full run: washington_rlg(1024, 1024)
    python3 chip_smoke.py --quick    # a rehearsal at 128 x 128; no result

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc``, holds each kernel bit for bit against its plain PyTorch version
on the card (sentinel edge cases, batched rows, and the main path's own
shapes), drives the main path — ``Solver(mode="vc_kernel_bsearch",
layout="bcsr").solve(...)`` on a DIMACS Washington random-level graph of
about a million vertices — checks its value against scipy's Dinic and its
final state against the plain ``vc`` mode, checks that one engine chunk
of cycles and of global-relabel sweeps never synchronises with the host,
and times every kernel beside its plain version, a PyTorch yardstick call
and its memory bound.

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
}
SEED = 7
#: CUDA-event timings per median
REPS = 25
#: (rows, cols) of the main path's washington_rlg graph, and of the
#: smaller one that ``vc_kernel`` solves: the full run and ``--quick``
SIZES = {False: ((1024, 1024), (256, 256)), True: ((128, 128), (64, 64))}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def device_ms(torch, fn, reps: int, sleep_cycles: int = 5_000_000) -> float:
    """Median device time of ``fn`` over ``reps`` single calls, by CUDA
    events.  A ``torch.cuda._sleep`` of ``sleep_cycles`` ahead of each call
    keeps the card busy while the host enqueues the call, so the events
    bracket device work only, not host launch gaps."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
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


def main_path_and_modes(small, torch, problem, oracle):
    """Phases 4 and 5: the main path's solve, the kernel modes against
    the plain ``vc`` path, and last the main path's value against the
    scipy ``oracle`` (an ``AsyncResult``, computed meanwhile).  Returns
    the main path's kernel launch counts."""
    from repro_torch.api import MaxflowProblem, Solver, SolverOptions
    from repro_torch.graphs.generators import washington_rlg
    from repro_torch.kernels.revsearch import bcsr_rev_search
    from repro_torch.kernels.segmin import tile_min_neighbor

    def solve(mode, prob):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = Solver(SolverOptions(mode=mode, layout="bcsr")).solve(prob)
        torch.cuda.synchronize()
        return sol, time.perf_counter() - t0

    tile_min_neighbor.launches = tile_min_neighbor.dense_launches = 0
    bcsr_rev_search.launches = 0
    main, wall = solve("vc_kernel_bsearch", problem)
    launches = {
        "tile_min_neighbor[avq]": (tile_min_neighbor.launches
                                   - tile_min_neighbor.dense_launches),
        "tile_min_neighbor[dense]": tile_min_neighbor.dense_launches,
        "bcsr_rev_search": bcsr_rev_search.launches,
    }
    st = main.stats
    emit({"phase": "main_path", "mode": "vc_kernel_bsearch", "wall_s": wall,
          "value": main.value, "cycles": st.cycles, "rounds": st.rounds,
          "global_relabels": st.global_relabels, "gr_sweeps": st.gr_sweeps,
          "launches": launches,
          "ms_per_cycle_plus_sweep": 1e3 * wall / (st.cycles + st.gr_sweeps)})
    for name, count in launches.items():
        require(count > 0, f"{name} never launched on the main path")

    # -- 5. kernel modes against the plain torch path -----------------------
    def same(sol_a, sol_b, what):
        for f in ("cycles", "rounds", "global_relabels", "gr_sweeps"):
            require(getattr(sol_a.stats, f) == getattr(sol_b.stats, f),
                    f"{what}: {f} {getattr(sol_a.stats, f)} != "
                    f"{getattr(sol_b.stats, f)}")
        require(sol_a.value == sol_b.value, f"{what}: value differs")
        for f in ("res", "h", "e"):
            require(torch.equal(getattr(sol_a.state, f),
                                getattr(sol_b.state, f)),
                    f"{what}: final {f} differs")

    plain, wall_vc = solve("vc", problem)
    same(main, plain, "vc_kernel_bsearch vs vc")
    g_s, s_s, t_s = washington_rlg(*small, seed=SEED)
    p_small = MaxflowProblem(g_s, s_s, t_s)
    p_small.residual("bcsr")
    k_small, wall_k = solve("vc_kernel", p_small)
    v_small, wall_v = solve("vc", p_small)
    same(k_small, v_small, "vc_kernel vs vc")
    emit({"phase": "modes_vs_plain", "ok": True, "vc_wall_s": wall_vc,
          "small_graph": f"washington_rlg({small[0]}, {small[1]}, "
          f"seed={SEED})",
          "small_value": k_small.value, "small_cycles": k_small.stats.cycles,
          "small_vc_kernel_wall_s": wall_k, "small_vc_wall_s": wall_v})

    want, t_scipy = oracle.get()
    emit({"phase": "oracle", "scipy_dinic_s": t_scipy, "scipy_value": want})
    require(main.value == want,
            f"vc_kernel_bsearch value {main.value} != scipy Dinic {want}")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="rehearse on small graphs; prints no result")
    args = ap.parse_args(argv)
    (rows, cols), small = SIZES[args.quick]

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
             for line in log.splitlines() if "registers" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: build.library_path(n).name
                        for n in build.SIGNATURES}, "ptxas": ptxas})

    import numpy as np

    from repro_torch.api import MaxflowProblem
    from repro_torch.core import engine, globalrelabel
    from repro_torch.core import pushrelabel as pr
    from repro_torch.core.csr import Graph, build_residual
    from repro_torch.graphs.generators import random_sparse, washington_rlg
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.revsearch import bcsr_rev_search, search_steps
    from repro_torch.kernels.segmin import (tile_min_neighbor,
                                            tile_min_neighbor_plain)

    dev = torch.device("cuda")
    inf = kref.INF
    errs = {"tile_min_neighbor[avq]": 0, "tile_min_neighbor[dense]": 0,
            "bcsr_rev_search": 0}

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
    # scipy's Dinic takes minutes at this size: it runs in a process of
    # its own while the card solves; leaving the block terminates it
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        oracle = pool.apply_async(scipy_maxflow, (graph.n, graph.edges,
                                                  graph.cap, s, t))
        launches = main_path_and_modes(small, torch, problem, oracle)

    # -- 6. no host sync inside an engine chunk -----------------------------
    g, meta, res0 = pr.to_device(r)
    state = pr.preflow(g, meta, res0, s)
    minh_fn = kops.min_neighbor_minh_fn()
    sweep, dist0 = globalrelabel.distance_sweep(g, meta, state.res, t,
                                                minh_fn)
    fp_step, fp_cond, fp_carry = engine.fixpoint_loop(sweep, dist0, cap=r.n)
    body, cond = pr.cycle_loop(g, meta, s, t, "vc_kernel_bsearch", cap=1024)
    cyc_carry = (state, torch.zeros((), dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fp_carry = engine.run_chunk(fp_step, fp_carry, cond_fn=fp_cond,
                                    chunk=engine.DEFAULT_CHUNK)
        cyc_carry = engine.run_chunk(body, cyc_carry, cond_fn=cond,
                                     chunk=engine.DEFAULT_CHUNK)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    require(int(fp_carry[2]) == engine.DEFAULT_CHUNK
            and int(cyc_carry[1]) == engine.DEFAULT_CHUNK,
            "the sync-free chunks did not run their steps")
    emit({"phase": "no_host_sync", "ok": True,
          "chunk": engine.DEFAULT_CHUNK})

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
    rows_out = []
    for name, c in cases.items():
        hold(name, c["kernel"](), c["plain"](), "main-path shapes")
        if name == "bcsr_rev_search":
            hold(name, c["kernel"](), kref.rev_search_ref(push, g.rev, a),
                 "main-path rev table")
        ms = device_ms(torch, c["kernel"], REPS)
        plain_ms = device_ms(torch, c["plain"], REPS)
        lib_ms = (device_ms(torch, c["library"], REPS)
                  if c["library"] else None)
        bound_ms = 1e3 * c["bytes"] / HBM_BYTES_PER_S
        emit({"phase": "kernel_timing", "name": name, "shape": c["shape"],
              "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
              "bound_ms": bound_ms, "bytes": c["bytes"]})
        rows_out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{c['source']}.cu",
            "replaces": REPLACES[c["source"]], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms})

    # -- 7. where a step's time goes: host enqueue, wall, device ---------
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    loops = {}
    for mode in ("vc_kernel_bsearch", "vc"):
        body, cond = pr.cycle_loop(g, meta, s, t, mode, cap=2**30)
        loops[f"cycle[{mode}]"] = (body, cond, (state, zero))
    for name, fn in (("sweep[kernel]", minh_fn), ("sweep[plain]", None)):
        sweep, dist0 = globalrelabel.distance_sweep(g, meta, state.res, t, fn)
        loops[name] = engine.fixpoint_loop(sweep, dist0, cap=2**30)
    chunk = engine.DEFAULT_CHUNK
    for name, (step, cond, carry) in loops.items():
        def run(step=step, cond=cond, carry=carry):
            return engine.run_chunk(step, carry, cond_fn=cond, chunk=chunk)

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            run()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / (10 * chunk)
        dev_step = device_ms(torch, run, REPS, 100_000_000) / chunk
        emit({"phase": "step_timing", "loop": name,
              "host_ms_per_step": 1e3 * (t1 - t0) / (10 * chunk),
              "wall_ms_per_step": wall, "device_ms_per_step": dev_step,
              "device_idle_share": max(0.0, 1 - dev_step / wall),
              "top_device_us_per_step": top_device_ops(torch, run, chunk)})

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
