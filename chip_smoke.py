#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py            # the full run: washington_rlg(1024, 1024)
    python3 chip_smoke.py --quick    # a rehearsal at 128 x 128; no result

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc``, holds each kernel bit for bit against its plain PyTorch version
on the card (sentinel edge cases, batched rows, and the main path's own
shapes), and drives these paths, each with the launch counts set to 0
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
  scipy's Dinic, and a telemetry solve against its own counters;
  ``solve_many`` corrects its batch to flows (phase 2), so the kernel
  modes launch both forms of the min search's gather entry;
* ``tc_path`` — ``Solver(mode="tc")`` on ``washington_rlg(256, 256)``
  against plain ``vc`` bit for bit, and batched on the 8 instances
  against batched ``vc`` and Dinic, launching no kernel (the
  thread-centric scan is plain PyTorch; at 1024 x 1024 it would gather
  about 1G lanes a cycle);
* ``phase2_path`` — the main path's solution corrected by its handle
  (phase 2 on the gather entry's dense and AVQ forms), bit-equal to the
  plain phase 2 on the card, its flows conserved, its min cut of the max
  flow's value (the source side by distance sweeps from ``s``);
* ``batched_phase2`` — every batched handle corrected and valid, and
  the ``vc_kernel_bsearch`` rows' flows equal to ``vc``'s;
* ``matching_path`` — ``MatchingProblem(bipartite_random(131072,
  131072, avg_deg=8.0))`` in ``vc_kernel_bsearch``, its matched pairs
  against scipy's Hopcroft-Karp;
* ``warm_path`` — on the small graph: 64 capacity increases of +50 (on
  arcs of the min cut, chosen by a seeded generator) re-solved warm
  against a cold solve and Dinic, a decrease within an arc's slack
  answered with no solve, and a decrease below the routed flow refused.

The fused discharge is also held against its plain version at the
batched path's own shapes (after the first global relabel and mid-solve)
and on more rows than the card holds resident blocks, through both its
entries: the in-place one the drivers run, with its gate open and closed,
and the out-of-place one.  It checks that one engine chunk of cycles
(``vc_kernel_bsearch``, ``vc_fused`` and ``tc``, single and batched), of
global-relabel sweeps and of phase 2's cancellations never synchronises
with the host, and times every kernel beside its plain version, a
PyTorch yardstick call
where one exists and its memory bound, the min search's hook with its key
built by eager ops against the entry that gathers the key itself, and the
paper-faithful cycle's search as two launches against the one that folds
the reverse search in (``hook_timing``), and each step's host, wall and
device time.  The min search has three entries into one CUDA source,
``tile_min_neighbor`` (key in, the TPU kernel's function, which no path
launches: it is timed against ``scatter_reduce`` and is the gather
entry's oracle), ``tile_min_neighbor_gather`` (the solver's: ``vc_kernel``
cycles and every kernel sweep) and ``tile_min_neighbor_gather_rev`` (the
``vc_kernel_bsearch`` cycle's, with each push's reverse arc).  The
standalone ``bcsr_rev_search`` is the TPU kernel's own function, which no
path launches either: it is held and timed against ``searchsorted`` as
the yardstick of the fold.  Each path must leave those two kernels'
counts at 0.

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
#: that gathers its key itself, its rev entry, the standalone reverse
#: search, the discharge
KERNELS = ("tile_min_neighbor[avq]", "tile_min_neighbor[dense]",
           "tile_min_neighbor_gather[avq]", "tile_min_neighbor_gather[dense]",
           "tile_min_neighbor_gather_rev", "bcsr_rev_search",
           "fused_discharge_batched")
#: the kernels each kernel-mode path must launch
MAIN_KERNELS = ("tile_min_neighbor_gather_rev",
                "tile_min_neighbor_gather[dense]")
VC_KERNEL_KERNELS = ("tile_min_neighbor_gather[avq]",
                     "tile_min_neighbor_gather[dense]")
FUSED_KERNELS = ("fused_discharge_batched", "tile_min_neighbor_gather[dense]")
#: the TPU kernels' own functions, which no path may launch: the key-in
#: min search (the solver's hook builds no key array) and the standalone
#: reverse search (the bsearch cycle folds it into the min search)
OFF_PATH = ("tile_min_neighbor[avq]", "tile_min_neighbor[dense]",
            "bcsr_rev_search")
#: left and right vertices of the matching path's bipartite graph: the
#: full run and ``--quick``
MATCHING_SIDE = {False: 131072, True: 2048}
#: the warm path's capacity increases: arcs raised, and by how much
WARM_ARCS = 64
WARM_DELTA = 50
#: the path whose launches each kernel's row reports (the rest: "main")
ROW_PATH = {"tile_min_neighbor_gather[avq]": "vc_kernel",
            "fused_discharge_batched": "fused"}


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


def search_reads(torch, arcs, indptr, heads, tails, steps: int):
    """The positions in ``heads`` that the reverse searches of the push
    arcs ``arcs`` (all in ``[0, A)``) read, each search's ``steps`` probes
    and its final check, with repeats; and the vertices ``v`` whose
    segments they search."""
    a = heads.shape[0]
    u, v = tails[arcs], heads[arcs]
    lo, end = indptr[v], indptr[v + 1]
    hi, probes = end, []
    for _ in range(steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        probes.append(torch.clamp(mid, max=a - 1))
        right = heads[probes[-1]] < u
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(right, hi, mid)
    # the final check reads heads[lo] only where lo < end; else it repeats
    # the last probe
    probes.append(torch.where(lo < end, torch.clamp(lo, max=a - 1),
                              probes[-1]))
    return torch.cat(probes), v


def distinct(torch, size: int, *index) -> int:
    """How many distinct positions of an array of ``size`` the index
    tensors name together: the words a function reads once."""
    seen = torch.zeros(size, dtype=torch.bool, device=index[0].device)
    for i in index:
        seen[i.long()] = True
    return int(seen.sum())


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
                                            tile_min_neighbor_gather,
                                            tile_min_neighbor_gather_rev)

    for fn in (tile_min_neighbor, tile_min_neighbor_gather):
        fn.launches = fn.dense_launches = 0
    for fn in (tile_min_neighbor_gather_rev, bcsr_rev_search,
               fused_discharge_batched):
        fn.launches = 0


def launch_counts() -> dict:
    """The kernels' launch counters, by the names of ``KERNELS``."""
    from repro_torch.kernels.discharge import fused_discharge_batched
    from repro_torch.kernels.revsearch import bcsr_rev_search
    from repro_torch.kernels.segmin import (tile_min_neighbor,
                                            tile_min_neighbor_gather,
                                            tile_min_neighbor_gather_rev)

    seg, gat = tile_min_neighbor, tile_min_neighbor_gather
    return dict(zip(KERNELS, (
        seg.launches - seg.dense_launches, seg.dense_launches,
        gat.launches - gat.dense_launches, gat.dense_launches,
        tile_min_neighbor_gather_rev.launches, bcsr_rev_search.launches,
        fused_discharge_batched.launches)))


def driven(torch, fn, expect=()):
    """Run one path, ``fn()``, with the launch counts set to 0 just before
    it and read just after; fail if a kernel of ``expect`` never launched
    or one of ``OFF_PATH`` launched at all.  Returns ``(result, wall
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
    for name in OFF_PATH:
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
    k_small, wall_k, paths["vc_kernel"] = solve("vc_kernel", p_small,
                                                VC_KERNEL_KERNELS)
    v_small, wall_v, _ = solve("vc", p_small)
    same_solution(torch, k_small, v_small, "vc_kernel vs vc")
    emit({"phase": "modes_vs_plain", "ok": True, "vc_wall_s": wall_vc,
          "small_graph": f"washington_rlg({small[0]}, {small[1]}, "
          f"seed={SEED})",
          "small_value": k_small.value, "small_cycles": k_small.stats.cycles,
          "small_vc_kernel_wall_s": wall_k, "small_vc_wall_s": wall_v,
          "small_vc_kernel_launches": paths["vc_kernel"]})

    fused, wall_f, paths["fused"] = solve("vc_fused", problem,
                                          FUSED_KERNELS)
    same_solution(torch, fused, plain, "vc_fused vs vc")
    emit({"phase": "fused_path", "mode": "vc_fused", "wall_s": wall_f,
          "value": fused.value, "cycles": fused.stats.cycles,
          "rounds": fused.stats.rounds, "gr_sweeps": fused.stats.gr_sweeps,
          "launches": paths["fused"], "same_as_vc": True})

    # -- 5b. the batched path -----------------------------------------------
    sols = {}
    # solve_many corrects its batch: the kernel modes' phase 2 launches
    # the AVQ gather entry (cancellation) besides the dense one (heights)
    expect = {"vc_fused": FUSED_KERNELS + ("tile_min_neighbor_gather[avq]",),
              "vc_kernel_bsearch": MAIN_KERNELS
              + ("tile_min_neighbor_gather[avq]",), "vc": ()}
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

    # the main graph's oracle is read last (main_oracle), once the later
    # phases have run beside it
    got = [o.get() for o in oracles[1:]]
    emit({"phase": "batched_oracle", "scipy_values": [v for v, _ in got],
          "scipy_dinic_s": [x for _, x in got]})
    for mode in BATCH_MODES:
        require([x.value for x in sols[mode]] == [v for v, _ in got],
                f"batched {mode} values != scipy Dinic")
    return paths, {"main": main, "p_small": p_small, "v_small": v_small,
                   "sols": sols, "batch_values": [v for v, _ in got]}


def main_oracle(ctx, oracle):
    """The main path's value, and so its min cut's, against scipy's Dinic
    on the main graph."""
    want, t_scipy = oracle.get()
    emit({"phase": "oracle", "scipy_dinic_s": t_scipy, "scipy_value": want})
    main = ctx["main"]
    require(main.value == want,
            f"vc_kernel_bsearch value {main.value} != scipy Dinic {want}")


def flow_divergence(r, flows):
    """Per-vertex net inflow of per-pair ``flows`` (int64): ``-value`` at
    ``s``, ``value`` at ``t`` and 0 elsewhere for a conserved flow."""
    import numpy as np

    div = np.zeros(r.n, np.int64)
    f = flows.astype(np.int64)
    np.add.at(div, r.pair_u, -f)
    np.add.at(div, r.heads[r.pair_arc], f)
    return div


def tc_path(torch, ctx, batch):
    """Phase ``tc_path``: the thread-centric baseline on the small graph
    and on the batched path's instances, no kernel, against plain ``vc``
    and scipy's Dinic."""
    from repro_torch.api import Solver

    tc, wall, launches = driven(torch, lambda: Solver(mode="tc").solve(
        ctx["p_small"]))
    require(not any(launches.values()), "tc launched a kernel")
    same_solution(torch, tc, ctx["v_small"], "tc vs vc")
    tcb, wall_b, launches_b = driven(torch, lambda: Solver(
        backend="batched", mode="tc").solve_many(batch))
    require(not any(launches_b.values()), "batched tc launched a kernel")
    for i, (a, b) in enumerate(zip(tcb, ctx["sols"]["vc"])):
        same_solution(torch, a, b, f"batched tc vs vc [{i}]")
    require([x.value for x in tcb] == ctx["batch_values"],
            "batched tc values != scipy Dinic")
    cyc_b = [x.stats.cycles for x in tcb]
    emit({"phase": "tc_path", "value": tc.value, "cycles": tc.stats.cycles,
          "wall_s": wall, "ms_per_cycle": 1e3 * wall / tc.stats.cycles,
          "same_as_vc": True, "batched_wall_s": wall_b,
          "batched_cycles": cyc_b,
          "batched_ms_per_cycle": 1e3 * wall_b / max(cyc_b),
          "batched_values": [x.value for x in tcb]})
    return {"tc": launches, "batched[tc]": launches_b}


def phase2_path(torch, problem, ctx):
    """Phase ``phase2_path``: the main path's own solution corrected to a
    flow by its handle (phase 2 on the min search's gather entry), held
    against the plain phase 2 on the card, then its flows and min cut
    (whose value equals the solve's, which ``main_oracle`` holds against
    scipy's Dinic)."""
    import numpy as np

    from repro_torch.core import pushrelabel as pr

    main = ctx["main"]
    r, s, t = problem.residual("bcsr"), problem.s, problem.t
    e0 = main.state.e.cpu().numpy().copy()
    e0[[s, t]] = 0
    handle = main.warm_start
    require(not handle.corrected and handle.device == main.state.res.device,
            "the main path's handle is not lazy on the solve's device")
    (res, e), wall, launches = driven(torch, handle.arrays,
                                      VC_KERNEL_KERNELS)
    plain, wall_plain, launches_plain = driven(
        torch, lambda: pr.convert_preflow_to_flow(r, main.state, s, t))
    require(not any(launches_plain.values()),
            "the plain phase 2 launched a kernel")
    require(np.array_equal(res, plain),
            "phase 2 on the kernel != the plain phase 2 on the card")
    handle.validate()
    e_t = e.copy()
    e_t[t] = 0
    require(int(e[t]) == main.value and not e_t.any(),
            "the corrected excess is not 0 off the sink")
    flows, wall_flows, _ = driven(torch, main.flows)
    div = flow_divergence(r, flows)
    inner = np.ones(r.n, bool)
    inner[[s, t]] = False
    require(div[s] == -main.value and div[t] == main.value
            and not div[inner].any(), "main.flows() is not conserved")
    cut, wall_cut, launches_cut = driven(
        torch, main.min_cut, ("tile_min_neighbor_gather[dense]",))
    require(cut.value == main.value, f"min cut {cut.value} != max flow "
            f"{main.value}")
    require(bool(cut.source_side[s]) and not cut.source_side[t],
            "the cut does not separate s from t")
    require(bool((res[cut.cut_arcs] == 0).all()), "a cut arc has residual")
    emit({"phase": "phase2_path", "mode": main.stats.mode,
          "stranded_units": int(e0.sum()),
          "stranded_vertices": int((e0 > 0).sum()),
          "arrays_wall_s": wall, "arrays_launches": launches,
          "plain_wall_s": wall_plain, "same_as_plain": True,
          "flows_wall_s": wall_flows, "min_cut_wall_s": wall_cut,
          "min_cut_sweeps": launches_cut["tile_min_neighbor_gather[dense]"],
          "min_cut_value": cut.value, "cut_arcs": int(cut.cut_arcs.size),
          "source_side": int(cut.source_side.sum())})
    return {"phase2": launches, "min_cut": launches_cut}


def batched_phase2(torch, ctx):
    """Phase ``batched_phase2``: ``solve_many`` handed back corrected,
    valid handles, and the kernel-mode rows' flows equal plain ``vc``'s."""
    import numpy as np

    sols = ctx["sols"]

    def check():
        for mode in BATCH_MODES:
            for sol in sols[mode]:
                require(sol.warm_start.corrected, f"batched {mode} handle "
                        "is not corrected")
                sol.warm_start.validate()
        for i, (a, b) in enumerate(zip(sols["vc_kernel_bsearch"],
                                       sols["vc"])):
            require(np.array_equal(a.flows(), b.flows()),
                    f"batched vc_kernel_bsearch flows != vc [{i}]")

    _, wall, launches = driven(torch, check)
    emit({"phase": "batched_phase2", "ok": True, "rows": len(sols["vc"]),
          "check_wall_s": wall, "launches": launches})


def scipy_matching(bp):
    """The size of a maximum matching of ``bp``'s left-right edges by
    scipy's Hopcroft-Karp, and its seconds."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_bipartite_matching

    t0 = time.perf_counter()
    lr = bp.lr_edges
    m = csr_matrix((np.ones(len(lr), np.int32),
                    (lr[:, 0], lr[:, 1] - bp.n_left)),
                   shape=(bp.n_left, bp.n_right))
    size = int((maximum_bipartite_matching(m, perm_type="column") >= 0).sum())
    return size, time.perf_counter() - t0


def matching_path(torch, quick):
    """Phase ``matching_path``: a bipartite matching through the
    paper-faithful mode, against scipy's Hopcroft-Karp."""
    import numpy as np

    from repro_torch.api import MatchingProblem, Solver
    from repro_torch.graphs.generators import bipartite_random

    side = MATCHING_SIDE[quick]
    t0 = time.perf_counter()
    bp = bipartite_random(side, side, avg_deg=8.0, seed=SEED)
    gen_s = time.perf_counter() - t0
    mp = MatchingProblem(bp)
    r = mp.residual("bcsr")
    sol, wall, launches = driven(torch, lambda: Solver(
        mode="vc_kernel_bsearch").solve(mp), MAIN_KERNELS)
    pairs, wall_pairs, launches_pairs = driven(torch, sol.matching)
    want, t_scipy = scipy_matching(bp)
    require(len(pairs) == sol.value == want, f"matching of {len(pairs)} "
            f"pairs, value {sol.value}, scipy {want}")
    require(np.unique(pairs[:, 0]).size == len(pairs)
            and np.unique(pairs[:, 1]).size == len(pairs),
            "a vertex is matched twice")
    code = bp.n_left + bp.n_right
    p64 = pairs.astype(np.int64)  # the codes overflow int32
    require(bool(np.isin(p64[:, 0] * code + p64[:, 1],
                         bp.lr_edges[:, 0] * code + bp.lr_edges[:, 1]).all()),
            "a matched pair is no edge")
    emit({"phase": "matching_path", "mode": "vc_kernel_bsearch",
          "graph": f"bipartite_random({side}, {side}, avg_deg=8.0, "
          f"seed={SEED})", "n": r.n, "arcs": r.num_arcs,
          "deg_max": r.deg_max, "lr_edges": len(bp.lr_edges),
          "gen_s": gen_s, "wall_s": wall, "cycles": sol.stats.cycles,
          "value": sol.value, "launches": launches,
          "matching_wall_s": wall_pairs, "matching_launches": launches_pairs,
          "scipy_value": want, "scipy_s": t_scipy,
          "over_60_s": wall > 60})
    return {"matching": launches}


def warm_path(torch, ctx):
    """Phase ``warm_path``: warm re-solves of the small graph's
    paper-faithful solution: capacity increases against a cold solve and
    scipy's Dinic, a slack-only decrease answered with no solve, and an
    overflowing decrease refused."""
    import numpy as np

    from repro_torch.api import CapacityUpdate, MaxflowProblem, Solver
    from repro_torch.obs import REGISTRY

    solver = Solver(mode="vc_kernel_bsearch")
    p = ctx["p_small"]
    cold, wall_cold, _ = driven(torch, lambda: solver.solve(p), MAIN_KERNELS)
    require(cold.value == ctx["v_small"].value, "cold value != vc")
    handle = cold.warm_start
    r = handle.residual
    # arcs of the min cut first, so that the increases can route more
    cut = cold.min_cut().cut_arcs
    rng = np.random.default_rng(SEED)
    picks = rng.choice(cut, size=min(WARM_ARCS, cut.size), replace=False)
    if picks.size < WARM_ARCS:
        rest = np.setdiff1d(np.nonzero(r.res0 > 0)[0], picks)
        picks = np.concatenate([picks, rng.choice(
            rest, size=WARM_ARCS - picks.size, replace=False)])
    ups = [CapacityUpdate(int(r.tails[a]), int(r.heads[a]), WARM_DELTA)
           for a in picks]
    warm, wall_warm, launches_warm = driven(
        torch, lambda: solver.resolve(handle, ups))
    r2 = warm.warm_start.residual
    again, wall_again, _ = driven(torch, lambda: solver.solve(
        MaxflowProblem.from_residual(r2, p.s, p.t)), MAIN_KERNELS)
    want, _ = scipy_maxflow(r2.n, np.stack([r2.tails, r2.heads], 1),
                            r2.res0, p.s, p.t)
    require(warm.value == again.value == want, f"warm {warm.value} != cold "
            f"{again.value} / scipy Dinic {want}")
    # a decrease within an arc's slack: the flow stays maximal, no solve
    res, _ = handle.arrays()
    slack = np.nonzero((r.res0 > 0) & (res > 0))[0]
    a = int(rng.choice(slack))
    d = int(min(res[a], r.res0[a]))
    noop = REGISTRY.counter("stream.noop_resolves")
    before = noop.value
    dec, wall_dec, launches_dec = driven(torch, lambda: solver.resolve(
        handle, [CapacityUpdate(int(r.tails[a]), int(r.heads[a]), -d)]))
    require(dec.value == cold.value and dec.stats.cycles == 0
            and noop.value == before + 1 and not any(launches_dec.values()),
            "the slack-only decrease was not answered without a solve")
    # a decrease below the routed flow needs the streaming tier's drain
    carrying = np.nonzero((r.res0 > 0) & (r.res0 - res > 0))[0]
    b = int(carrying[0])
    try:
        solver.resolve(handle, [CapacityUpdate(
            int(r.tails[b]), int(r.heads[b]), -int(r.res0[b]))])
        refused = False
    except NotImplementedError as exc:
        refused = "Streaming" in str(exc)
    require(refused, "an overflowing decrease was not refused naming the "
            "streaming item")
    emit({"phase": "warm_path", "mode": "vc_kernel_bsearch",
          "increases": len(ups), "delta": WARM_DELTA,
          "cut_arcs": int(cut.size), "cold_value": cold.value,
          "cold_cycles": cold.stats.cycles, "cold_wall_s": wall_cold,
          "warm_value": warm.value, "warm_cycles": warm.stats.cycles,
          "warm_wall_s": wall_warm, "warm_launches": launches_warm,
          "cold_updated_cycles": again.stats.cycles,
          "cold_updated_wall_s": wall_again, "scipy_value": want,
          "noop_decrease_wall_s": wall_dec, "overflow_refused": True})
    return {"warm": launches_warm}


def views_and_modes(quick, small, torch, problem, batch, ctx, paths):
    """The phases of phase 2, the views and ``tc``, each driven with the
    launch counts set to 0 just before it and read just after."""
    paths.update(tc_path(torch, ctx, batch))
    paths.update(phase2_path(torch, problem, ctx))
    batched_phase2(torch, ctx)
    paths.update(matching_path(torch, quick))
    paths.update(warm_path(torch, ctx))


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
    from repro_torch.core import batched, engine, globalrelabel, phase2
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
    from repro_torch.kernels.segmin import (
        tile_min_neighbor, tile_min_neighbor_gather,
        tile_min_neighbor_gather_plain, tile_min_neighbor_gather_rev,
        tile_min_neighbor_gather_rev_plain, tile_min_neighbor_plain)

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
    # the rev entry on the same rows, with random heights and queues of
    # distinct vertices: the rev table at each push on these well-formed
    # rows, and the standalone search on its push arcs
    n_b = indptr3.shape[1] - 1
    res3 = torch.tensor(rng.integers(-1, 3, size=(3, a_r)),
                        dtype=torch.int32, device=dev)
    h3 = torch.tensor(rng.integers(0, 9, size=(3, n_b)), dtype=torch.int32,
                      device=dev)
    avq3 = torch.tensor(np.stack([np.concatenate([
        rng.choice(n_b, 900, replace=False), np.full(n_b - 900, n_b)])
        for _ in range(3)]), dtype=torch.int32, device=dev)
    for sl, what in ((0, "1-D"), (slice(None), "B=3")):
        rargs = (avq3[sl], indptr3[sl], heads3[sl], tails3[sl], res3[sl],
                 h3[sl])
        got = tile_min_neighbor_gather_rev(*rargs, n=n_b, deg_max=deg_max)
        hold("tile_min_neighbor_gather_rev", got,
             tile_min_neighbor_gather_rev_plain(*rargs, n=n_b, steps=steps),
             what)
        push = torch.where(got[2] < a_r, got[1], a_r)
        require(bool((push < a_r).any()), "the rev entry found no push")
        pairs = zip(push.view(-1, push.shape[-1]), rev3[sl].view(-1, a_r))
        hold("tile_min_neighbor_gather_rev", got[2], torch.stack([
            kref.rev_search_ref(p_, r_, a_r) for p_, r_ in pairs]).view(
                push.shape), f"{what}, rev table")
        hold("bcsr_rev_search",
             bcsr_rev_search(push, *rargs[1:4], deg_max=deg_max), got[2],
             f"{what}, the rev entry's push arcs")
    # a hub of 3000 arcs (12 halvings, probes far apart) and a vertex of 60
    # (vertex 2, wider than a warp), with runs of duplicate heads in both
    # and the arc of 2 back to 3100 moved away (its reverse is absent); each
    # queue starts with 2's other 59 spokes, so that a warp's searches share
    # one segment; the standalone search on its push arcs
    # among random arcs and sentinels, in rows of P lanes with P a multiple
    # of the block and not, and a row off any alignment
    n_c = 3200
    g_c = Graph(n_c, np.concatenate([
        rng.integers(3, 3100, size=(3000, 2)),
        np.stack([np.ones(3000, np.int64), np.arange(100, 3100)], 1),
        np.stack([np.full(60, 2), np.arange(3100, 3160)], 1)]),
        np.ones(6060, np.int64))
    r_c = build_residual(g_c, "bcsr")
    heads_c = r_c.heads.copy()
    for v, at in ((1, 500), (1, 2500), (2, 20)):
        heads_c[r_c.indptr[v] + at:r_c.indptr[v] + at + 6] = \
            heads_c[r_c.indptr[v] + at]
    heads_c[r_c.indptr[2]] = n_c - 1
    a_c = r_c.num_arcs
    res_c = rng.integers(-1, 3, size=(3, a_c))
    res_c[:, np.isin(heads_c, (1, 2))] = 1
    h_c = rng.integers(1, 12, size=(3, n_c))
    h_c[:, [1, 2]] = 0
    avq_c = np.full((3, n_c), n_c)
    for b in range(3):
        rest = np.unique(np.concatenate([
            [1, 2, 3100], rng.choice(np.arange(100, 3100), 400,
                                     replace=False),
            rng.choice(np.arange(3, 100), 50)]))
        avq_c[b, :59] = np.arange(3101, 3160)
        avq_c[b, 59:59 + rest.size] = rng.permutation(rest)
    cargs = [torch.tensor(np.stack([x] * 3) if x.ndim == 1 else x,
                          dtype=torch.int32, device=dev)
             for x in (avq_c, r_c.indptr, heads_c, r_c.tails, res_c, h_c)]
    steps_c = search_steps(r_c.deg_max)
    for sl, what in ((0, "1-D"), (slice(None), "B=3")):
        rargs = [x[sl] for x in cargs]
        got = tile_min_neighbor_gather_rev(*rargs, n=n_c,
                                           deg_max=r_c.deg_max)
        hold("tile_min_neighbor_gather_rev", got,
             tile_min_neighbor_gather_rev_plain(*rargs, n=n_c, steps=steps_c),
             f"{what}, hub, duplicates, missing reverse")
        at = (rargs[0] == 3100).nonzero()
        require(bool((got[2][tuple(at.t())] == a_c).all()),
                "the push with no reverse arc did not give A")
    push_c = torch.where(got[2] < a_c, got[1], a_c)
    for p_c in (4096, 4099):
        arcs_c = torch.tensor(rng.integers(-3, a_c + 3, size=(3, p_c)),
                              dtype=torch.int32, device=dev)
        arcs_c[:, :n_c // 2] = push_c[:, :n_c // 2]
        for sl, what in ((0, "1-D"), (1, "1-D, row 1"),
                         (slice(None), "B=3")):
            sargs = (arcs_c[sl], *(x[sl] for x in cargs[1:4]))
            hold("bcsr_rev_search",
                 bcsr_rev_search(*sargs, deg_max=r_c.deg_max),
                 kref.rev_search_bsearch_ref(*sargs, steps=steps_c),
                 f"{what}, P={p_c}, hub, duplicates, missing reverse")

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
        paths, ctx = main_path_and_modes(small, torch, problem, batch,
                                         oracles)
        views_and_modes(args.quick, small, torch, problem, batch, ctx, paths)
        main_oracle(ctx, oracles[0])
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
    rargs = (bavq, bbg.indptr, bbg.heads, bbg.tails, bstate.res, bstate.h)
    got = tile_min_neighbor_gather_rev(*rargs, n=bmeta.n,
                                       deg_max=bmeta.deg_max)
    hold("tile_min_neighbor_gather_rev", got,
         tile_min_neighbor_gather_rev_plain(
             *rargs, n=bmeta.n, steps=search_steps(bmeta.deg_max)),
         "batched path, post-relabel")
    a_b = bbg.heads.shape[1]
    hold("tile_min_neighbor_gather_rev", got[2], torch.stack([
        kref.rev_search_ref(torch.where(r_ < a_b, g_, a_b), v_, a_b)
        for g_, r_, v_ in zip(got[1], got[2], bbg.rev)]),
        "batched path, post-relabel, rev table")
    b_bs = batched.batched_cycle_loop(bbg, bmeta, bstate,
                                      "vc_kernel_bsearch", 1024)
    chunk = engine.DEFAULT_CHUNK
    # phase 2's cancellation steps on the kernel, from the preflow (its
    # excess sits on the source's neighbours), under fixed flow heights;
    # and the tc cycle, single and batched
    height = phase2.flow_heights_impl(g, meta, res0, state.res, s,
                                      minh_fn)[0]

    def cancel(c):
        st = phase2._cancel_step(g, meta, res0, pr.PRState(c[0], height,
                                                           c[1]), s, t,
                                 minh_fn)
        return st.res, st.e, torch.any(st.e != c[1])

    c_carry = (state.res, state.e, torch.ones((), dtype=torch.bool,
                                              device=dev))
    tc_body, tc_cond = pr.cycle_loop(g, meta, s, t, "tc", cap=1024)
    b_tc = batched.batched_cycle_loop(bbg, bmeta, bstate, "tc", 1024)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fp_carry = engine.run_chunk(fp_step, fp_carry, cond_fn=fp_cond,
                                    chunk=chunk)
        c_carry = engine.run_chunk(cancel, c_carry, cond_fn=lambda c: c[2],
                                   chunk=chunk)
        tc_carry = engine.run_chunk(tc_body, (state, zero), cond_fn=tc_cond,
                                    chunk=chunk)
        btc_carry = engine.run_chunk(b_tc[0], b_tc[2], cond_fn=b_tc[1],
                                     chunk=chunk)
        for mode, (body, cond) in loops.items():
            carries[mode] = engine.run_chunk(body, carries[mode],
                                             cond_fn=cond, chunk=chunk,
                                             pass_gate=mode == "vc_fused")
        b_carry = engine.run_chunk(b_step, b_carry, cond_fn=b_cond,
                                   chunk=chunk, pass_gate=True)
        bs_carry = engine.run_chunk(b_bs[0], b_bs[2], cond_fn=b_bs[1],
                                    chunk=chunk)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    require(int(fp_carry[2]) == chunk
            and int(carries["vc_kernel_bsearch"][1]) == chunk
            and int(carries["vc_fused"][1]) == chunk * K_DEFAULT
            and int(b_carry[2]) == chunk * K_DEFAULT
            and int(bs_carry[2]) == chunk and int(tc_carry[1]) == chunk
            and int(btc_carry[2]) == chunk,
            "the sync-free chunks did not run their steps")
    require(not torch.equal(c_carry[1], state.e),
            "the sync-free cancellation chunk moved no excess")
    emit({"phase": "no_host_sync", "ok": True, "chunk": chunk,
          "loops": ["sweep[kernel]", "cycle[vc_kernel_bsearch]",
                    "cycle[vc_fused]", "batched cycle[vc_fused]",
                    "batched cycle[vc_kernel_bsearch]",
                    "phase-2 cancel[kernel]", "cycle[tc]",
                    "batched cycle[tc]"]})
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
    u_act = torch.nonzero(act).view(-1)
    # indptr words the AVQ forms read: u and u + 1 of each active u, once
    ip_act = distinct(torch, n + 1, u_act, u_act + 1)
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
    probes, v_push = search_reads(torch, push[do_push], g.indptr, g.heads,
                                  g.tails, steps)
    # what the rev entry reads once: indptr words of the active entries
    # and of the pushed-into segments; the heads of the frontier arcs with
    # res > 0 and those the searches probe; the heights of those arcs'
    # heads and of each entry with an admissible arc
    rev_ip = distinct(torch, n + 1, u_act, u_act + 1, v_push, v_push + 1)
    rev_hd = distinct(torch, a, torch.nonzero(f_mask).view(-1), probes)
    rev_h = distinct(torch, n, g.heads[f_mask], u_c[minh < inf])
    # the standalone search's row keeps 12 probes a push; read once its
    # bytes would be these
    alone_once = (8 * n + 4 * n_push
                  + 4 * distinct(torch, n + 1, v_push, v_push + 1)
                  + 4 * distinct(torch, a, push[do_push], probes))
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
            library=None, bytes=12 * n + 4 * ip_act + 4 * frontier,
            source="segmin", shape={"Q": n, "A": a, "active": n_active,
                                    "indptr_words": ip_act,
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
            library=None, bytes=12 * n + 4 * ip_act + 4 * frontier
            + 4 * frontier_pos + 4 * frontier_heads, source="segmin",
            shape={"Q": n, "A": a, "active": n_active,
                   "indptr_words": ip_act,
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
            shape={"P": n, "pushes": n_push, "steps": steps,
                   "bytes_read_once": alone_once}),
        "tile_min_neighbor_gather_rev": dict(
            kernel=lambda: tile_min_neighbor_gather_rev(
                avq, g.indptr, g.heads, g.tails, state.res, state.h, n=n,
                deg_max=meta.deg_max),
            plain=lambda: tile_min_neighbor_gather_rev_plain(
                avq, g.indptr, g.heads, g.tails, state.res, state.h, n=n,
                steps=steps),
            # the queue and three outputs a slot, res of each frontier
            # arc, each push's tail, and the indptr words, heads and
            # heights counted above, each once
            library=None, bytes=16 * n + 4 * frontier + 4 * n_push
            + 4 * rev_ip + 4 * rev_hd + 4 * rev_h, source="segmin",
            shape={"Q": n, "A": a, "active": n_active,
                   "frontier_arcs": frontier, "pushes": n_push,
                   "steps": steps, "indptr_words": rev_ip,
                   "heads_read": rev_hd, "heights_read": rev_h}),
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
        if name == "tile_min_neighbor_gather_rev":
            hold(name, c["kernel"](), (minh, argarc, kref.rev_search_ref(
                push, g.rev, a)), "main-path key-in entry and rev table")
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
            "launches": paths[ROW_PATH.get(name, "main")][name],
            "on_path": name not in OFF_PATH,
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
    # the bsearch cycle's search before and after the fold: the gather
    # entry, the push decision's select over the queue and the standalone
    # reverse search, against the rev entry's one launch

    def two_launches():
        mh, aa = tile_min_neighbor_gather(avq, g.indptr, g.heads, state.res,
                                          state.h, n=n)
        _, dp = pr._push_decision(state.h, u_c, avq < n, mh)
        return mh, aa, bcsr_rev_search(
            torch.where(dp, torch.clamp(aa, 0, a - 1), a), g.indptr,
            g.heads, g.tails, deg_max=meta.deg_max)

    hold("tile_min_neighbor_gather_rev", cases[
        "tile_min_neighbor_gather_rev"]["kernel"](), two_launches(),
        "main-path shapes, against the two-launch route")
    two_ms = device_ms(torch, two_launches, REPS)
    rev_ms = device_ms(torch, cases["tile_min_neighbor_gather_rev"]["kernel"],
                       REPS)
    emit({"phase": "hook_timing", "form": "avq+rev", "two_launches_ms": two_ms,
          "rev_entry_ms": rev_ms, "two_launches_over_rev_entry":
          two_ms / rev_ms})

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
