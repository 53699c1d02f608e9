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
  against plain ``vc`` bit for bit, and batched on 2 of ``serve_policy``'s
  ``washington_rlg(32, 32)`` against batched ``vc`` on the same 2 and
  Dinic, launching no kernel (the thread-centric scan is plain PyTorch;
  at 1024 x 1024 it would gather about 1G lanes a cycle);
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
  answered with no solve, and a decrease below the routed flow drained
  on the device (the gather entry's two forms) and re-solved warm,
  against a cold solve and Dinic;
* ``drain_kernel_vs_plain`` — the main path's corrected solution drained
  after the first batch of an adversarial update trace (source arcs
  zeroed, sink arcs raised), by ``reroute.apply_signed`` on the kernel
  and on the plain path, bit-equal;
* ``pooled_drain`` — the batched path's 8 corrected solutions, each with
  an adversarial batch, drained in one pooled dispatch
  (``reroute.apply_signed_batched``): every sweep step and selection one
  launch for the whole pool, each row bit-equal to its own drain and to
  the plain pooled drain;
* ``stream_path`` — ``Solver(mode="vc_kernel_bsearch").open_stream`` on
  ``washington_rlg(512, 512)``, then one adversarial batch, which must
  overflow the routed flow, and one mixed batch with a new arc pair (a
  structural rebuild around the routed flow); at every version the flow
  is feasible and its min cut has the version's value, and the first and
  last values equal scipy's Dinic on the graph and on the folded graph
  (both computed in the set-up pool while the card works);
* ``serve_path`` — ``MaxflowService(ServiceConfig(mode="vc_fused",
  max_batch=8))``, the batched path's graphs and 8 more as one serving
  bucket: 16 fresh requests (2 more coalesced) in 2 flushes, 4 cached
  repeats that launch nothing, and 4 resubmits (+50 on 16 min-cut arcs
  of two, 2 flow-carrying source arcs zeroed on two) whose first
  admission corrects the first flush in one pooled phase 2 (each step
  one launch for the group), riding one flush; every value against
  scipy's Dinic; on the card, bit for bit, the first flush's cold rows
  against the plain ``batched.batched_solve_impl`` on the bucket's shapes,
  the correction against the plain ``batched_phase2`` and the
  decreases' drains (on the gather entry) against the plain drain;
* ``serve_streams`` — 4 streams on the same service opened on cached
  graphs, one pooled wave of adversarial batches (drained on the gather
  entry) and a mixed batch with a new arc pair on 2, each drain against
  the plain drain, each version checked as in ``stream_path`` and the
  last against scipy's Dinic on the folded graph;
* ``serve_policy`` — ``mode="auto"`` on 20 ``washington_rlg(32, 32)``:
  4 trial flushes and one pinned, each kernel mode's flush launching its
  kernels (its rows bit for bit the plain ``batched_solve_impl``'s) and
  the ``vc`` flush none;
* ``serve_launcher`` — ``python -m repro_torch.launch.serve_maxflow``'s
  ``main`` in ``auto`` with ``--verify`` (its ``--smoke`` gates on the
  snapshot and trace it wrote, its telemetry overhead printed), and as
  the chaos run (flood, bounded queues, deadlines, injected faults):
  every served value against scipy's Dinic, every error typed and every
  injected dispatch fault counted;
* ``distributed_path`` — ``Solver(backend="distributed", mode="vc",
  global_relabel_cadence=64).solve(...)`` on the batched path's first
  ``washington_rlg(256, 256)`` over a one-rank NCCL group opened in this
  process, its value against scipy's Dinic;
  ``solve_distributed``'s three exchanges (``replicated``, ``sharded``,
  ``sparse``) on ``washington_rlg(128, 128)``, each against Dinic and all
  ending in the same state and superstep count.  The path has no kernel
  (its min search is the plain one, as in the reference), so every
  launch count must stay 0; on the main graph, one engine chunk of steps
  in each exchange and one of relabel sweeps must run without a host
  sync, and each is timed a step with its costliest device operations (the NCCL
  kernels among them), beside the all-reduce of MIN alone and a sweep
  with its all-reduce stubbed out; the launcher's card branch,
  ``python -m torch.distributed.run --standalone --nproc-per-node 1 -m
  repro_torch.launch.maxflow --backend distributed`` on the 128x128
  graph (NCCL over ``env://``, the rank on ``LOCAL_RANK``'s card), its
  printed value against scipy's Dinic, runs later beside the analyzer
  and the examples.

Last, ``analysis`` (PR 20): ``python -m repro_torch.launch.analyze
--device cuda --smoke`` in a process of its own runs all 25 dispatch
surfaces under the op census and sync-debug "error", holds each one's
kernel launches to the wrappers' counters and records whether a chunk of
its loop replays from a CUDA graph (``capturable``); it must find 0 rule
violations and 0 lint findings.  Then one chunk of each loop that
``step_timing`` times runs under the census and sync-debug "error" at the
main graph's mid-solve state, its kernel launches and aten ops a step
held to the same chunk's on the analyzer's small fixture.

The analyzer, the torchrun launcher and the three examples each run in
a process of their own and time nothing, so they run at once, beside
the full-width chunks and ``overflow``; the dry run times the card and
runs alone after them.  A process of their own that outlives
``SUBPROCESS_TIMEOUT`` seconds fails the run.

Then the capacity, dry-run and example phases: ``overflow`` — the
instances the int32 state cannot hold (a capacity of 2^33, a source
out-capacity of 2^32 - 2, a negative capacity) refused with
``OverflowError`` / ``ValueError`` through ``Solver.solve``, single and
batched, in every mode, and through ``MaxflowService.submit``, and an
instance exactly at the bound solved to Dinic's value on the card;
``dryrun`` — ``python -m repro_torch.launch.dryrun --all --arch
wbpr-maxflow --both-meshes``: its 12 graph cells (2 scales x 16x16 and 2x16x16 x 3 exchanges) one after
another in a process of its own, each one rank of the mesh on the card
under a fake process group, every record's meta that of its cell, its
collective bytes those of its shapes' formulas, no kernel launched;
``examples`` — the three max-flow examples
on the card, each verified against Dinic, the LM serving one (its caches
against teacher forcing) and the LM training one (qwen3-4b SMOKE trained
through ``launch/train.py``, its loss below a uniform guess, a run
resumed from its checkpoint ending on the same loss).

Right after the kernels' edge cases, while the set-up pool makes the
graphs, ``lm_serve``, the language-model path
(``repro_torch.launch.lm_serve_checks``), one row a family at full width:
qwen3-4b whole in bf16 (4,022,468,096 parameters, each leaf of its spec's
shape and dtype), served through ``python -m repro_torch.launch.serve
--arch qwen3-4b --batch 4 --prompt-len 2048 --tokens 32 --census``
(prefill wall, decode ms per token, tokens/s, peak bytes, the aten ops of
a decode step, each beside its bound; the decode loop under sync-debug
"error"); the same weights in float32 with TF32 off, the flash-prefilled
last logits against the train forward's and 32 decode steps against one
teacher-forced naive forward over the 2080 tokens; and 2 layers at full
width on the card against the CPU.  The same for rwkv6-1.6b whole
(2048 + 64 tokens), whisper-tiny whole (1500 random frames, 384 + 64
tokens), mixtral-8x7b at 16 of 32 layers and llama-3.2-vision-90b at 10
of 100 (1600 random patches; 2048 + 32 tokens each), their holds on 4
and 5 layers (whisper's, mixtral's and llama-vision's at unit gain,
where the reference's draw of random weights makes the attention near
one-hot; mixtral's in float64 at B = 1, where in float32 a router tie
flips an expert; rwkv6's in float64, where its float32 chain has a
tail); then jamba-1.5-large-398b's ``mamba+mlp`` layer
at full width and its SMOKE config whole.  It launches none of the
kernels.

After it, ``train``, LM training on the card
(``repro_torch.launch.train_checks``), each row at full width through
``make_train_step`` at B = 4 x 128 on one fixed batch: qwen3-4b whole
with AdamW (4,022,468,096 parameters, 8.04 GB of bf16 weights and 32.2
GB of float32 moments), jamba-1.5-large-398b's ``mamba+mlp`` layer with
Adafactor and mixtral-8x7b cut to 1 layer with AdamW (its aux loss above
0); each row's step wall, device time, idle share, peak bytes, aten ops
and host reads of a step (0, and the timed steps under sync-debug
"error"), the loss falling, and the step's bound (``8 N T`` operations
over the bf16 peak plus the optimizer's bytes over the HBM rate); then
qwen3-4b cut to 1 layer at full width in float32, TF32 off, on the card
against the CPU (loss, every gradient leaf, the global norm, one AdamW
update on the same gradients), and ``run_loop`` on it in bf16 with a
fault injected after the first of two checkpoints (one restart, the
clean run's loss exactly).  It launches none of the kernels.

After it, ``lm_sharded``, the multi-device LM
(``repro_torch.launch.sharded_checks``): one rank at full width under the
fake process group, its real shards on the card — qwen2-72b
``decode_32k`` at 16x16, all 80 layers (two steps across this rank's
first cache slot: the cache's local shapes, where each write lands,
finite logits), qwen3-4b ``train_4k`` at 16x16 (the 1/2-superblock
extrapolation of flops and collective bytes equal to the whole
36-layer run), GPipe at ``stages=1`` on a one-rank NCCL group against
``value_and_grad`` and stage 1 of 4 at full width,
``hierarchical_pod_psum`` on one NCCL rank bit-equal to the CPU, and the
other families' 1-superblock train cells while its 120 s budget lasts.
It launches none of the kernels.

Outside the chaos run no serving phase may take a rung of the service's
degradation ladder (retries, demotions, host fallbacks, dispatch errors):
a kernel that failed to build or launch would hide there.

The fused discharge is also held against its plain version at the
batched path's own shapes (after the first global relabel and mid-solve)
and on more rows than the card holds resident blocks, through both its
entries: the in-place one the drivers run, with its gate open and closed,
and the out-of-place one.  It checks that one engine chunk of cycles
(``vc_kernel_bsearch``, ``vc_fused`` and ``tc``, single and batched), of
global-relabel sweeps, of phase 2's cancellations and of the streaming
drain's multi-sink sweeps and deficit cancellations (single and pooled,
on the kernel and plain) never synchronises with the host, and times every kernel beside its plain version, a
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
import contextlib
import dataclasses
import json
import multiprocessing
import os
import pathlib
import re
import signal
import statistics
import subprocess
import sys
import tempfile
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
#: instances of the batched ``tc`` solve, the first ones of
#: ``serve_policy``'s (its thread-centric scan is the run's slowest
#: batched solve for its size)
TC_BATCH = 2
#: (rows, cols) of the mid-size graph that the streaming session runs
#: on, and of the distributed exchanges' and the torchrun launcher's
#: graph: the full run and ``--quick``
MID_SIZE = {False: (512, 512), True: (64, 64)}
DIST_SIZE = {False: (128, 128), True: (32, 32)}
#: steps a superstep of every distributed solve: the backend's default
#: (the reference's); with a global relabel that often a solve converges
#: in far fewer steps, and a step costs the host more than a sweep
DIST_CADENCE = 64
#: seconds a subprocess phase may take before it is killed and fails
SUBPROCESS_TIMEOUT = 240
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
#: the streaming phases' update traces: adversarial batches (each zeroes
#: source arcs and raises sink arcs, alternately; each must overflow the
#: routed flow), events a batch (one adversarial batch: the stream's
#: depth is what is cut to keep the whole run's time)
STREAM_ADVERSARIAL = 1
STREAM_EVENTS = 4
#: the serving phases: fresh instances of ``serve_path`` (the batched
#: path's 8 graphs and the next 8 seeds), of them the first ones submitted
#: twice before the flush, the cached repeats, the min-cut arcs raised by
#: ``WARM_DELTA`` on two resubmits and the source arcs zeroed on two more;
#: the streams opened on the second flush's graphs, the first ones of
#: which get a mixed second batch with a new arc pair
SERVE_FRESH = 2 * BATCH
SERVE_COALESCED = 2
SERVE_REPEATS = (2, 5, 9, 12)
SERVE_CUT_ARCS = 16
SERVE_ZEROED = 2
SERVE_STREAMS = 4
SERVE_MIXED = 2
#: ``serve_policy``'s instances (rows, cols) and count, full run and
#: ``--quick``, and its ``max_batch``: 5 flushes of one bucket
POLICY_SIZE = {False: (32, 32), True: (16, 16)}
POLICY_INSTANCES = 20
POLICY_BATCH = 4
#: ``serve_launcher``'s requests: the ``auto`` run and the chaos run
LAUNCHER_REQUESTS = {False: 24, True: 16}
CHAOS_REQUESTS = {False: 32, True: 16}
#: the path whose launches each kernel's row reports (the rest: "main")
ROW_PATH = {"tile_min_neighbor_gather[avq]": "vc_kernel",
            "fused_discharge_batched": "fused"}


def emit(obj) -> None:
    """One JSON line; a phase's line also gets ``t_s``, the seconds since
    the script started, so that the gaps between phases show."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


#: the script's start, for ``emit``'s ``t_s``
T_START = time.perf_counter()


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


def top_device_ops(torch, fn, steps: int, top: int | None = 6) -> dict:
    """The device time per step of the ``top`` costliest device kernels
    (``None``: all) in one call of ``fn`` (``steps`` steps), by
    ``torch.profiler``, in µs (names cut to 80 characters; ``aten::``
    entries are the host-side operators around those kernels and are
    left out)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernels whose names agree in their first 80 characters are summed
    us = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0 and not e.key.startswith("aten::"):
            us[e.key[:80]] = (us.get(e.key[:80], 0.0)
                              + e.self_device_time_total / steps)
    return dict(sorted(us.items(), key=lambda kv: -kv[1])[:top])


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
    return paths, {"main": main, "main_wall_s": wall,
                   "p_small": p_small, "v_small": v_small,
                   "sols": sols, "batch_values": [v for v, _ in got]}


def main_oracle(ctx, oracle):
    """The main path's value, and so its min cut's, against scipy's Dinic
    on the main graph; returns scipy's value."""
    want, t_scipy = oracle.get()
    emit({"phase": "oracle", "scipy_dinic_s": t_scipy, "scipy_value": want})
    main = ctx["main"]
    require(main.value == want,
            f"vc_kernel_bsearch value {main.value} != scipy Dinic {want}")
    return want


def flow_divergence(r, flows):
    """Per-vertex net inflow of per-pair ``flows`` (int64): ``-value`` at
    ``s``, ``value`` at ``t`` and 0 elsewhere for a conserved flow."""
    import numpy as np

    div = np.zeros(r.n, np.int64)
    f = flows.astype(np.int64)
    np.add.at(div, r.pair_u, -f)
    np.add.at(div, r.heads[r.pair_arc], f)
    return div


def tc_path(torch, ctx):
    """Phase ``tc_path``: the thread-centric baseline on the small graph,
    and batched on ``TC_BATCH`` of ``serve_policy``'s instances (made in
    the set-up pool, ``ctx["serve_in"]``), no kernel, against plain
    ``vc`` (batched on the same instances) and scipy's Dinic."""
    from repro_torch.api import MaxflowProblem, Solver

    tc, wall, launches = driven(torch, lambda: Solver(mode="tc").solve(
        ctx["p_small"]))
    require(not any(launches.values()), "tc launched a kernel")
    same_solution(torch, tc, ctx["v_small"], "tc vs vc")
    _, policy, _, want_policy, _, _ = ctx["serve_in"].get()
    sub = [MaxflowProblem(*x) for x in policy[:TC_BATCH]]
    tcb, wall_b, launches_b = driven(torch, lambda: Solver(
        backend="batched", mode="tc").solve_many(sub))
    require(not any(launches_b.values()), "batched tc launched a kernel")
    vcb = Solver(backend="batched", mode="vc").solve_many(sub)
    for i, (a, b) in enumerate(zip(tcb, vcb)):
        same_solution(torch, a, b, f"batched tc vs vc [{i}]")
    require([x.value for x in tcb] == want_policy[:TC_BATCH],
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


def matching_path(torch, quick, made):
    """Phase ``matching_path``: a bipartite matching through the
    paper-faithful mode, against scipy's Hopcroft-Karp; its graph
    ``made`` in the set-up pool (pending :func:`timed_call` of
    ``bipartite_random``)."""
    import numpy as np

    from repro_torch.api import MatchingProblem, Solver

    side = MATCHING_SIDE[quick]
    t0 = time.perf_counter()
    bp, gen_s = made.get()
    wait_s = time.perf_counter() - t0
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
          "gen_s": gen_s, "setup_wait_s": wait_s, "wall_s": wall,
          "cycles": sol.stats.cycles,
          "value": sol.value, "launches": launches,
          "matching_wall_s": wall_pairs, "matching_launches": launches_pairs,
          "scipy_value": want, "scipy_s": t_scipy,
          "over_60_s": wall > 60})
    return {"matching": launches}


def warm_path(torch, ctx):
    """Phase ``warm_path``: warm re-solves of the small graph's
    paper-faithful solution: capacity increases against a cold solve and
    scipy's Dinic, a slack-only decrease answered with no solve, and an
    overflowing decrease drained on the device and re-solved warm,
    against a cold solve and scipy's Dinic."""
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
    # a decrease below the routed flow: drained on the device, then warm
    carrying = np.nonzero((r.res0 > 0) & (r.res0 - res > 0))[0]
    b = int(carrying[0])
    applies = REGISTRY.counter("stream.reroute.applies")
    before = applies.value
    over, wall_over, launches_over = driven(torch, lambda: solver.resolve(
        handle, [CapacityUpdate(int(r.tails[b]), int(r.heads[b]),
                                -int(r.res0[b]))]), VC_KERNEL_KERNELS)
    require(over.stats.rerouted and over.stats.warm
            and applies.value == before + 1,
            "the overflowing decrease was not drained and re-solved warm")
    r3 = over.warm_start.residual
    again3, wall_again3, _ = driven(torch, lambda: solver.solve(
        MaxflowProblem.from_residual(r3, p.s, p.t)), MAIN_KERNELS)
    want3, _ = scipy_maxflow(r3.n, np.stack([r3.tails, r3.heads], 1),
                             r3.res0, p.s, p.t)
    require(over.value == again3.value == want3, f"drained {over.value} "
            f"!= cold {again3.value} / scipy Dinic {want3}")
    emit({"phase": "warm_path", "mode": "vc_kernel_bsearch",
          "increases": len(ups), "delta": WARM_DELTA,
          "cut_arcs": int(cut.size), "cold_value": cold.value,
          "cold_cycles": cold.stats.cycles, "cold_wall_s": wall_cold,
          "warm_value": warm.value, "warm_cycles": warm.stats.cycles,
          "warm_wall_s": wall_warm, "warm_launches": launches_warm,
          "cold_updated_cycles": again.stats.cycles,
          "cold_updated_wall_s": wall_again, "scipy_value": want,
          "noop_decrease_wall_s": wall_dec,
          "overflow_units": int(r.res0[b] - res[b]),
          "drained_value": over.value, "drained_cycles": over.stats.cycles,
          "drained_wall_s": wall_over, "drained_launches": launches_over,
          "drained_cold_cycles": again3.stats.cycles,
          "drained_cold_wall_s": wall_again3, "drained_scipy_value": want3})
    return {"warm": launches_warm}


def adversarial_batch(graph, s, t):
    """The first batch of the adversarial update trace of ``graph``: made
    in the set-up pool, as its trace is a host walk over every edge."""
    from repro_torch.graphs.generators import update_trace

    return update_trace(graph, s, t, n_batches=1, batch_size=STREAM_EVENTS,
                        adversarial=True, seed=SEED)[0]


def adversarial_deltas(r, batch):
    """``batch`` (:func:`adversarial_batch`) as signed deltas against
    ``r``."""
    from repro_torch.streaming import normalize_events

    return normalize_events(r, batch)[1]


def drain_kernel_vs_plain(torch, problem, ctx):
    """Phase ``drain_kernel_vs_plain``: the main path's corrected solution
    drained after the first adversarial batch (``ctx["drain_batch"]``, the
    main graph's :func:`adversarial_batch`) by ``reroute.apply_signed``
    on the min-search kernel and on the plain path, both on the card:
    bit-equal, and the plain drain launches nothing."""
    import numpy as np

    from repro_torch.streaming import reroute

    r, s, t = problem.residual("bcsr"), problem.s, problem.t
    res, e = ctx["main"].warm_start.arrays()  # corrected in phase2_path
    batch = ctx["drain_batch"]
    ups = adversarial_deltas(r, batch)
    ctx["drain_prep"] = reroute.prepare_signed(r, res, e, s, t, ups)
    kern, wall_k, launches_k = driven(torch, lambda: reroute.apply_signed(
        r, res, e, s, t, ups, use_kernel=True), VC_KERNEL_KERNELS)
    plain, wall_p, launches_p = driven(torch, lambda: reroute.apply_signed(
        r, res, e, s, t, ups))
    require(not any(launches_p.values()), "the plain drain launched a kernel")
    require(kern.rerouted and kern.ok and kern.overflow > 0,
            "the adversarial batch was not drained")
    require(np.array_equal(kern.res, plain.res)
            and np.array_equal(kern.e, plain.e)
            and (kern.value, kern.budget, kern.overflow, kern.ok)
            == (plain.value, plain.budget, plain.overflow, plain.ok),
            "the drain on the kernel != the plain drain on the card")
    emit({"phase": "drain_kernel_vs_plain", "events": len(batch),
          "deltas": ups, "overflow": kern.overflow,
          "value_before": int(e[t]), "value": kern.value,
          "budget": kern.budget, "kernel_wall_s": wall_k,
          "plain_wall_s": wall_p, "kernel_launches": launches_k,
          "same_as_plain": True})
    return {"drain": launches_k}


def pooled_drain(torch, ctx):
    """Phase ``pooled_drain``: the batched path's corrected solutions, each
    with its graph's first adversarial batch, drained in ONE pooled
    dispatch on the kernel: every call of the min-search hook spans the
    whole pool and is one launch, and each row is bit-equal to its own
    drain on the card and to the plain pooled drain."""
    import numpy as np

    from repro_torch.kernels import ops as kops
    from repro_torch.obs import REGISTRY
    from repro_torch.streaming import reroute

    items = []
    for sol, adv in zip(ctx["sols"]["vc_kernel_bsearch"],
                        ctx["batch_traces"]):
        h = sol.warm_start
        res, e = h.arrays()
        items.append((h.residual, res, e, h.s, h.t,
                      adversarial_deltas(h.residual, adv)))
    ctx["pool_preps"] = [reroute.prepare_signed(*it) for it in items]
    calls = {"dense": 0, "avq": 0, "rows": set()}
    hook = kops.min_neighbor_minh_fn

    def counting_hook():
        fn = hook()

        def counted(g, meta, state, avq, q_valid):
            calls["dense" if avq is None else "avq"] += 1
            calls["rows"].add(tuple(state.res.shape[:-1]))
            return fn(g, meta, state, avq, q_valid)
        return counted

    disp = REGISTRY.counter("stream.reroute.batched_dispatches")
    before = disp.value
    kops.min_neighbor_minh_fn = counting_hook
    try:
        pooled, wall, launches = driven(
            torch, lambda: reroute.apply_signed_batched(items,
                                                        use_kernel=True),
            VC_KERNEL_KERNELS)
    finally:
        kops.min_neighbor_minh_fn = hook
    require(disp.value == before + 1, "the pool was not one dispatch")
    require(calls["rows"] == {(len(items),)}
            and launches["tile_min_neighbor_gather[dense]"] == calls["dense"]
            and launches["tile_min_neighbor_gather[avq]"] == calls["avq"],
            f"a pooled step was not one launch for the pool: {calls}, "
            f"{launches}")
    plain, wall_p, launches_p = driven(
        torch, lambda: reroute.apply_signed_batched(items))
    require(not any(launches_p.values()), "the plain pool launched a kernel")
    per_row = {"tile_min_neighbor_gather[dense]": 0,
               "tile_min_neighbor_gather[avq]": 0}
    for i, (a, b, it) in enumerate(zip(pooled, plain, items)):
        own, _, own_l = driven(torch, lambda it=it: reroute.apply_signed(
            *it, use_kernel=True))
        for k in per_row:
            per_row[k] += own_l[k]
        for x in (b, own):
            require(np.array_equal(a.res, x.res) and np.array_equal(a.e, x.e)
                    and (a.value, a.budget, a.overflow, a.ok)
                    == (x.value, x.budget, x.overflow, x.ok),
                    f"pooled drain row {i} != its own drain / the plain pool")
        require(a.rerouted and a.ok, f"pooled row {i} was not drained")
    emit({"phase": "pooled_drain", "rows": len(items),
          "overflow": [x.overflow for x in pooled],
          "values": [x.value for x in pooled], "wall_s": wall,
          "plain_wall_s": wall_p, "launches": launches,
          "per_row_launches_sum": per_row, "same_as_plain": True,
          "same_as_per_row": True})
    return {"pooled_drain": launches}


def check_version(sol, s, t):
    """A version's flow is feasible on its capacities (each pair's net
    flow within its two arcs' capacities, conserved off ``s`` and ``t``)
    and its min cut has the version's value: together, proof that the
    flow is maximal.  Returns the cut's arc count."""
    import numpy as np

    r = sol.warm_start.residual
    flows = sol.flows()
    arc = r.pair_arc
    require(bool((flows <= r.res0[arc]).all()
                 and (-flows <= r.res0[r.rev[arc]]).all()),
            "a version's flow exceeds a capacity")
    div = flow_divergence(r, flows)
    inner = np.ones(r.n, bool)
    inner[[s, t]] = False
    require(div[t] == sol.value and div[s] == -sol.value
            and not div[inner].any(), "a version's flow is not conserved")
    cut = sol.min_cut()
    require(cut.value == sol.value, f"a version's min cut {cut.value} != "
            f"its value {sol.value}")
    return int(cut.cut_arcs.size)


def timed_call(fn, *args, **kw):
    """``(fn(*args, **kw), seconds)``: how the set-up pool's work is
    timed."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def main_graph(rows, cols):
    """The main graph, ``washington_rlg(rows, cols, seed=SEED)``, and its
    adversarial batch (:func:`adversarial_batch`): made in the set-up
    pool."""
    from repro_torch.graphs.generators import washington_rlg

    g, s, t = washington_rlg(rows, cols, seed=SEED)
    return (g, s, t), adversarial_batch(g, s, t)


def batch_graphs(size):
    """The batched path's instances, ``washington_rlg(*size)`` with seeds
    ``SEED``, ``SEED + 1``, ..., and each one's adversarial batch
    (:func:`adversarial_batch`): made in the set-up pool."""
    from repro_torch.graphs.generators import washington_rlg

    graphs = [washington_rlg(*size, seed=SEED + i) for i in range(BATCH)]
    return graphs, [adversarial_batch(*x) for x in graphs]


def stream_inputs(graph, s, t):
    """The streaming phase's update batches, made in the set-up pool
    while the card works: the adversarial batches (the first of which is
    :func:`adversarial_batch`'s) and the mixed one, and the seconds of
    each."""
    from repro_torch.graphs.generators import update_trace

    t0 = time.perf_counter()
    batches = update_trace(graph, s, t, n_batches=STREAM_ADVERSARIAL,
                           batch_size=STREAM_EVENTS, adversarial=True,
                           seed=SEED)
    t1 = time.perf_counter()
    batches += update_trace(graph, s, t, n_batches=1,
                            batch_size=STREAM_EVENTS, p_insert=0.5,
                            p_delete=0.0, seed=SEED)
    return batches, {"trace_gen_adversarial_s": t1 - t0,
                     "trace_gen_mixed_s": time.perf_counter() - t1}


def mid_inputs(size):
    """The streaming and distributed phases' host inputs, made in the
    set-up pool while the card works: ``washington_rlg(*size, seed=SEED)``
    and scipy's Dinic on it, the stream's update batches
    (:func:`stream_inputs`) and Dinic on the graph they fold it to (the
    oracle of the stream's last version).  Returns a dict."""
    from repro_torch.graphs.generators import (apply_events_to_graph,
                                               washington_rlg)

    t0 = time.perf_counter()
    g, s, t = washington_rlg(*size, seed=SEED)
    value, _ = scipy_maxflow(g.n, g.edges, g.cap, s, t)
    batches, trace_s = stream_inputs(g, s, t)
    folded = apply_events_to_graph(g, batches)
    folded_value, _ = scipy_maxflow(folded.n, folded.edges, folded.cap, s, t)
    return {"graph": (g, s, t), "size": size, "value": value,
            "batches": batches,
            "trace_s": trace_s, "folded_value": folded_value,
            "seconds": time.perf_counter() - t0}


def stream_path(torch, mid_in):
    """Phase ``stream_path``: a streaming session on the mid-size graph in
    the paper-faithful mode, through the adversarial batches and one
    mixed batch with a new arc pair (``mid_in``, the pending result of
    :func:`mid_inputs`); every version checked by :func:`check_version`,
    the last against scipy's Dinic on the folded graph."""
    from repro_torch.api import MaxflowProblem, Solver
    from repro_torch.obs import REGISTRY, TRACER
    from repro_torch.streaming import stream

    t0 = time.perf_counter()
    mid = mid_in.get()
    wait_s = time.perf_counter() - t0
    problem = MaxflowProblem(*mid["graph"])
    s, t = problem.s, problem.t
    batches, setup_s = mid["batches"], mid["trace_s"]

    class Recording(Solver):
        """Keeps the last warm re-solve's solution, for its cycles."""

        def resolve(self, handle, updates):
            self.last = super().resolve(handle, updates)
            return self.last

    rebuild_s = []
    rebuild = stream.rebuild_with_state

    def timed_rebuild(*args):
        t0 = time.perf_counter()
        out = rebuild(*args)
        rebuild_s.append(time.perf_counter() - t0)
        return out

    solver = Recording(mode="vc_kernel_bsearch")
    sg, wall_open, launches_open = driven(
        torch, lambda: solver.open_stream(problem), MAIN_KERNELS)
    _, wall_check, _ = driven(torch, lambda: check_version(sg.query(0), s, t))
    require(sg.query(0).value == mid["value"], f"the stream's first value "
            f"{sg.query(0).value} != scipy Dinic {mid['value']}")
    emit({"phase": "stream_version", "version": 0, "value": sg.query(0).value,
          "wall_s": wall_open, "launches": launches_open,
          "check_wall_s": wall_check, "setup_wait_s": wait_s,
          "trace_gen_adversarial_s": setup_s["trace_gen_adversarial_s"],
          "trace_gen_mixed_s": setup_s["trace_gen_mixed_s"]})
    counters = ("stream.reroute.overflow_units",
                "stream.reroute.drained_units")
    value = None
    stream.rebuild_with_state = timed_rebuild
    try:
        for i, batch in enumerate(batches):
            before = [REGISTRY.counter(c).value for c in counters]
            solver.last = None
            TRACER.clear()
            TRACER.enable()
            try:
                v, wall, launches = driven(torch, lambda b=batch: sg.apply(b))
            finally:
                TRACER.disable()
            spans = {}
            for ev in TRACER.to_dict()["traceEvents"]:
                spans.setdefault(ev["name"], []).append(ev["ts"])
            TRACER.clear()
            drain = spans.get("stream.reroute.pooled", [0.0, 0.0])
            over, drained = (REGISTRY.counter(c).value - b_
                             for c, b_ in zip(counters, before))
            require(not over or (
                launches["tile_min_neighbor_gather[dense]"] > 0
                and launches["tile_min_neighbor_gather[avq]"] > 0),
                "a drain did not launch both forms of the gather entry")
            q = sg.query(v)
            cut_arcs, wall_check, _ = driven(
                torch, lambda q=q: check_version(q, s, t))
            value = q.value
            emit({"phase": "stream_version", "version": v,
                  "kind": ("adversarial" if i < STREAM_ADVERSARIAL
                           else "mixed"),
                  "events": [repr(ev) for ev in batch], "value": value,
                  "wall_s": wall, "drain_wall_s": 1e-6 * (drain[1] - drain[0]),
                  "overflow_units": over, "drained_units": drained,
                  "cycles": (solver.last.stats.cycles if solver.last
                             else None),
                  "rerouted": bool(solver.last and solver.last.stats.rerouted),
                  "launches": launches, "check_wall_s": wall_check,
                  "cut_arcs": cut_arcs})
            if i < STREAM_ADVERSARIAL:
                require(over > 0, f"adversarial batch {i + 1} overflowed "
                        "nothing")
    finally:
        stream.rebuild_with_state = rebuild
    require(sg.stats()["structural_rebuilds"] == 1 and len(rebuild_s) == 1,
            f"the mixed batch made no structural rebuild: {sg.stats()}")
    require(value == mid["folded_value"], f"the stream's last value {value}"
            f" != scipy Dinic on the folded graph {mid['folded_value']}")
    emit({"phase": "stream_path", "ok": True, "versions": len(batches) + 1,
          "graph": f"washington_rlg({mid['size'][0]}, {mid['size'][1]}, "
          f"seed={SEED})", "stats": sg.stats(), "rebuild_s": rebuild_s,
          "scipy_folded_value": mid["folded_value"],
          "setup_s": mid["seconds"]})
    sg.close()
    return {"stream_open": launches_open}


def views_and_modes(quick, torch, problem, ctx, paths):
    """The phases of phase 2, the views, ``tc`` and streaming (their host
    inputs pending in the set-up pool, in ``ctx``), each driven with the
    launch counts set to 0 just before it and read just after."""
    paths.update(tc_path(torch, ctx))
    paths.update(phase2_path(torch, problem, ctx))
    batched_phase2(torch, ctx)
    paths.update(matching_path(torch, quick, ctx["matching_in"]))
    paths.update(warm_path(torch, ctx))
    paths.update(drain_kernel_vs_plain(torch, problem, ctx))
    paths.update(pooled_drain(torch, ctx))
    paths.update(stream_path(torch, ctx["mid_in"]))


def drain_loops(torch, ctx, minh_fn) -> dict:
    """The streaming drain's two device loops, each as ``(step, cond,
    carry)`` of one engine chunk, from the overflows
    ``drain_kernel_vs_plain`` (the main graph) and ``pooled_drain`` (the
    batch) prepared: the multi-sink distance sweeps, and the deficit
    cancellations under fixed heights; single and pooled, on the kernel
    hook ``minh_fn`` and plain."""
    from repro_torch.core import batched, engine
    from repro_torch.core import pushrelabel as pr
    from repro_torch.streaming import reroute

    loops = {}
    prep = ctx["drain_prep"]
    s, t = prep.s, prep.t
    g, meta, res0 = pr.to_device(prep.residual)
    st = pr.state_from_numpy(prep.res, prep.b, prep.e)
    sink = engine.fill_at(st.h > 0, t, True)
    preps = ctx["pool_preps"]
    bg, bmeta, bres0, _ = batched.pack_instances(
        [(x.residual, x.s, x.t) for x in preps])
    bst = batched.pack_states([(x.res, x.b, x.e) for x in preps], bmeta.n,
                              bmeta.num_arcs)
    rows = batched._rows(bg)
    flat = batched._flat(rows, bmeta)
    bsink = (bst.h > 0).scatter_(1, bg.t.long()[:, None], True)
    moved = torch.ones((), dtype=torch.bool, device=res0.device)
    for fn, how in ((minh_fn, "kernel"), (None, "plain")):
        loops[f"drain sweep[{how}]"] = engine.fixpoint_loop(
            *reroute._multi_sink_sweep(g, meta, res0 - st.res, sink, fn),
            cap=meta.n)
        loops[f"pooled drain sweep[{how}]"] = engine.fixpoint_loop(
            *reroute._batched_multi_sink_sweep(rows, bmeta, bres0 - bst.res,
                                               bsink, fn), cap=bmeta.n)
        height = reroute._multi_sink_distances(g, meta, res0 - st.res, sink,
                                               fn)
        bheight = reroute._batched_multi_sink_distances(
            rows, bmeta, bres0 - bst.res, bsink, fn)

        def cancel(c, fn=fn, height=height):
            res, b = reroute._deficit_cancel_step(g, meta, res0, c[0],
                                                  height, c[1], s, t, fn)
            return res, b, torch.any(b != c[1])

        def bcancel(c, fn=fn, height=bheight):
            res, b = reroute._batched_deficit_cancel_step(
                rows, bmeta, flat, bres0, c[0], height, c[1], bg.s, bg.t,
                fn)
            return res, b, torch.any(b != c[1])

        loops[f"deficit cancel[{how}]"] = (cancel, lambda c: c[2],
                                           (st.res, st.h, moved))
        loops[f"pooled deficit cancel[{how}]"] = (bcancel, lambda c: c[2],
                                                  (bst.res, bst.h, moved))
    return loops


# ---------------------------------------------------------------------------
# serving: MaxflowService and serve_maxflow on the card
# ---------------------------------------------------------------------------

#: the robustness counters that must stay 0 outside the chaos run
ROBUST_ZERO = ("retries", "transient_demotions", "sticky_demotions",
               "host_fallbacks", "dispatch_failed", "quarantined",
               "budget_exhausted", "rejected", "shed", "expired_at_admission")


def serve_clean(stats, metrics, what):
    """No rung of the degradation ladder was taken and no dispatch raised:
    a kernel that failed to build or launch would hide there."""
    rb = stats["robustness"]
    bad = {k: rb[k] for k in ROBUST_ZERO if rb[k]}
    errs = {k: v for k, v in metrics["counters"].items()
            if k.startswith("serve.dispatch_errors") and v}
    require(not bad and not errs, f"{what}: the ladder was taken: {bad} "
            f"{errs}")


def flush_recorder(torch, svc):
    """Wrap ``svc``'s flushes to record each one's live rows, wall, kernel
    launches and the modes of its ``serve.solve`` spans (the tracer is on
    while a serving phase runs)."""
    from repro_torch.obs import TRACER

    flushes = []
    flush = svc._flush_bucket

    def recorded(key):
        before = launch_counts()
        n0 = len(TRACER)
        t0 = time.perf_counter()
        live = flush(key)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = launch_counts()
        evs = TRACER.to_dict()["traceEvents"][n0:]
        flushes.append({
            "live": live, "wall_s": wall,
            "modes": [e["args"]["mode"] for e in evs
                      if e["name"] == "serve.solve" and e["ph"] == "B"],
            "launches": {k: after[k] - before[k] for k in KERNELS}})
        return live

    svc._flush_bucket = recorded
    return flushes


def span_walls(name):
    """Wall seconds of each ``name`` span the tracer holds."""
    from repro_torch.obs import TRACER

    out, open_ = [], []
    for ev in TRACER.to_dict()["traceEvents"]:
        if ev["name"] != name:
            continue
        if ev["ph"] == "B":
            open_.append(ev["ts"])
        elif ev["ph"] == "E":
            out.append(1e-6 * (ev["ts"] - open_.pop()))
    return out


@contextlib.contextmanager
def recording(module, name):
    """For the block, ``module.name`` logs each call as ``(args, kwargs,
    result)``; yields the log."""
    fn = getattr(module, name)
    log = []

    def logged(*args, **kwargs):
        out = fn(*args, **kwargs)
        log.append((args, kwargs, out))
        return out

    setattr(module, name, logged)
    try:
        yield log
    finally:
        setattr(module, name, fn)


def drains_vs_plain(log, what):
    """Each ``reroute.drain_prepared`` call of ``log`` ran on the kernel
    route, and each of its results equals the plain drain of the same
    preparations on the same device, bit for bit.  Returns the number of
    preparations that overflowed (those a device drain ran for)."""
    import numpy as np

    from repro_torch.streaming import reroute

    drained = 0
    for args, kwargs, out in log:
        (preps,) = args
        require(kwargs["use_kernel"], f"{what}: a served drain ran off the "
                "kernel route")
        plain = reroute.drain_prepared(preps, use_kernel=False,
                                       device=kwargs["device"])
        for a, b in zip(out, plain):
            require(np.array_equal(a.res, b.res) and np.array_equal(a.e, b.e)
                    and (a.value, a.budget, a.overflow, a.rerouted, a.ok)
                    == (b.value, b.budget, b.overflow, b.rerouted, b.ok),
                    f"{what}: a served drain != the plain drain on the card")
        drained += sum(p.overflow > 0 for p in preps)
    return drained


@contextlib.contextmanager
def plain_hooks():
    """For the block, the ``vc_fused`` driver runs each kernel's plain
    version: the fused discharge's in-place entry
    (``fused_discharge_batched_plain_``) and the global relabel's min
    search (``vc``'s plain scan)."""
    from repro_torch.core import engine
    from repro_torch.kernels import discharge

    resolve, fused = engine.resolve_minh_fn, discharge.fused_discharge_batched_
    engine.resolve_minh_fn = lambda mode: resolve("vc")
    discharge.fused_discharge_batched_ = (
        discharge.fused_discharge_batched_plain_)
    try:
        yield
    finally:
        engine.resolve_minh_fn = resolve
        discharge.fused_discharge_batched_ = fused


def rows_vs_plain(torch, handles, results, key, mode, what):
    """Served rows, each the handle of one live request of one flush in
    the kernel mode ``mode`` (before any correction), against
    ``batched.batched_solve_impl`` of the same instances on the bucket's
    own shapes and the service's cycle chunk with every kernel on its
    plain version: ``vc_fused`` under :func:`plain_hooks`, and for
    ``vc_kernel``/``vc_kernel_bsearch`` the ``vc`` mode (the same cycle
    with the min search, and its reverse arcs, by the plain scan).
    ``res``/``e``, cycles and rounds bit for bit; the plain run launches
    nothing.  Returns the number of rows held."""
    import numpy as np

    from repro_torch.core import batched

    before = launch_counts()
    with plain_hooks() if mode == "vc_fused" else contextlib.nullcontext():
        ref = batched.batched_solve_impl(
            [(h.residual, h.s, h.t) for h in handles],
            mode="vc_fused" if mode == "vc_fused" else "vc",
            n_pad=key.n_pad, A_pad=key.arc_pad, deg_max=key.deg_max,
            telemetry=True)
    require(launch_counts() == before, f"{what}: the plain run launched a "
            "kernel")
    rres, re_ = ref.state.res.cpu().numpy(), ref.state.e.cpu().numpy()
    for j, (h, r) in enumerate(zip(handles, results)):
        require(not h.corrected and np.array_equal(
            h._res, rres[j, :h.residual.num_arcs])
                and np.array_equal(h._e, re_[j, :h.residual.n])
                and r.cycles == ref.cycles[j] and r.rounds == ref.rounds[j],
                f"{what}: served row {j} != the plain batched_solve_impl")
    return len(handles)


def sink_side(r, res, t):
    """Vertices that reach ``t`` through arcs with residual: for a maximum
    preflow, the sink side of a minimum cut (host BFS)."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import breadth_first_order

    live = res > 0
    rev_graph = csr_matrix((np.ones(int(live.sum()), np.int8),
                            (r.heads[live], r.tails[live])),
                           shape=(r.n, r.n))
    side = np.zeros(r.n, bool)
    side[breadth_first_order(rev_graph, t, return_predecessors=False)] = True
    return side


def handle_solution(handle, value):
    """A ``Solution`` view of a served handle, for its flows and cut."""
    from repro_torch.api.solution import Solution, SolveStats

    return Solution(None, value, SolveStats(), handle, None)


def serve_path(torch, graphs, want, pool, drain_log):
    """Phase ``serve_path``: ``MaxflowService(mode="vc_fused",
    max_batch=8)`` on the card, one bucket of ``washington_rlg`` graphs:
    16 fresh instances (2 coalesced repeats) in 2 flushes, 4 cached
    repeats, 4 resubmits (16 min-cut arcs +50 on two, 2 flow-carrying
    source arcs zeroed on two) whose first admission corrects the first
    flush in one pooled phase 2, then one flush.  Every value against
    scipy's Dinic (``want``); on the card, bit for bit: the first
    flush's cold rows against the plain ``batched_solve_impl``
    (:func:`rows_vs_plain`), the correction
    against the plain ``batched_phase2`` and the decreases' drains
    (``drain_log``, on the gather entry) against the plain drain.
    Returns the service, its context and the launches."""
    import numpy as np

    from repro_torch.core import batched
    from repro_torch.kernels import ops as kops
    from repro_torch.obs import REGISTRY, TRACER
    from repro_torch.serving import MaxflowService, ServiceConfig

    REGISTRY.reset()
    TRACER.clear()
    TRACER.enable()
    svc = MaxflowService(ServiceConfig(mode="vc_fused", max_batch=BATCH))
    flushes = flush_recorder(torch, svc)
    paths = {}

    def cold():
        futs = [svc.submit(*x) for x in graphs]
        futs += [svc.submit(*graphs[i]) for i in range(SERVE_COALESCED)]
        require(svc.n_coalesced == SERVE_COALESCED
                and svc.pending == len(graphs), "the repeats did not "
                "coalesce onto the queued solves")
        svc.poll()
        return futs

    futs, wall_cold, paths["serve_cold"] = driven(torch, cold, FUSED_KERNELS)
    cold_res = [f.result() for f in futs]
    require(len(flushes) == 2 and [f["live"] for f in flushes] == [BATCH] * 2
            and all(r.batch_size == BATCH for r in cold_res),
            f"the cold requests did not ride 2 full flushes: {flushes}")
    got = [r.maxflow for r in cold_res[:len(graphs)]]
    require(got == want, f"served values {got} != scipy Dinic {want}")
    require([r.maxflow for r in cold_res[len(graphs):]]
            == want[:SERVE_COALESCED], "a coalesced request differs")
    (key,) = svc._buckets
    handles = [svc.results.peek(r.graph_id).handle for r in cold_res[
        :len(graphs)]]
    pre = [(h._res.copy(), h._e.copy()) for h in handles]
    # the first flush's cold rows bit for bit against the plain batched
    # core on the bucket's own shapes (its first global relabel and
    # chunking are the service's); the second flush runs the same code on
    # other rows, and the plain discharge takes about 20 ms a launch
    t0 = time.perf_counter()
    same = rows_vs_plain(torch, handles[:BATCH], cold_res[:BATCH], key,
                         "vc_fused", "serve_path")
    plain_wall = time.perf_counter() - t0

    reps, wall_rep, paths["serve_repeats"] = driven(torch, lambda: [
        svc.submit(*graphs[i]).result() for i in SERVE_REPEATS])
    require(all(r.cached for r in reps) and not any(
        paths["serve_repeats"].values()), "a repeat was not a cache hit")

    # two resubmits raise 16 arcs of a min cut by +50 each
    rng = np.random.default_rng(SEED)
    ups = {}
    for i in (0, 1):
        h = handles[i]
        r = h.residual
        side = sink_side(r, pre[i][0], h.t)
        cut = np.nonzero(~side[r.tails] & side[r.heads] & (r.res0 > 0))[0]
        pick = rng.choice(cut, size=SERVE_CUT_ARCS, replace=False)
        ups[i] = [(int(r.tails[a]), int(r.heads[a]), WARM_DELTA)
                  for a in pick]
    calls = {"dense": 0, "avq": 0, "rows": set()}
    hook = kops.min_neighbor_minh_fn

    def counting_hook():
        fn = hook()

        def counted(g, meta, state, avq, q_valid):
            calls["dense" if avq is None else "avq"] += 1
            calls["rows"].add(tuple(state.res.shape[:-1]))
            return fn(g, meta, state, avq, q_valid)
        return counted

    corr = REGISTRY.counter("serve.phase2_corrections")
    kops.min_neighbor_minh_fn = counting_hook
    try:
        resub, wall_inc, paths["serve_correction"] = driven(
            torch, lambda: [svc.resubmit(cold_res[i].graph_id, ups[i])
                            for i in (0, 1)], VC_KERNEL_KERNELS)
    finally:
        kops.min_neighbor_minh_fn = hook
    p2_spans = span_walls("serve.phase2")
    first = handles[:BATCH]
    require(corr.value == BATCH and len(p2_spans) == 1
            and all(h.corrected for h in first)
            and not any(h.corrected for h in handles[BATCH:]),
            f"the first resubmit did not correct the first flush in one "
            f"pooled dispatch: {corr.value} corrections, {p2_spans}")
    lc = paths["serve_correction"]
    require(calls["rows"] == {(BATCH,)}
            and lc["tile_min_neighbor_gather[dense]"] == calls["dense"]
            and lc["tile_min_neighbor_gather[avq]"] == calls["avq"],
            f"a pooled correction step was not one launch for the group: "
            f"{calls}, {lc}")
    # two resubmits zero 2 flow-carrying source arcs each (corrected flow):
    # decreases below the routed flow, drained on the card
    for i in (2, 3):
        h = handles[i]
        res, _ = h.arrays()
        r = h.residual
        seg = np.arange(r.indptr[h.s], r.indptr[h.s + 1])
        carrying = seg[(r.res0[seg] - res[seg]) > 0]
        pick = rng.choice(carrying, size=SERVE_ZEROED, replace=False)
        ups[i] = [(int(r.tails[a]), int(r.heads[a]), -int(r.res0[a]))
                  for a in pick]
    # scipy's Dinic on the edited graphs (the updates as extra parallel
    # edges, summed), meanwhile
    want_r = []
    for i in range(4):
        g, s, t = graphs[i]
        extra = np.array([(u, v) for u, v, _ in ups[i]], np.int64)
        want_r.append(pool.apply_async(scipy_maxflow, (
            g.n, np.concatenate([g.edges, extra]),
            np.concatenate([g.cap, [d for _, _, d in ups[i]]]), s, t)))
    over = REGISTRY.counter("stream.reroute.overflow_units")
    n_log = len(drain_log)
    resub2, wall_dec, paths["serve_drain"] = driven(
        torch, lambda: [svc.resubmit(cold_res[i].graph_id, ups[i])
                        for i in (2, 3)], VC_KERNEL_KERNELS)
    dec_drains = drain_log[n_log:]
    require(over.value > 0, "the zeroed source arcs overflowed nothing")
    resub += resub2
    n_before = len(flushes)
    _, wall_flush, paths["serve_resubmits"] = driven(torch, svc.flush,
                                                     FUSED_KERNELS)
    res_res = [f.result() for f in resub]
    require(len(flushes) == n_before + 1
            and flushes[-1]["live"] == len(resub)
            and all(r.warm and r.batch_size == len(resub) for r in res_res),
            "the 4 resubmits did not ride one warm flush")
    # served handles drain on the gather entry (the service's kernel
    # route), each drain bit for bit the plain drain of its preparation
    drained = drains_vs_plain(dec_drains, "serve_path")
    require(drained == 2, f"the zeroed source arcs of the 2 resubmits "
            f"overflowed {drained} drains")
    # the pooled correction against the plain batched phase 2 on the card
    bg, meta, res0, _ = batched.pack_instances(
        [(h.residual, h.s, h.t) for h in first])
    state = batched.pack_states(
        [(p[0], np.zeros(h.residual.n, np.int32), p[1])
         for h, p in zip(first, pre)], meta.n, meta.num_arcs)
    plain, left = batched.batched_phase2(bg, meta, res0, state, scan=True)
    batched.check_phase2_leftover(left)
    pres, pe = plain.res.cpu().numpy(), plain.e.cpu().numpy()
    inner_ok = 0
    for j, (h, r) in enumerate(zip(first, cold_res)):
        res, e = h.arrays()
        hr = h.residual
        require(np.array_equal(res, pres[j, :hr.num_arcs])
                and np.array_equal(e, pe[j, :hr.n]),
                f"pooled correction row {j} != the plain batched phase 2")
        h.validate()
        div = flow_divergence(hr, handle_solution(h, r.maxflow).flows())
        inner = np.ones(hr.n, bool)
        inner[[h.s, h.t]] = False
        require(div[h.t] == r.maxflow and div[h.s] == -r.maxflow
                and not div[inner].any(), f"row {j}'s flow is not conserved")
        inner_ok += 1
    want_r = [o.get()[0] for o in want_r]
    require([r.maxflow for r in res_res] == want_r,
            f"resubmit values {[r.maxflow for r in res_res]} != scipy "
            f"Dinic {want_r}")
    st = svc.stats()
    serve_clean(st, REGISTRY.snapshot(), "serve_path")
    require(st["executables"]["compiles"] == 1 and st["buckets"] == 1,
            f"more than one signature or bucket: {st['executables']}")
    lat = np.array([f.latency_s for f in futs])
    lat_r = np.array([f.latency_s for f in resub])
    emit({"phase": "serve_path", "mode": "vc_fused", "bucket": key.label,
          "requests": len(futs) + len(reps) + len(resub),
          "coalesced": st["coalesced"], "cold_wall_s": wall_cold,
          "flushes": flushes, "rows_equal_plain": same,
          "plain_rows_wall_s": plain_wall,
          "repeat_wall_s": wall_rep, "repeat_launches": paths[
              "serve_repeats"],
          "resubmit_values": [r.maxflow for r in res_res],
          "resubmit_cycles": [r.cycles for r in res_res],
          "resubmit_phase2_s": [r.phase2_s for r in res_res],
          "increase_admission_wall_s": wall_inc,
          "correction_launches": lc, "correction_wall_s": p2_spans[0],
          "correction_shape": f"n{meta.n}a{meta.num_arcs}d{meta.deg_max}",
          "corrected_rows_equal_plain": inner_ok,
          "decrease_admission_wall_s": wall_dec,
          "decrease_launches": paths["serve_drain"],
          "drains_equal_plain": drained,
          "resubmit_flush_wall_s": wall_flush,
          "latency_p50_s": float(np.percentile(lat, 50)),
          "latency_p99_s": float(np.percentile(lat, 99)),
          "resubmit_latency_p50_s": float(np.percentile(lat_r, 50)),
          "resubmit_latency_p99_s": float(np.percentile(lat_r, 99)),
          "phase2_s": st["phase2_time_s"], "sweep_s": st["sweep_time_s"],
          "bucket_counters": st["bucket_counters"],
          "executables": st["executables"]["compiles"]})
    return svc, {"graphs": graphs, "cold": cold_res, "flushes": flushes}, \
        paths


def serve_streams(torch, svc, sctx, pool, drain_log):
    """Phase ``serve_streams``: on the same service, 4 streams opened on
    cached graphs of the second flush (no solve), one pooled wave of
    adversarial batches (its drain on the gather entry), then a mixed
    batch with a new arc pair on 2 of them; each wave's pooled drain bit
    for bit the plain drain on the card (``drain_log``), every version
    feasible with a min cut of its value (:func:`check_version`), the
    last against scipy's Dinic on the folded graph."""
    import numpy as np

    from repro_torch.graphs.generators import (apply_events_to_graph,
                                               update_trace)
    from repro_torch.obs import REGISTRY, TRACER
    from repro_torch.streaming import EdgeInsert

    graphs = sctx["graphs"][BATCH:BATCH + SERVE_STREAMS]
    flushes = sctx["flushes"]
    paths = {}
    REGISTRY.reset()
    solved = svc.n_solved
    sids, wall_open, paths["serve_open"] = driven(
        torch, lambda: [svc.open_stream(*x) for x in graphs])
    require(not any(paths["serve_open"].values())
            and svc.n_solved == solved,
            "opening a stream on a cached graph solved it")
    adv = sctx["stream_traces"]
    rng = np.random.default_rng(SEED)
    mixed = []
    for g, s, t in graphs[:SERVE_MIXED]:
        pairs = set(map(tuple, g.edges.tolist()))
        while True:  # one new arc pair: neither direction is in the graph
            u, v = (int(x) for x in rng.integers(0, g.n, 2))
            if u != v and (u, v) not in pairs and (v, u) not in pairs:
                break
        mixed.append(update_trace(
            g, s, t, n_batches=1, batch_size=STREAM_EVENTS - 1,
            p_insert=0.0, p_delete=0.0, seed=SEED)[0]
            + [EdgeInsert(u, v, WARM_DELTA)])
    waves = [list(zip(sids, adv)), list(zip(sids[:SERVE_MIXED], mixed))]
    corr = REGISTRY.counter("serve.phase2_corrections")
    disp = REGISTRY.counter("stream.reroute.batched_dispatches")
    rows = []
    for w, items in enumerate(waves):
        c0, d0, n0, l0 = corr.value, disp.value, len(flushes), len(drain_log)
        TRACER.clear()
        futs, wall_apply, launches_apply = driven(
            torch, lambda items=items: svc.stream_apply_many(items),
            () if w else VC_KERNEL_KERNELS)
        spans = len(span_walls("serve.phase2"))
        n_corr, n_drain = corr.value - c0, disp.value - d0
        require(spans <= 1 and n_corr <= BATCH and n_drain <= 1,
                f"wave {w}: more than one pooled correction or drain: "
                f"{spans}, {n_drain}")
        drained = drains_vs_plain(drain_log[l0:], f"serve_streams wave {w}")
        require(drained > 0 or w, "the adversarial wave drained nothing")
        _, wall_flush, launches_flush = driven(torch, svc.flush)
        require(len(flushes) - n0 <= 1, f"wave {w}: the warm re-solves did "
                "not ride one flush")
        if len(flushes) > n0:
            for k in FUSED_KERNELS:
                require(launches_flush[k] > 0, f"wave {w}'s flush never "
                        f"launched {k}")
        checks = []
        for (sid, _), f in zip(items, futs):
            r = f.result()
            _, s, t = graphs[sids.index(sid)]
            rec = svc._stream(sid).chain.get(r.version)
            require(rec.value == r.maxflow, "a version's value differs")
            cut_arcs, wall_check, _ = driven(torch, lambda rec=rec, s=s, t=t:
                                             check_version(handle_solution(
                                                 rec.handle, rec.value),
                                                 s, t))
            checks.append({"version": r.version, "value": r.maxflow,
                           "warm": r.warm, "cycles": r.cycles,
                           "cut_arcs": cut_arcs, "check_wall_s": wall_check})
        rows.append({"wave": w, "streams": len(items),
                     "events": [[repr(ev) for ev in b] for _, b in items],
                     "apply_wall_s": wall_apply,
                     "apply_launches": launches_apply,
                     "corrections": n_corr, "pooled_drains": n_drain,
                     "drained_streams_equal_plain": drained,
                     "flush_wall_s": wall_flush,
                     "flush_launches": launches_flush, "versions": checks})
        paths[f"serve_stream_wave{w}"] = launches_flush
    # the last version of each stream against scipy on the folded graph
    want = []
    for i, (g, s, t) in enumerate(graphs):
        folded = apply_events_to_graph(g, [adv[i]] + mixed[i:i + 1])
        want.append(pool.apply_async(scipy_maxflow, (
            folded.n, folded.edges, folded.cap, s, t)))
    closes = []
    for i, (sid, o) in enumerate(zip(sids, want)):
        got, value = svc.stream_query(sid).maxflow, o.get()[0]
        require(got == value, f"stream {i}'s last value {got} != scipy "
                f"Dinic on the folded graph {value}")
        closes.append(svc.close_stream(sid))
        require(closes[-1]["rebuilds"] == int(i < SERVE_MIXED),
                f"stream {i}: {closes[-1]['rebuilds']} structural rebuilds")
    st = svc.stats()
    serve_clean(st, REGISTRY.snapshot(), "serve_streams")
    emit({"phase": "serve_streams", "streams": len(sids),
          "open_wall_s": wall_open, "open_launches": paths["serve_open"],
          "waves": rows, "close_stream": closes,
          "bucket_counters": st["bucket_counters"]})
    return paths


def serve_policy(torch, graphs, want):
    """Phase ``serve_policy``: ``ServiceConfig(mode="auto", max_batch=4)``
    on 20 ``washington_rlg`` instances of one bucket: 4 trial flushes
    (each first signature re-dispatched warm), then one in the pinned
    mode.  Every value against scipy's Dinic; each kernel-mode flush
    launched its kernels, the ``vc`` flush none, and each kernel-mode
    trial's rows equal the plain ``batched_solve_impl`` on the card
    (:func:`rows_vs_plain`); no rung of the ladder taken."""
    from repro_torch.obs import REGISTRY, TRACER
    from repro_torch.serving import MaxflowService, ServiceConfig

    REGISTRY.reset()
    TRACER.clear()
    TRACER.enable()
    svc = MaxflowService(ServiceConfig(mode="auto", max_batch=POLICY_BATCH))
    flushes = flush_recorder(torch, svc)

    def run():
        futs = [svc.submit(*x) for x in graphs]
        svc.poll()
        return [f.result() for f in futs]

    res, wall, launches = driven(torch, run)
    require([r.maxflow for r in res] == want,
            f"auto values {[r.maxflow for r in res]} != scipy Dinic {want}")
    st = svc.stats()
    serve_clean(st, REGISTRY.snapshot(), "serve_policy")
    (pol,) = st["mode_policy"].values()
    expect = {"vc": (), "vc_kernel": VC_KERNEL_KERNELS,
              "vc_kernel_bsearch": MAIN_KERNELS, "vc_fused": FUSED_KERNELS}
    require(len(flushes) == len(graphs) // POLICY_BATCH
            and [f["modes"][0] for f in flushes[:4]] == pol["candidates"]
            and all(len(f["modes"]) == 2 for f in flushes[:4])
            and flushes[4]["modes"] == [pol["pinned"]],
            f"not 4 trials then the pin: {[f['modes'] for f in flushes]}")
    for f in flushes:
        mode = f["modes"][0]
        for k in expect[mode]:
            require(f["launches"][k] > 0, f"a {mode} flush never launched "
                    f"{k}")
        if mode == "vc":
            require(not any(f["launches"].values()),
                    "the vc flush launched a kernel")
    (key,) = svc._buckets
    t0 = time.perf_counter()
    held = {}
    for i, f in enumerate(flushes[:4]):
        mode = f["modes"][0]
        if mode != "vc":
            rows = res[i * POLICY_BATCH:(i + 1) * POLICY_BATCH]
            held[mode] = rows_vs_plain(
                torch, [svc.results.peek(r.graph_id).handle for r in rows],
                rows, key, mode, f"serve_policy[{mode}]")
    emit({"phase": "serve_policy", "instances": len(graphs),
          "rows_equal_plain": held,
          "plain_rows_wall_s": time.perf_counter() - t0,
          "bucket": next(iter(st["mode_policy"])), "wall_s": wall,
          "flushes": flushes, "per_cycle_s": pol["per_cycle_s"],
          "pinned": pol["pinned"], "launches": launches,
          "dispatches_by_mode": st["executables"]["dispatches_by_mode"]})
    return {f"serve_policy[{f['modes'][0]}]": f["launches"]
            for f in flushes[:4]}


def launcher_oracles(pool, drive_log, records, what):
    """scipy's Dinic, started in ``pool``, on the graph of each work item
    a launcher run served (``workload.resolve_item`` on the items the
    run's ``drive`` call was given, in ``drive_log``): ``[(served value,
    AsyncResult), ...]`` for :func:`launcher_vs_dinic`."""
    from repro_torch.serving.workload import resolve_item

    ((args, _, _),) = drive_log
    items = args[1]
    require(len(items) == len(records), f"{what}: {len(records)} records "
            f"for {len(items)} items")
    held = []
    for item, rec in zip(items, records):
        if rec["error"] is None:
            g, s, t = resolve_item(items, item)
            held.append((rec["result"].maxflow, pool.apply_async(
                scipy_maxflow, (g.n, g.edges, g.cap, s, t))))
    return held


def launcher_vs_dinic(held, what):
    """Every value a launcher run served against scipy's Dinic
    (``held``, from :func:`launcher_oracles`).  Returns the number of
    values held."""
    got = [v for v, _ in held]
    want = [o.get()[0] for _, o in held]
    require(got == want, f"{what}: served values {got} != scipy Dinic "
            f"{want}")
    return len(held)


def serve_launcher(torch, quick, pool):
    """Phase ``serve_launcher``: ``repro_torch.launch.serve_maxflow.main``
    on the card, once in the default ``auto`` mode with ``--verify``, a
    trace and a snapshot (the ``--smoke`` gates on what it wrote, and the
    telemetry overhead measured and printed), and once as the chaos run
    (a flood into bounded queues with deadlines, injected dispatch
    errors, corruptions and an always-failing ``vc_fused``): every served
    value verified, every error typed, every injected dispatch fault
    counted by the service.  Both runs' served values are also held
    against scipy's Dinic (:func:`launcher_vs_dinic`)."""
    from repro_torch.errors import DeadlineExceeded, Overloaded
    from repro_torch.launch import serve_maxflow
    from repro_torch.obs import REGISTRY, TRACER
    from repro_torch.serving import workload
    from repro_torch.serving.workload import synthesize

    TRACER.disable()
    TRACER.clear()
    n_req = LAUNCHER_REQUESTS[quick]
    with tempfile.TemporaryDirectory() as tmp:
        trace, snap_path = f"{tmp}/trace.json", f"{tmp}/metrics.json"
        REGISTRY.reset()
        with recording(workload, "drive") as drive_log:
            (svc, records), wall, launches = driven(torch, lambda: (
                serve_maxflow.main(["--requests", str(n_req), "--verify",
                                    "--trace-out", trace,
                                    "--metrics-out", snap_path])))
        with open(snap_path) as f:
            snap = json.load(f)
        serve_maxflow.check_artifacts(snap, trace, auto_mode=True)
    require(all(r["error"] is None for r in records),
            "the launcher's run failed a request")
    # Dinic on the served graphs runs in the pool meanwhile
    held = launcher_oracles(pool, drive_log, records, "serve_launcher")
    serve_clean(snap["stats"], snap["metrics"], "serve_launcher")
    require(any(launches[k] for k in KERNELS), "the launcher's auto run "
            "launched no kernel")
    items = synthesize(n_req, seed=0, matching_frac=0.3, repeat_frac=0.15,
                       resubmit_frac=0.2)
    overhead = serve_maxflow.measure_telemetry_overhead(
        items, dict(mode="auto", max_batch=8, cycle_chunk=16))
    st = snap["stats"]
    auto_row = {"phase": "serve_launcher", "run": "auto", "requests": n_req,
                "wall_s": wall, "launches": launches,
                "solved": st["solved"], "batches": st["batches"],
                "buckets": st["buckets"], "mode_policy": st["mode_policy"],
                "telemetry_overhead": overhead}

    REGISTRY.reset()
    with recording(workload, "drive") as drive_log:
        (svc, records), wall_c, launches_c = driven(torch, lambda: (
            serve_maxflow.main(["--requests", str(CHAOS_REQUESTS[quick]),
                                "--process", "flood", "--max-queue", "4",
                                "--deadline-ms", "5000", "--poll-every",
                                "4", "--chaos", "--chaos-fail-modes",
                                "vc_fused", "--verify"])))
    held_c = launcher_oracles(pool, drive_log, records,
                              "serve_launcher chaos")
    emit({**auto_row, "values_equal_dinic": launcher_vs_dinic(
        held, "serve_launcher")})
    held_c = launcher_vs_dinic(held_c, "serve_launcher chaos")
    errs = [r["error"] for r in records if r["error"] is not None]
    require(all(isinstance(e, (Overloaded, DeadlineExceeded)) for e in errs),
            f"an untyped error: {[type(e).__name__ for e in errs]}")
    st = svc.stats()
    fi = st["robustness"]["faults_injected"]
    counted = sum(v for k, v in REGISTRY.snapshot()["counters"].items()
                  if k.startswith("serve.dispatch_errors"))
    require(counted == fi["dispatch_errors"] + fi["mode_failures"],
            f"{counted} dispatch errors counted, {fi} injected")
    kinds = {}
    for e in errs:
        kinds[type(e).__name__] = kinds.get(type(e).__name__, 0) + 1
    emit({"phase": "serve_launcher", "run": "chaos",
          "requests": len(records), "served": len(records) - len(errs),
          "errors": kinds, "values_equal_dinic": held_c, "wall_s": wall_c,
          "launches": launches_c,
          "robustness": st["robustness"], "dispatch_errors_counted": counted})
    return {"serve_launcher[auto]": launches,
            "serve_launcher[chaos]": launches_c}


def serve_graphs(quick):
    """The serving phases' fresh instances, made in the set-up pool while
    the card works, scipy's Dinic on each, and the adversarial batches
    (:func:`adversarial_batch`) of the ones ``serve_streams`` opens
    streams on: ``(extra, policy, extra_values, policy_values,
    stream_traces, seconds)``."""
    from repro_torch.graphs.generators import washington_rlg

    bsize, psize = SIZES[quick][2], POLICY_SIZE[quick]
    t0 = time.perf_counter()
    extra = [washington_rlg(*bsize, seed=SEED + BATCH + i)
             for i in range(SERVE_FRESH - BATCH)]
    policy = [washington_rlg(*psize, seed=SEED + i)
              for i in range(POLICY_INSTANCES)]
    values = [[scipy_maxflow(g.n, g.edges, g.cap, s, t)[0]
               for g, s, t in graphs] for graphs in (extra, policy)]
    traces = [adversarial_batch(*x) for x in extra[:SERVE_STREAMS]]
    return extra, policy, *values, traces, time.perf_counter() - t0


def serving(torch, quick, bgraphs, want_b, pool, graphs_in):
    """The serving phases (their fresh instances ``graphs_in`` pending in
    the set-up pool; ``want_b``, the batch's scipy values), each driven
    with the launch counts set to 0 just before it and read just
    after."""
    bsize, psize = SIZES[quick][2], POLICY_SIZE[quick]
    t0 = time.perf_counter()
    (extra, policy, want_extra, want_policy, stream_traces,
     gen_s) = graphs_in.get()
    emit({"phase": "serve_graphs", "gen_s": gen_s,
          "setup_wait_s": time.perf_counter() - t0,
          "serve_path": f"washington_rlg({bsize[0]}, {bsize[1]}, "
          f"seed={SEED}..{SEED + SERVE_FRESH - 1})",
          "serve_policy": f"washington_rlg({psize[0]}, {psize[1]}, "
          f"seed={SEED}..{SEED + POLICY_INSTANCES - 1})"})
    from repro_torch.streaming import reroute

    t0 = time.perf_counter()
    with recording(reroute, "drain_prepared") as drain_log:
        svc, sctx, paths = serve_path(torch, bgraphs + extra,
                                      want_b + want_extra, pool, drain_log)
        sctx["stream_traces"] = stream_traces
        paths.update(serve_streams(torch, svc, sctx, pool, drain_log))
    paths.update(serve_policy(torch, policy, want_policy))
    paths.update(serve_launcher(torch, quick, pool))
    emit({"phase": "serving_done", "seconds": time.perf_counter() - t0})
    return paths


def chunk_timing(torch, run, chunk: int, per: int = 1) -> dict:
    """One engine chunk's cost a step, ``run()`` being the chunk: host
    enqueue, wall and device ms (and a cycle's, a step being ``per``
    cycles), and the device's idle share of the wall."""
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        run()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / (10 * chunk)
    dev_step = device_ms(torch, run, REPS, 100_000_000) / chunk
    return {"cycles_per_step": per,
            "host_ms_per_step": 1e3 * (t1 - t0) / (10 * chunk),
            "wall_ms_per_step": wall, "device_ms_per_step": dev_step,
            "host_ms_per_cycle": 1e3 * (t1 - t0) / (10 * chunk * per),
            "wall_ms_per_cycle": wall / per,
            "device_ms_per_cycle": dev_step / per,
            "device_idle_share": max(0.0, 1 - dev_step / wall)}


def no_launches(counts, what):
    """This path launches no kernel: every count stayed 0."""
    require(not any(counts.values()), f"{what} launched a kernel: {counts}")


def distributed_path(torch, problem, small, want, want_small, main):
    """Phase ``distributed_path``: the distributed backend on a one-rank
    NCCL group opened in this process.  ``Solver(backend="distributed")``
    on ``problem`` (the batched path's first graph) against
    scipy's Dinic (``want``); the three exchanges on the ``small``
    problem (``washington_rlg`` at ``DIST_SIZE``), each against Dinic
    (``want_small``) and all three ending in the same state; no kernel
    launched; one engine chunk of steps in each exchange and one of
    relabel sweeps with no host sync, and each step's time, on the
    ``main`` problem (the main graph).  The launcher under torchrun runs
    later, beside the other processes of their own
    (:func:`launcher_start`)."""
    import torch.distributed as dist

    from repro_torch.api import Solver
    from repro_torch.core import distributed as D

    dev = torch.device("cuda", 0)
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1, device_id=dev)
        try:
            sol, wall, paths["distributed"] = driven(
                torch, lambda: Solver(
                    backend="distributed", mode="vc",
                    global_relabel_cadence=DIST_CADENCE).solve(problem))
            no_launches(paths["distributed"], "the distributed solve")
            st = sol.stats
            emit({"phase": "distributed_path", "backend": "distributed",
                  "n": problem.graph.n,
                  "group": f"{dist.get_backend()}, world size "
                  f"{dist.get_world_size()}", "wall_s": wall,
                  "value": sol.value, "scipy_value": want,
                  "supersteps": st.rounds, "steps": st.cycles,
                  "gr_sweeps": st.gr_sweeps,
                  "launches": paths["distributed"]})
            require(sol.value == want,
                    f"distributed value {sol.value} != scipy Dinic {want}")

            r = small.residual("bcsr")
            outs = {}
            for mode in D.MODES:
                out, wall, counts = driven(
                    torch, lambda mode=mode: D.distributed_solve_impl(
                        r, small.s, small.t, mode=mode,
                        cycles=DIST_CADENCE))
                no_launches(counts, f"the {mode} exchange")
                paths[f"distributed[{mode}]"] = counts
                outs[mode] = (out, D.gather_res(out.res, out.meta))
                emit({"phase": "distributed_modes", "mode": mode,
                      "wall_s": wall, "value": out.value,
                      "scipy_value": want_small,
                      "supersteps": out.supersteps,
                      "steps": out.supersteps * DIST_CADENCE,
                      "gr_sweeps": out.gr_sweeps})
                require(out.value == want_small,
                        f"{mode} value {out.value} != scipy Dinic "
                        f"{want_small}")
            base, base_res = outs["replicated"]
            for mode, (out, res) in outs.items():
                require(out.supersteps == base.supersteps
                        and out.gr_sweeps == base.gr_sweeps
                        and torch.equal(res, base_res)
                        and torch.equal(out.h, base.h)
                        and torch.equal(out.e, base.e),
                        f"the {mode} exchange ends elsewhere than the "
                        "replicated one")
            distributed_steps(torch, dev, main)
        finally:
            dist.destroy_process_group()
    return paths


def start_proc(cmd):
    """``cmd`` started from the checkout's root with its ``src`` on the
    path, in a session of its own (so that :func:`finish_proc` can kill
    every process it starts), its output piped: ``(proc, cmd, t0)``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    return proc, cmd, time.perf_counter()


def finish_proc(started):
    """Waits for a :func:`start_proc` process, at most
    ``SUBPROCESS_TIMEOUT`` seconds from its start (past that it raises),
    and kills its whole process group on the way out: ``(returncode,
    stdout, stderr, seconds from its start until it was collected)``."""
    proc, _, t0 = started
    try:
        out, err = proc.communicate(timeout=max(
            1.0, SUBPROCESS_TIMEOUT - (time.perf_counter() - t0)))
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    return proc.returncode, out, err, time.perf_counter() - t0


def launcher_start(side):
    """The launcher's card branch in a process group of its own: one
    rank under ``torch.distributed.run --standalone``, which initialises
    NCCL from ``env://`` on ``LOCAL_RANK``'s card, solving
    ``washington_rlg(side, side, seed=SEED)`` at ``DIST_CADENCE``.
    Its own ``--verify`` (the port's pure-Python Dinic) is left off:
    scipy's is the oracle here (:func:`distributed_launcher`)."""
    return start_proc([
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc-per-node", "1", "-m", "repro_torch.launch.maxflow",
        "--backend", "distributed", "--generator", "washington",
        "--vertices", str(side * side), "--seed", str(SEED),
        "--cycle-chunk", str(DIST_CADENCE)])


def distributed_launcher(started, want_small):
    """Phase ``distributed_launcher``: the :func:`launcher_start` run's
    printed value against scipy's Dinic (``want_small``), on the card."""
    rc, out, err, wall = finish_proc(started)
    found = re.search(r"^V=.* device=(\S+) maxflow=(\d+) .*$", out, re.M)
    require(rc == 0 and found is not None,
            f"the launcher under torchrun failed (rc {rc}): "
            f"{out[-1000:]} {err[-3000:]}")
    device, value = found.group(1), int(found.group(2))
    emit({"phase": "distributed_launcher",
          "command": " ".join(started[1][1:]), "collected_s": wall,
          "device": device, "value": value, "scipy_value": want_small,
          "printed": found.group(0)})
    require(device.startswith("cuda"),
            f"the launcher ran on {device}, not the card")
    require(value == want_small,
            f"the launcher's value {value} != scipy Dinic {want_small}")


def distributed_steps(torch, dev, problem):
    """On the main graph's one-rank partition at a mid-solve state (exact
    labels, then 256 steps): one engine chunk of steps in each exchange
    (at one rank a slab is the whole residual) and one of relabel sweeps
    run with no host sync, launch no kernel and agree; then each one's
    time a step, and last its costliest device operations."""
    import dataclasses
    from unittest import mock

    import torch.distributed as dist

    from repro_torch.core import distributed as D
    from repro_torch.core import engine

    r = problem.residual("bcsr")
    chunk = engine.DEFAULT_CHUNK
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def counted(step):
        return lambda c: (*step(*c[:3]), c[3] + 1)

    slabs, meta, res0 = D.partition_graph(r, 1, problem.s, problem.t)
    g = slabs[0].to(dev)
    res, h, e = D.initial_state(slabs, meta, res0, 0, dev)
    h = D.make_dist_global_relabel(meta, g)(res, h, e)[0]
    res, h, e, _ = engine.run_bulk_loop(
        counted(D.make_dist_step(meta, g)), (res, h, e, zero),
        cond_fn=lambda c: c[3] < 256)
    sweep = D.make_gr_sweep(meta, g)
    dist0 = engine.fill_at(torch.full((meta.n,), D.INF, dtype=torch.int32,
                                      device=dev), problem.t, 0)
    loops = {"gr_sweep": engine.fixpoint_loop(lambda x: sweep(res, x), dist0,
                                              cap=2**30)}
    for mode in D.MODES:
        step = D.make_dist_step(dataclasses.replace(meta, mode=mode), g)
        loops[f"dist_step[{mode}]"] = (counted(step), lambda c: c[3] < 2**30,
                                       (res, h, e, zero))
    torch.cuda.synchronize()
    reset_counts()
    done = {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name, (step, cond, carry) in loops.items():
            done[name] = engine.run_chunk(step, carry, cond_fn=cond,
                                          chunk=chunk)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    no_launches(launch_counts(), "a distributed chunk")
    for name, out in done.items():
        require(int(out[-1]) == chunk,
                f"the sync-free {name} chunk did not run its steps")
    base = done["dist_step[replicated]"]
    for mode in D.MODES:
        require(all(torch.equal(a, b) for a, b in zip(
            done[f"dist_step[{mode}]"], base)),
            f"the {mode} exchange's chunk ends elsewhere")
    emit({"phase": "distributed_no_host_sync", "ok": True, "chunk": chunk,
          "loops": list(loops)})
    rows = []
    for name, (step, cond, carry) in loops.items():
        def run(step=step, cond=cond, carry=carry):
            return engine.run_chunk(step, carry, cond_fn=cond, chunk=chunk)

        rows.append((run, {"phase": "distributed_step_timing", "loop": name,
                           **chunk_timing(torch, run, chunk)}))
    # a sweep's all-reduce alone on its (n,) int32 candidates, and the
    # sweep without it (at one rank the all-reduce is the identity, so
    # the stubbed sweep computes the same labels)
    cand = dist0.clone()

    def all_reduce_min():
        for _ in range(chunk):
            dist.all_reduce(cand, op=dist.ReduceOp.MIN)

    def all_reduce_fresh():
        for _ in range(chunk):
            dist.all_reduce(torch.full_like(cand, D.INF),
                            op=dist.ReduceOp.MIN)

    emit({"phase": "distributed_step_timing",
          "loop": "all_reduce[MIN] of the (n,) candidates, alone",
          **chunk_timing(torch, all_reduce_min, chunk)})
    emit({"phase": "distributed_step_timing",
          "loop": "all_reduce[MIN] of a fresh (n,) tensor each call",
          **chunk_timing(torch, all_reduce_fresh, chunk)})
    step, cond, carry = loops["gr_sweep"]
    with mock.patch.object(dist, "all_reduce", lambda *a, **k: None):
        emit({"phase": "distributed_step_timing",
              "loop": "gr_sweep, its all-reduce stubbed out",
              **chunk_timing(torch, lambda: engine.run_chunk(
                  step, carry, cond_fn=cond, chunk=chunk), chunk)})
    # the profiler last, so that no host timing follows a profiled window
    for run, row in rows:
        ops = top_device_ops(torch, run, chunk, top=None)
        emit({**row, "top_device_us_per_step": dict(list(ops.items())[:6]),
              "nccl_device_us_per_step": sum(
                  v for k, v in ops.items() if "nccl" in k.lower()),
              "profiled_device_us_per_step": sum(ops.values())})


#: ops whose count a step differs by between the main graph and the small
#: fixture, each on a branch of a static shape: none so far
STATIC_SHAPE_BRANCHES: dict[str, str] = {}


def analysis_start(out):
    """``python -m repro_torch.launch.analyze --device cuda --smoke``
    started in a process of its own (:func:`start_proc`), its record
    written to ``out``."""
    return start_proc([sys.executable, "-m", "repro_torch.launch.analyze",
                       "--device", "cuda", "--smoke", "--out", str(out),
                       "--root", str(ROOT)])


def analysis_phase(torch, started, out, loops, minh_fn, graph):
    """Phase ``analysis``: the :func:`analysis_start` process (every
    surface's census under sync-debug "error", its launches against the
    wrappers' counters, its chunk captured into a CUDA graph; its record
    in ``out``) must find 0 violations and 0 lint findings; then one
    chunk of each of ``step_timing``'s ``loops``
    at the main graph's (``graph``) mid-solve state under the census and
    sync-debug
    "error", whose kernel launches a step must equal the same loops' on
    the analysis fixture, and whose aten ops a step must too, but for ops
    listed in ``STATIC_SHAPE_BRANCHES``."""
    from collections import Counter

    from repro_torch.analysis import baselines, surfaces
    from repro_torch.core import engine

    t0 = time.perf_counter()
    rc, stdout, stderr, wall = finish_proc(started)
    require(rc == 0, f"the analyzer failed on the card:\n{stdout[-3000:]}"
            f"\n{stderr[-3000:]}")
    payload = json.loads(out.read_text())
    summary = payload["summary"]
    require(summary["surfaces_traced"] == 25
            and summary["surfaces_clean"] == 25
            and summary["rule_violations"] == 0
            and summary["lint_findings"] == 0,
            f"the analyzer's summary on the card: {summary}")
    per_surface = {}
    for name, rec in payload["surfaces"].items():
        counts = rec["launch_counts"]
        require(counts is not None and counts["census"] == counts["counters"],
                f"{name}: census launches != .launches deltas: {counts}")
        c = rec["census"]
        per_surface[name] = {
            "ops_per_step": c["ops_per_step"], "steps": c["loop_shape"]
            ["steps"], "launches": c["launches"],
            "capturable": rec["capturable"],
            "capture_error": c["capture_error"]}
    emit({"phase": "analysis", "what": "surfaces", "device":
          payload["device_name"], "summary": summary, "collected_s": wall,
          "wait_s": time.perf_counter() - t0, "surfaces": per_surface,
          "baselines": payload["baselines"]})

    t1 = time.perf_counter()
    chunk = engine.DEFAULT_CHUNK
    g, meta, state, s, t, _, _ = surfaces.single_fixture("bcsr", "cuda")
    tiny = baselines.step_loops(g, meta, state, s, t, minh_fn)
    rows = {}
    for name, (step, cond, make_carry, gated) in loops.items():
        got = {}
        for size, (st, cd, mk, gt) in (("full", (step, cond, make_carry,
                                                 gated)),
                                       ("small", tiny[name])):
            carry = mk()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got[size] = baselines.chunk_census(st, cd, carry, chunk, gt)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        full, small = got["full"], got["small"]
        require(not full.host_calls, f"{name}: host calls in a chunk: "
                f"{full.host_calls}")
        require(full.launches_by_kernel() == small.launches_by_kernel(),
                f"{name}: launches a chunk {full.launches_by_kernel()} at "
                f"full width, {small.launches_by_kernel()} small")
        diff = Counter(full.op_counts)
        diff.subtract(small.op_counts)
        diff = {op: n for op, n in diff.items() if n}
        require(set(diff) <= set(STATIC_SHAPE_BRANCHES),
                f"{name}: ops a chunk differ from the small fixture's "
                f"by {diff}")
        rows[name] = {"ops_per_step": full.ops_per_step(),
                      "small_ops_per_step": small.ops_per_step(),
                      "launches_per_step": full.kernel_call_count / chunk,
                      "kernel_ops_per_step": full.kernel_op_count / chunk,
                      "op_differences": diff}
    emit({"phase": "analysis", "what": "full_width_chunks",
          "graph": graph, "small": "random_sparse(24, 96, seed=7)",
          "chunk": chunk, "loops": rows,
          "seconds": time.perf_counter() - t1})
    return time.perf_counter() - t0


#: the instances the int32 lattice cannot hold, ``(n, edges, caps)`` from
#: 0 to n - 1, and the error each entry must raise: a capacity past
#: int32, an out-capacity of the source past it, a negative capacity
OVERFLOW_GRAPHS = {
    "capacity_2**33": (3, [[0, 1], [1, 2]], [2**33, 5], "OverflowError"),
    "source_out_2**32-2": (4, [[0, 1], [0, 2], [1, 3], [2, 3]],
                           [2**31 - 1] * 4, "OverflowError"),
    "negative": (3, [[0, 1], [1, 2]], [-1, 5], "ValueError"),
}
#: an instance exactly at the bound: source out-capacity 2**31 - 1
AT_BOUND = (4, [[0, 1], [0, 2], [1, 3], [2, 3]],
            [2**30, 2**30 - 1, 2**31 - 1, 2**31 - 1])


def overflow_phase(torch, problems):
    """Phase ``overflow``: each of ``OVERFLOW_GRAPHS`` raises its error
    through ``Solver.solve`` on the card, single and batched, in every
    mode, and through ``MaxflowService.submit`` (before any flush); and
    ``AT_BOUND`` solves on the card to Dinic's value in every mode, single
    and batched, its flows and min cut agreeing.  Also the host time of
    one check on each of ``problems`` (name -> problem; median of 5): a
    served instance is checked at submit and again in each flush that
    packs it."""
    import numpy as np

    from repro_torch.api import MaxflowProblem, Solver
    from repro_torch.core import pushrelabel as pr
    from repro_torch.core.csr import Graph
    from repro_torch.core.ref_maxflow import dinic_maxflow
    from repro_torch.serving import MaxflowService, ServiceConfig

    def graph(n, edges, caps):
        return Graph(n, np.array(edges, np.int64), np.array(caps, np.int64))

    modes = pr.ALL_MODES
    refused = {}
    for name, (n, edges, caps, err) in OVERFLOW_GRAPHS.items():
        g = graph(n, edges, caps)
        problem = MaxflowProblem(g, 0, n - 1)
        calls = {f"{b}/{m}": (lambda b=b, m=m: Solver(backend=b, mode=m)
                              .solve(problem))
                 for b in ("single", "batched") for m in modes}
        calls["service.submit"] = lambda g=g, n=n: MaxflowService(
            ServiceConfig(mode="vc_fused")).submit(g, 0, n - 1)
        for what, call in calls.items():
            try:
                call()
            except (OverflowError, ValueError) as exc:
                require(type(exc).__name__ == err,
                        f"{name} via {what}: {type(exc).__name__}, not {err}")
            else:
                raise AssertionError(f"{name} via {what} did not raise {err}")
        refused[name] = {"error": err, "entries": len(calls)}
    g = graph(*AT_BOUND)
    problem = MaxflowProblem(g, 0, g.n - 1)
    want = dinic_maxflow(g, 0, g.n - 1)
    values = {}
    for b in ("single", "batched"):
        for m in modes:
            sol = Solver(backend=b, mode=m).solve(problem)
            require(sol.state.res.is_cuda, f"at the bound, {b}/{m} ran off "
                    "the card")
            require(sol.value == want == sol.min_cut().value,
                    f"at the bound, {b}/{m} gives {sol.value}, Dinic {want}")
            values[f"{b}/{m}"] = sol.value
    check_ms = {}
    for name, p_ in problems.items():
        r = p_.residual("bcsr")
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            pr.check_capacity_range(r, p_.s)
            walls.append(1e3 * (time.perf_counter() - t0))
        check_ms[name] = {"arcs": r.num_arcs,
                          "median_ms": statistics.median(walls)}
    emit({"phase": "overflow", "refused": refused, "at_bound_dinic": want,
          "at_bound_values": values, "check_host_ms": check_ms})


def dryrun_phase(torch, smi):
    """Phase ``dryrun``: ``python -m repro_torch.launch.dryrun --all
    --arch wbpr-maxflow --both-meshes --fresh`` on the card in a process of its own, its 12
    cells (2 graph scales x 2 production meshes x 3 exchanges) one after
    another, each one rank of the mesh under a fake process group.  One
    line a record, with the card's name and power limit; each record's
    meta must be the cell's, its step's and sweep's by-op collective bytes
    those of the collectives' formulas for its shapes, no kernel launched,
    and its device times taken on the card."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch import shapes as SH
    from repro_torch.launch.mesh import production_mesh

    out_dir = ROOT / "experiments" / "dryrun_torch"
    rc, stdout, stderr, wall = finish_proc(start_proc([
        sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
        "--arch", "wbpr-maxflow", "--both-meshes", "--fresh", "--out-dir",
        str(out_dir)]))
    errs = {p.name: p.read_text()[-2000:] for p in out_dir.glob("*.err")}
    require(rc == 0, f"the dry run failed (rc {rc}): {stdout[-2000:]}"
            f" {stderr[-2000:]} {errs}")
    cfg = registry.get_config("wbpr-maxflow")
    n_rec = 0
    for cell in SH.cells_for(cfg):
        for mp in (False, True):
            mesh = production_mesh(mp)
            for mode in dryrun.GRAPH_MODES:
                path = out_dir / dryrun.record_name(
                    "wbpr-maxflow", cell.name, mesh.tag, mode)
                require(path.exists(), f"no dry-run record {path.name}")
                rec = json.loads(path.read_text())
                meta, shapes = dryrun._graph_specs(cell, mesh, mode)
                require(rec["meta"] == dataclasses.asdict(meta)
                        and rec["shard_shapes"] == {
                            k: list(v) for k, v in shapes.items()}
                        and rec["devices"] == mesh.size,
                        f"{path.name}: meta {rec['meta']} is not the cell's")
                want = dryrun.expected_collectives(meta)
                for it in ("step", "gr_sweep"):
                    got = rec["per_iter"][it]
                    require(got["collectives"]["by_op"] == want[it],
                            f"{path.name}: {it} collectives "
                            f"{got['collectives']['by_op']} != {want[it]}")
                    require(got["launches"] == 0,
                            f"{path.name}: the {it} launched a kernel")
                    require(got["device_ms"] is not None,
                            f"{path.name}: no device time for the {it}")
                require(rec["full"]["kernel_launches"] == 0,
                        f"{path.name}: the cell launched a kernel")
                require(rec["device"] == "cuda",
                        f"{path.name} ran on {rec['device']}")
                mem = rec["full"]["memory"]
                step, sweep = rec["per_iter"]["step"], rec["per_iter"][
                    "gr_sweep"]
                print(f"{smi} | {path.stem}: state {mem['state_bytes']} B, "
                      f"peak {mem['peak_allocated_bytes']} B; step "
                      f"{step['device_ms']} ms ({step['aten_ops']} ops, "
                      f"{step['collectives']['total_bytes']} B wire); sweep "
                      f"{sweep['device_ms']} ms; superstep "
                      f"{rec['full']['superstep']['wall_s']} s", flush=True)
                emit({"phase": "dryrun_record", "record": path.name,
                      "nvidia_smi": smi, "memory": mem,
                      "superstep": rec["full"]["superstep"],
                      "step": rec["per_iter"]["step"],
                      "gr_sweep": rec["per_iter"]["gr_sweep"],
                      "extrapolated": rec["extrapolated"],
                      "active_on_rank": rec["graph"]["active_on_rank"]})
                n_rec += 1
    emit({"phase": "dryrun", "records": n_rec, "wall_s": wall,
          "cells": stdout.strip().splitlines()})


#: the examples, each verifying itself: the max-flow ones against Dinic,
#: the LM serving one its caches against teacher forcing, the LM training
#: one its loss and its resumed run
EXAMPLES = ("quickstart_torch.py", "bipartite_matching_torch.py",
            "serve_maxflow_torch.py", "serve_decode_torch.py",
            "train_lm_torch.py")


def examples_start():
    """Each of ``EXAMPLES`` started on the card (its default device), in
    a process of its own (:func:`start_proc`)."""
    return {name: start_proc([sys.executable, str(ROOT / "examples" / name)])
            for name in EXAMPLES}


def examples_phase(started):
    """Phase ``examples``: each :func:`examples_start` process exits 0
    having verified itself on the card."""
    for name, one in started.items():
        rc, out, err, wall = finish_proc(one)
        require(rc == 0 and "verified" in out and "cuda" in out,
                f"examples/{name} failed on the card (rc {rc}): "
                f"{out[-1500:]} {err[-2000:]}")
        emit({"phase": "examples", "example": name, "collected_s": wall,
              "last_lines": out.strip().splitlines()[-2:]})


def lm_phase(torch, quick: bool, smi: str) -> None:
    """Phase ``lm_serve``: one row a family of
    ``repro_torch.launch.lm_serve_checks.ROWS`` at full width, B = 4 —
    qwen3-4b and rwkv6-1.6b and whisper-tiny whole, mixtral-8x7b at 16 of
    32 layers, llama-3.2-vision-90b at 10 of 100 — each built and checked
    against its specs and element count, served through
    ``launch/serve.main --census`` (the decode loop under
    ``set_sync_debug_mode("error")``, no host read in a step; each
    figure beside the family's bound), held in float32 with TF32 off
    (prefill against the train forward's last position, decode against
    one teacher-forced forward; rwkv6 in float64; llama-vision on 5
    layers; mixtral on a 4-layer cut at B = 1 in float64, its decode
    chain at
    ``capacity_factor`` = ``n_experts`` = 8; whisper, mixtral and
    llama-vision at unit gain, each row's ``gain`` and ``hold_dtype``)
    and a cut run on the card against the CPU in float32 (at the row's
    gain); then jamba-1.5-large-398b's
    ``mamba+mlp`` layer at full width (``lm_serve_checks.mamba_layer``:
    B = 4 x 2048 prefilled, 64 steps decoded, held in float32 and
    against the CPU) and its SMOKE config served whole on the card.  The
    LM path launches none of the kernels; ``--quick`` runs the SMOKE
    configs."""
    from repro_torch.launch import lm_serve_checks as C

    def out(row):
        emit({**row, "nvidia_smi": smi})

    torch.cuda.empty_cache()
    reset_counts()
    for arch, row in C.ROWS.items():
        t0 = time.perf_counter()
        if quick:  # SMOKE, each row's draw, dtype and cut kind; 64 + 64
            keep = ("gain", "hold_dtype", "cut_pattern")
            C.run(out, arch=arch, smoke=True, batch=2, prompt_len=64,
                  tokens=64, **{k: v for k, v in row.items() if k in keep})
        else:
            C.run(out, arch=arch, batch=4, **row)
        emit({"phase": "lm_row_done", "arch": arch,
              "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    if quick:
        C.mamba_layer(out, smoke=True, batch=2, prompt_len=64, tokens=64)
    else:
        C.mamba_layer(out, expect_params=C.MAMBA_PARAMS)
    emit({"phase": "lm_row_done", "arch": C.MAMBA_ARCH,
          "seconds": time.perf_counter() - t0})
    no_launches(launch_counts(), "the LM path")
    torch.cuda.empty_cache()


def train_phase(torch, quick: bool, smi: str) -> None:
    """Phase ``train``: ``repro_torch.launch.train_checks.run`` — the rows
    of its ``ROWS`` at full width (qwen3-4b whole with AdamW, jamba's
    ``mamba+mlp`` layer with Adafactor, mixtral-8x7b cut to 1 layer),
    qwen3-4b cut to 1 layer on the card against the CPU in float32, and
    the fault-injected restart; ``--quick`` runs the SMOKE configs.  The
    training path launches none of the kernels."""
    from repro_torch.launch import train_checks

    torch.cuda.empty_cache()
    reset_counts()
    train_checks.run(lambda row: emit({**row, "nvidia_smi": smi}),
                     smoke=quick)
    no_launches(launch_counts(), "the training path")
    torch.cuda.empty_cache()


def sharded_phase(torch, quick: bool, smi: str) -> None:
    """Phase ``lm_sharded``: ``repro_torch.launch.sharded_checks.run`` —
    one rank at full width of the multi-device LM, under the fake group
    with its real shards on the card, or on a one-rank NCCL group:
    qwen2-72b ``decode_32k`` at 16x16 (80 layers; the cache's local
    shapes, where the writes land, finite logits), qwen3-4b ``train_4k``
    at 16x16 (the 1/2-superblock extrapolation equal to the whole run),
    GPipe at ``stages=1`` against ``value_and_grad`` and stage 1 of 4,
    ``hierarchical_pod_psum`` bit-equal to the CPU's, then the families'
    1-superblock train cells while the budget lasts; ``--quick`` runs the
    SMOKE configs.  It launches none of the kernels."""
    from repro_torch.launch import sharded_checks

    torch.cuda.empty_cache()
    reset_counts()
    sharded_checks.run(lambda row: emit({**row, "nvidia_smi": smi}),
                       smoke=quick)
    no_launches(launch_counts(), "the multi-device LM path")
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="rehearse on small graphs; prints no result")
    args = ap.parse_args(argv)
    (rows, cols), _, bsize = SIZES[args.quick]

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
    from repro_torch.graphs.generators import bipartite_random

    # every phase's host inputs are made in a set-up pool while the device
    # starts, the kernels build and the card works: first the main graph
    # (with its adversarial batch) and the batch's, then the stream's
    # 512x512 graph (with its Dinics), the matching's and the serving
    # graphs (with theirs); leaving the block terminates both processes
    side = MATCHING_SIDE[args.quick]
    with multiprocessing.get_context("spawn").Pool(2) as setup:
        made = {"main": setup.apply_async(
                    timed_call, (main_graph, rows, cols)),
                "batch": setup.apply_async(
                    timed_call, (batch_graphs, bsize)),
                "mid": setup.apply_async(mid_inputs, (MID_SIZE[args.quick],)),
                "matching": setup.apply_async(timed_call, (
                    bipartite_random, side, side),
                    {"avg_deg": 8.0, "seed": SEED}),
                "serve": setup.apply_async(serve_graphs, (args.quick,))}
        return smoke(args, torch, t_start, made)


def smoke(args, torch, t_start, made) -> int:
    """Every phase, in order, with ``made`` the host inputs pending in the
    set-up pool."""
    (rows, cols), small, bsize = SIZES[args.quick]

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

    from repro_torch.analysis import baselines
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

    # -- 3c. LM serving, while the set-up pool makes the main graph ---------
    t0 = time.perf_counter()
    lm_phase(torch, args.quick, smi)
    lm_s = time.perf_counter() - t0
    emit({"phase": "lm_serve_done", "seconds": lm_s})
    t0 = time.perf_counter()
    train_phase(torch, args.quick, smi)
    emit({"phase": "train_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    sharded_phase(torch, args.quick, smi)
    emit({"phase": "lm_sharded_phase_done",
          "seconds": time.perf_counter() - t0})

    # -- 4. the main path at full size --------------------------------------
    t0 = time.perf_counter()
    ((graph, s, t), drain_batch), t_gen = made["main"].get()
    t_wait = time.perf_counter() - t0
    t0 = time.perf_counter()
    problem = MaxflowProblem(graph, s, t)
    r = problem.residual("bcsr")
    t_csr = time.perf_counter() - t0
    emit({"phase": "main_graph", "graph": f"washington_rlg({rows}, "
          f"{cols}, seed={SEED})", "n": r.n, "edges": graph.m,
          "arcs": r.num_arcs, "deg_max": r.deg_max, "gen_s": t_gen,
          "setup_wait_s": t_wait, "csr_s": t_csr})
    t0 = time.perf_counter()
    (bgraphs, btraces), t_bgen = made["batch"].get()
    t_bwait = time.perf_counter() - t0
    batch = [MaxflowProblem(*bg_) for bg_ in bgraphs]
    for p_ in batch:
        p_.residual("bcsr")
    emit({"phase": "batch_graphs", "graph": f"washington_rlg({bsize[0]}, "
          f"{bsize[1]}, seed={SEED}..{SEED + BATCH - 1})",
          "n": [p_.residual("bcsr").n for p_ in batch],
          "arcs": [p_.residual("bcsr").num_arcs for p_ in batch],
          "gen_s": t_bgen, "setup_wait_s": t_bwait,
          "csr_s": time.perf_counter() - t0 - t_bwait})
    # scipy's Dinic takes minutes at the main graph's size: it runs in a
    # process of its own while the card solves, and a second process
    # solves the batched instances and the exchanges' graph; leaving the
    # block terminates both oracle processes
    dist_graph = washington_rlg(*DIST_SIZE[args.quick], seed=SEED)
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        oracles = [pool.apply_async(scipy_maxflow, (graph.n, graph.edges,
                                                    graph.cap, s, t))]
        oracles += [pool.apply_async(scipy_maxflow, (g_.n, g_.edges, g_.cap,
                                                     s_, t_))
                    for g_, s_, t_ in bgraphs]
        dist_oracle = pool.apply_async(scipy_maxflow, (
            dist_graph[0].n, dist_graph[0].edges, dist_graph[0].cap,
            *dist_graph[1:]))
        paths, ctx = main_path_and_modes(small, torch, problem, batch,
                                         oracles)
        # the main solve's wall measures this host: the LM phase's beside
        # it, so that a run on another host can be scaled
        emit({"phase": "lm_scale", "lm_serve_s": lm_s,
              "main_solve_s": ctx["main_wall_s"]})
        ctx.update(drain_batch=drain_batch, batch_traces=btraces,
                   mid_in=made["mid"], matching_in=made["matching"],
                   serve_in=made["serve"])
        views_and_modes(args.quick, torch, problem, ctx, paths)
        paths.update(serving(torch, args.quick, bgraphs,
                             ctx["batch_values"], pool, made["serve"]))
        main_oracle(ctx, oracles[0])
        want_dist = dist_oracle.get()[0]
    # -- 5c. the distributed backend, on a one-rank NCCL group ---------------
    t0 = time.perf_counter()
    paths.update(distributed_path(torch, batch[0],
                                  MaxflowProblem(*dist_graph),
                                  ctx["batch_values"][0], want_dist, problem))
    emit({"phase": "distributed_done", "seconds": time.perf_counter() - t0})
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
    drains = drain_loops(torch, ctx, minh_fn)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name, (d_step, d_cond, d_carry) in list(drains.items()):
            drains[name] = (d_carry, engine.run_chunk(
                d_step, d_carry, cond_fn=d_cond, chunk=chunk))
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
    for name, (d0, d1) in drains.items():
        require(int(d1[2]) == chunk if "sweep" in name
                else not torch.equal(d0[1], d1[1]),
                f"the sync-free {name} chunk did not run its steps")
    emit({"phase": "no_host_sync", "ok": True, "chunk": chunk,
          "loops": ["sweep[kernel]", "cycle[vc_kernel_bsearch]",
                    "cycle[vc_fused]", "batched cycle[vc_fused]",
                    "batched cycle[vc_kernel_bsearch]",
                    "phase-2 cancel[kernel]", "cycle[tc]",
                    "batched cycle[tc]", *drains]})
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
    loops = baselines.step_loops(g, meta, state, s, t, minh_fn)
    chunk = engine.DEFAULT_CHUNK
    timed = []
    for name, (step, cond, make_carry, gated) in loops.items():
        carry = (iter([make_carry() for _ in range(13 + REPS)]).__next__
                 if gated else make_carry)

        def run(step=step, cond=cond, carry=carry, gated=gated):
            return engine.run_chunk(step, carry(), cond_fn=cond, chunk=chunk,
                                    pass_gate=gated)

        # a vc_fused step is one launch of K cycles; the rest one cycle
        per = K_DEFAULT if name == "cycle[vc_fused]" else 1
        timed.append((run, {"phase": "step_timing", "loop": name,
                            **chunk_timing(torch, run, chunk, per)}))
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

    # -- 8. the processes of their own that time nothing run at once: the
    # analyzer, the distributed launcher under torchrun and the examples;
    # meanwhile the full-width chunks under the census and the capacities
    # outside int32; then the dry run and LM serving, each alone, as both
    # time the card
    checked = {f"washington_rlg({rows}, {cols})": problem,
               f"washington_rlg({bsize[0]}, {bsize[1]})": batch[0]}
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "ANALYSIS_torch.json"
        started = {"analysis": analysis_start(out),
                   "launcher": launcher_start(DIST_SIZE[args.quick][0]),
                   "examples": examples_start()}
        try:
            for name, phase in (
                    ("analysis", lambda: analysis_phase(
                        torch, started["analysis"], out, loops, minh_fn,
                        f"washington_rlg({rows}, {cols}, seed={SEED}), "
                        "mid-solve")),
                    ("overflow", lambda: overflow_phase(torch, checked)),
                    ("distributed_launcher", lambda: distributed_launcher(
                        started["launcher"], want_dist)),
                    ("examples", lambda: examples_phase(
                        started["examples"]))):
                t0 = time.perf_counter()
                phase()
                emit({"phase": f"{name}_done",
                      "seconds": time.perf_counter() - t0})
        finally:
            for one in (started["analysis"], started["launcher"],
                        *started["examples"].values()):
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(one[0].pid, signal.SIGKILL)
                one[0].wait()
    t0 = time.perf_counter()
    dryrun_phase(torch, smi)
    emit({"phase": "dryrun_done", "seconds": time.perf_counter() - t0})

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
