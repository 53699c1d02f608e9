"""Multi-pod dry run, the max-flow half (port of the graph cells of the
JAX package's ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch wbpr-maxflow --shape graph_128m
    python -m repro_torch.launch.dryrun --arch wbpr-maxflow --shape graph_16m \\
        --multi-pod --graph-mode sharded --device cpu
    python -m repro_torch.launch.dryrun --all --both-meshes   # 12 records

One cell is one graph scale (``launch/shapes.py``'s ``GRAPH_SHAPES``) on
one production mesh (16x16 or 2x16x16, ``launch/mesh.py``) in one
exchange of the distributed superstep (``replicated``, ``sharded``,
``sparse``; ``core/distributed.py``).  The reference lowers and compiles
the whole mesh's superstep for 512 fake XLA host devices.  Eager PyTorch
compiles nothing, so the port RUNS one rank of it instead: under
``mesh.fake_world`` this process is rank :data:`RANK` (which holds
neither the source nor the sink) of the mesh's 256 or 512 ranks, with
that rank's real slab and state on the card (or the CPU with ``--device
cpu``), and the fake group's collectives returning at once.

The rank's slab is one rank's part of a synthetic regular graph, built
alone, without the whole graph: a circulant graph in which every vertex
has degree ``d = amax / vs`` (8 in every cell), arc ``(v, k)`` goes to
``(v + o_k) mod n`` over paired offsets ``o_{2j+1} = -o_{2j}`` with
``o_{2j} = b^j`` and ``b = ceil(n^(2/d))``, its reverse is arc ``(v + o_k,
k ^ 1)``, and the global id of arc ``(v, k)`` is ``owner(v) amax +
local(v) d + k``.  Any two vertices are about ``d/2 * floor(b/2)`` arcs
apart at most (balanced base-``b`` digits; exactly so where ``b^(d/2) =
n``, as at ``n = 2^24``, 128), and the largest offsets cross ranks.
Residual capacities (1 to :data:`MAX_CAP`), heights (below
:data:`MAX_H`) and a mid-solve excess on a share :data:`EXCESS_SHARE` of
the vertices come from ``--seed``, so the step has active lanes.

Each cell writes one JSON record to
``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__<mode>].json`` with
the reference's fields where they mean the same thing (``arch``,
``shape``, ``mesh``, ``devices``, ``kind``, ``graph_mode``, ``skipped``,
``analytic``, ``per_iter.step`` / ``per_iter.gr_sweep`` with their
``collectives`` = ``{total_bytes, by_op, counts}``, and
``extrapolated.collective_bytes`` = 64 steps + 24 sweeps), and what a run
adds: under ``full.memory`` the rank's state bytes and, on the card, the
peak allocated across one superstep; a step's and a sweep's aten ops and
kernel launches (the op census, ``analysis/ir.py``); their device ms on
the card (CUDA events, median of :data:`REPS`) and host-clock ms on both;
and the wall of one superstep.

What the fake group hides: no byte crosses a wire, so no wire time is
measured, only the bytes each collective would move
(``analysis/collectives.py``); and the relabel's all-reduce of MIN
combines nothing, so its sweep count is this rank's local fixpoint, not
the mesh's.  XLA's ``flops``, ``bytes_accessed`` and lower / compile
times have no eager counterpart and are left out, not estimated.

The language-model cells wait for the rest of the LM port (ROADMAP.md,
Queue 1 items 4-6: training, and the sharding rules with the LM cells;
every mixer runs since item 3): an arch of a language-model family raises
``NotImplementedError``, and ``--all`` covers the ``graph`` family
(``wbpr-maxflow``) only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[3]
OUT_DIR = REPO / "experiments" / "dryrun_torch"
#: the rank this process plays: it holds neither s = 0 nor t = V - 1
RANK = 1
#: steps a superstep and the relabel's estimated sweeps (the reference's)
CYCLES = 64
EST_SWEEPS = 24
#: the synthetic state: capacities 1..MAX_CAP, heights 0..MAX_H - 1, and
#: excess 1..MAX_CAP on this share of the vertices
MAX_CAP = 100
MAX_H = 32
EXCESS_SHARE = 0.25
#: timed calls a median
REPS = 10
GRAPH_MODES = ("replicated", "sharded", "sparse")
LM_GUIDANCE = ("the language-model dry-run cells are not ported to "
               "repro_torch yet: they wait for training and the sharding "
               "rules (ROADMAP.md, Queue 1 items 4-6); the port's dry run "
               "covers --arch wbpr-maxflow")


def _mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def record_name(arch: str, shape: str, mesh_tag: str,
                graph_mode: str = "replicated") -> str:
    """A record's file name (the reference's tag, with the mode)."""
    tag = f"{arch}__{shape}__{mesh_tag}"
    if graph_mode != "replicated":
        tag += f"__{graph_mode}"
    return f"{tag}.json"


# ---------------------------------------------------------------------------
# the graph cell
# ---------------------------------------------------------------------------

def _graph_specs(cell, mesh, mode: str):
    """The cell's ``DistMeta`` on ``mesh`` (``nshards`` the product of its
    axes) and each array's per-rank shape, as the reference's
    ``_graph_specs`` shards them."""
    from repro_torch.core import distributed as D

    if mode not in GRAPH_MODES:
        raise ValueError(f"unknown graph mode {mode!r}; expected one of "
                         f"{GRAPH_MODES}")
    nshards = mesh.size
    v, a = cell.batch, cell.seq
    vs, amax = v // nshards, a // nshards
    meta = D.DistMeta(n=v, num_arcs=a, vs=vs, amax=amax, nshards=nshards,
                      s=0, t=v - 1, mode=mode)
    shapes = {"indptr": (vs + 1,), "heads": (amax,), "rev": (amax,),
              "tail_local": (amax,),
              "res": (a,) if mode == "replicated" else (amax,),
              "h": (v,), "e": (v,)}
    return meta, shapes


def _base(n: int, d: int) -> int:
    """The least ``b`` with ``b^(d/2) >= n``."""
    b = max(2, round(n ** (2 / d)))
    while b ** (d // 2) < n:
        b += 1
    while b > 2 and (b - 1) ** (d // 2) >= n:
        b -= 1
    return b


def offsets(meta) -> list[int]:
    """The synthetic graph's ``d`` head offsets ``b^j, -b^j`` mod ``n``;
    raises where the cell cannot hold such a graph (``amax`` not ``d``
    arcs a vertex, or two offsets that meet mod ``n``)."""
    n, vs, amax = meta.n, meta.vs, meta.amax
    d = amax // max(1, vs)
    if vs < 1 or d < 2 or d % 2 or d * vs != amax or \
            meta.nshards * amax != meta.num_arcs:
        raise ValueError(
            f"the cell cannot hold the synthetic regular graph: {vs} "
            f"vertices and {amax} arc slots a rank need an even degree")
    b = _base(n, d)
    out = []
    for j in range(d // 2):
        out += [b ** j % n, -b ** j % n]
    if len(set(out)) != d or 0 in out:
        raise ValueError(f"the offsets {out} meet mod n = {n}")
    return out


def diameter_estimate(meta) -> int:
    """About the most arcs between two vertices of the synthetic graph
    (a bound where ``b^(d/2) = n``)."""
    d = meta.amax // meta.vs
    return d // 2 * (_base(meta.n, d) // 2)


def rank_slab(meta, w: int, device):
    """Rank ``w``'s ``DistGraph`` of the synthetic regular graph, built on
    ``device`` from ``meta`` alone."""
    import torch

    from repro_torch.core import distributed as D

    vs, amax, n = meta.vs, meta.amax, meta.n
    d = amax // vs
    off = torch.tensor(offsets(meta), dtype=torch.int64, device=device)
    k = torch.arange(d, dtype=torch.int64, device=device)
    local = torch.arange(vs, dtype=torch.int64, device=device)
    heads = (w * vs + local[:, None] + off[None, :]) % n  # (vs, d)
    rev = (heads // vs) * amax + (heads % vs) * d + (k ^ 1)[None, :]
    i32 = torch.int32
    return D.DistGraph(
        indptr=(torch.arange(vs + 1, device=device) * d).to(i32),
        heads=heads.reshape(-1).to(i32), rev=rev.reshape(-1).to(i32),
        tail_local=local.repeat_interleave(d).to(i32))


def rank_state(meta, w: int, device, seed: int):
    """A seeded mid-solve ``(res, h, e)`` of rank ``w``: the whole residual
    in the replicated mode, else the rank's slab."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + w)
    i32 = torch.int32
    a = meta.num_arcs if meta.mode == "replicated" else meta.amax
    res = torch.randint(1, MAX_CAP + 1, (a,), generator=gen, dtype=i32,
                        device=device)
    h = torch.randint(0, MAX_H, (meta.n,), generator=gen, dtype=i32,
                      device=device)
    share = torch.rand(meta.n, generator=gen, device=device) < EXCESS_SHARE
    e = torch.randint(1, MAX_CAP + 1, (meta.n,), generator=gen, dtype=i32,
                      device=device) * share
    h[meta.s], e[meta.s], e[meta.t] = meta.n, 0, 0
    return res, h, e.to(i32)


def expected_collectives(meta) -> dict:
    """The by-op wire bytes a step and a sweep issue for ``meta``'s
    shapes (``analysis/collectives.py``'s formulas, int32 buffers): the
    ``(A + 2n)`` all-reduce of ``replicated``; the ``(amax,)``
    reduce-scatter and ``(2n,)`` all-reduce of ``sharded``; the ``(2n,)``
    all-reduce and ``(P, 2, vs)`` all-to-all of ``sparse``; the sweep's
    ``(n,)`` all-reduce of MIN."""
    from repro_torch.analysis.collectives import wire_bytes

    n, a, p = meta.n, meta.num_arcs, meta.nshards
    step = {"replicated": {"all-reduce": (4 * (a + 2 * n))},
            "sharded": {"reduce-scatter": 4 * meta.amax,
                        "all-reduce": 4 * 2 * n},
            "sparse": {"all-reduce": 4 * 2 * n,
                       "all-to-all": 4 * p * 2 * meta.vs}}[meta.mode]
    return {"step": {k: wire_bytes(k, b, p) for k, b in step.items()},
            "gr_sweep": {"all-reduce": wire_bytes("all-reduce", 4 * n, p)}}


def _kernel_launches() -> int:
    """Every kernel wrapper's launch count, summed."""
    from repro_torch.kernels.discharge import fused_discharge_batched
    from repro_torch.kernels.revsearch import bcsr_rev_search
    from repro_torch.kernels.segmin import (tile_min_neighbor,
                                            tile_min_neighbor_gather,
                                            tile_min_neighbor_gather_rev)

    return sum(f.launches for f in (
        tile_min_neighbor, tile_min_neighbor_gather,
        tile_min_neighbor_gather_rev, bcsr_rev_search,
        fused_discharge_batched))


def _timings(fn, dev, reps: int) -> dict:
    """Median ms of ``reps`` calls of ``fn``: on the host's clock (each
    call synchronised), and on the card by CUDA events with a sleep ahead
    of each call, so the events bracket device work only."""
    import torch

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    fn()
    sync()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        walls.append(1e3 * (time.perf_counter() - t0))
    out = {"reps": reps, "wall_ms": statistics.median(walls),
           "device_ms": None}
    if cuda:
        pairs = []
        for _ in range(reps):
            torch.cuda._sleep(5_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        out["device_ms"] = statistics.median(a.elapsed_time(b)
                                             for a, b in pairs)
    return out


def _per_iter(fn, args, dev, reps: int) -> dict:
    """One call of ``fn(*args)`` under the op census (its collectives,
    aten ops and kernel launches), then its timings."""
    from repro_torch.analysis import ir
    from repro_torch.analysis.collectives import collective_bytes

    _, c = ir.record(fn, *args)
    return {"collectives": collective_bytes(c), "aten_ops": c.op_count,
            "launches": c.kernel_call_count,
            **_timings(lambda: fn(*args), dev, reps)}


def _lower_graph(cell, mesh, mode: str, device=None, seed: int = 0,
                 cycles: int = CYCLES, reps: int = REPS):
    """Run rank :data:`RANK` of ``cell``'s superstep on ``mesh`` under the
    fake group: its step and its relabel sweep each once under the census and
    ``reps`` times timed, then one whole superstep of ``cycles`` steps.
    Returns ``(meta, shapes, per_iter, full, graph)``."""
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.kernels.ref import INF
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.launch.mesh import fake_world

    dev = resolve_device(device)
    meta, shapes = _graph_specs(cell, mesh, mode)
    rank = RANK
    with fake_world(mesh.size, rank):
        t0 = time.perf_counter()
        g = rank_slab(meta, rank, dev)
        res, h, e = rank_state(meta, rank, dev, seed)
        v0 = rank * meta.vs
        slab_e = e[v0:v0 + meta.vs]
        active = int(((slab_e > 0) & (h[v0:v0 + meta.vs] < meta.n)).sum())
        setup_s = time.perf_counter() - t0
        state = {"indptr": g.indptr, "heads": g.heads, "rev": g.rev,
                 "tail_local": g.tail_local, "res": res, "h": h, "e": e}
        got = {k: tuple(x.shape) for k, x in state.items()}
        if got != shapes:
            raise RuntimeError(f"rank shapes {got} != the cell's {shapes}")
        step = D.make_dist_step(meta, g)
        sweep = D.make_gr_sweep(meta, g)
        dist0 = torch.where(h < meta.n, h, INF)  # mid-solve labels
        launches0 = _kernel_launches()
        per_iter = {"step": _per_iter(step, (res, h, e), dev, reps),
                    "gr_sweep": _per_iter(sweep, (res, dist0), dev, reps)}
        superstep = D.make_superstep(meta, g, cycles=cycles)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = superstep(res, h, e)
        nact, sweeps = int(out[3]), int(out[4])
        wall = time.perf_counter() - t0
        memory = {
            "state_bytes": sum(x.numel() * x.element_size()
                               for x in state.values()),
            "state": {k: x.numel() * x.element_size()
                      for k, x in state.items()},
            "peak_allocated_bytes": (torch.cuda.max_memory_allocated()
                                     if dev.type == "cuda" else None)}
        full = {"memory": memory,
                "superstep": {"cycles": cycles, "wall_s": wall,
                              "local_fixpoint_sweeps": sweeps,
                              "active_after": nact},
                "kernel_launches": _kernel_launches() - launches0}
    graph = {"degree": meta.amax // meta.vs, "offsets": offsets(meta),
             "diameter_estimate": diameter_estimate(meta), "seed": seed,
             "max_cap": MAX_CAP, "max_h": MAX_H,
             "excess_share": EXCESS_SHARE, "active_on_rank": active,
             "setup_s": setup_s}
    return meta, shapes, per_iter, full, graph


def run_cell(arch: str, shape, multi_pod: bool = False,
             graph_mode: str = "replicated", *, mesh=None, device=None,
             seed: int = 0, reps: int = REPS) -> dict:
    """The record of one cell.  ``shape`` is a ``GRAPH_SHAPES`` name or a
    ``ShapeCell``; ``mesh`` (a ``launch.mesh.Mesh``) overrides the
    production mesh ``multi_pod`` picks, so that tests run small cells."""
    from repro_torch.configs import registry
    from repro_torch.launch import shapes as SH
    from repro_torch.launch.mesh import production_mesh

    cfg = registry.get_config(arch)
    if cfg.family != "graph":
        raise NotImplementedError(f"{arch!r}: {LM_GUIDANCE}")
    cells = {c.name: c for c in SH.cells_for(cfg)}
    cell = shape if isinstance(shape, SH.ShapeCell) else cells.get(shape)
    if cell is None:
        raise KeyError(f"unknown shape {shape!r} for {arch!r}; expected one "
                       f"of {sorted(cells)}")
    mesh = mesh or production_mesh(multi_pod)
    import torch

    from repro_torch.kernels.runtime import resolve_device

    dev = resolve_device(device)
    rec = {"arch": arch, "shape": cell.name, "mesh": mesh.tag,
           "devices": mesh.size, "kind": cell.kind, "skipped": False,
           "opt": None, "graph_mode": graph_mode, "rank": RANK,
           "device": dev.type,
           "device_name": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
           "torch": torch.__version__}
    t0 = time.time()
    meta, shapes, per_iter, full, graph = _lower_graph(
        cell, mesh, graph_mode, dev, seed, CYCLES, reps)
    rec["run_s"] = time.time() - t0
    rec["meta"] = dataclasses.asdict(meta)
    rec["shard_shapes"] = {k: list(v) for k, v in shapes.items()}
    rec["graph"] = graph
    rec["full"] = full
    rec["per_iter"] = per_iter
    rec["expected_collectives"] = expected_collectives(meta)
    rec["extrapolated"] = {
        "collective_bytes":
            CYCLES * per_iter["step"]["collectives"]["total_bytes"]
            + EST_SWEEPS * per_iter["gr_sweep"]["collectives"]["total_bytes"]}
    rec["analytic"] = {"vertices": cell.batch, "arcs": cell.seq,
                       "cycles": CYCLES, "est_sweeps": EST_SWEEPS}
    return rec


def _jobs(args) -> list[tuple[str, str, bool, str]]:
    """``(arch, shape, multi_pod, mode)`` of every cell ``--all`` runs."""
    from repro_torch.configs import registry
    from repro_torch.launch import shapes as SH

    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    modes = (args.graph_mode,) if args.graph_mode else GRAPH_MODES
    jobs = []
    graph_archs = [a for a in registry.ARCH_IDS
                   if registry.get_config(a).family == "graph"]
    for arch in graph_archs:
        for cell in SH.cells_for(registry.get_config(arch)):
            for mp in meshes:
                jobs += [(arch, cell.name, mp, m) for m in modes]
    return jobs


def run_all(args, out_dir: pathlib.Path) -> int:
    """Every ``wbpr-maxflow`` cell, one after another in this process, each
    under a fake group of its own (``_lower_graph`` opens it and destroys
    it on exit), with the card's cached memory freed between cells; a
    record that exists is kept unless ``--fresh``.  The reference runs
    each cell in a subprocess because XLA's host-device count is fixed at
    start-up; nothing here is.  Returns the number of cells that
    failed."""
    import traceback

    import torch

    todo = []
    for arch, shape, mp, mode in _jobs(args):
        fout = out_dir / record_name(arch, shape, _mesh_tag(mp), mode)
        if fout.exists() and not args.fresh:
            print(f"[skip-cached] {fout.stem}", flush=True)
            continue
        fout.unlink(missing_ok=True)
        todo.append((fout, arch, shape, mp, mode))
    failures = []
    for fout, arch, shape, mp, mode in todo:
        t0, ok = time.time(), True
        try:
            rec = run_cell(arch, shape, mp, mode, device=args.device,
                           seed=args.seed)
            fout.write_text(json.dumps(rec, indent=2))
        except Exception:  # noqa: BLE001 - recorded, counted, returned
            ok = False
            failures.append(fout.stem)
            (out_dir / f"{fout.stem}.err").write_text(traceback.format_exc())
        print(f"[{'ok' if ok else 'FAIL'}] {fout.stem} "
              f"({time.time() - t0:.1f}s)", flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    print(f"done: {len(todo) - len(failures)}/{len(todo)} ok", flush=True)
    if failures:
        print("failures:", failures, flush=True)
    return len(failures)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--graph-mode", default=None, choices=GRAPH_MODES,
                    help="one cell: default replicated; --all: default "
                         "every mode")
    ap.add_argument("--all", action="store_true",
                    help="run every wbpr-maxflow cell, one after another")
    ap.add_argument("--fresh", action="store_true",
                    help="with --all, rerun cells whose record exists")
    ap.add_argument("--device", default=None,
                    help="cpu to run off the card (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        return 1 if run_all(args, out_dir) else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    mode = args.graph_mode or "replicated"
    rec = run_cell(args.arch, args.shape, args.multi_pod, mode,
                   device=args.device, seed=args.seed)
    fout = out_dir / record_name(args.arch, args.shape, rec["mesh"], mode)
    fout.write_text(json.dumps(rec, indent=2))
    print(json.dumps({k: rec.get(k) for k in
                      ("arch", "shape", "mesh", "graph_mode", "skipped",
                       "run_s")}))
    print("memory:", rec["full"]["memory"])
    print("per step:", rec["per_iter"]["step"])
    print("per sweep:", rec["per_iter"]["gr_sweep"])
    print("extrapolated:", rec["extrapolated"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
