"""Multi-pod dry run (port of the JAX package's ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch wbpr-maxflow --shape graph_128m
    python -m repro_torch.launch.dryrun --arch wbpr-maxflow --shape graph_16m \\
        --multi-pod --graph-mode sharded --device cpu
    python -m repro_torch.launch.dryrun --arch qwen2-72b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --both-meshes   # every cell

The reference lowers and compiles the whole mesh's program for 256 or
512 fake XLA host devices.  Eager PyTorch compiles nothing, so the port
RUNS one rank of it instead: under ``mesh.fake_world`` this process is
rank :data:`RANK` of the mesh's 256 or 512 ranks, with that rank's real
shards on the card (or the CPU with ``--device cpu``), and the fake
group's collectives returning at once.

**Graph cells.** One cell is one graph scale (``launch/shapes.py``'s
``GRAPH_SHAPES``) on one production mesh (16x16 or 2x16x16,
``launch/mesh.py``) in one exchange of the distributed superstep
(``replicated``, ``sharded``, ``sparse``; ``core/distributed.py``).  The
rank's slab is one rank's part of a synthetic regular graph, built
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
the vertices come from ``--seed``, so the step has active lanes.  Its
record carries ``per_iter.step`` / ``per_iter.gr_sweep`` with their
``collectives`` = ``{total_bytes, by_op, counts}``, and
``extrapolated.collective_bytes`` = 64 steps + 24 sweeps; under
``full.memory`` the rank's state bytes and, on the card, the peak
allocated across one superstep; a step's and a sweep's aten ops and
kernel launches (the op census, ``analysis/ir.py``); their device ms on
the card (CUDA events, median of :data:`REPS`) and host-clock ms on
both; and the wall of one superstep.

**Language-model cells.** One cell is one arch of ``registry.ARCH_IDS``
at one of its ``LM_SHAPES`` on one production mesh.  ``long_500k`` on a
full-attention arch writes the reference's skip record.  The rank's
parameters (``transformer.init_local_params``: only its own shards are
drawn), optimizer state, batch, cache and tokens are DTensors on a
``DeviceMesh`` of the mesh (``specs.input_specs`` / ``materialize``),
and the cell's step runs once under the op census and
``FlopCounterMode``, then :data:`LM_REPS` times timed: a train step with
``cfg.optimizer``, a prefill, or a decode step.  Every cell runs at 1
and 2 superblocks (the reference's unrolled variants; eager PyTorch
counts every op, so no chunk variants are needed), and flops, collective
bytes by kind, aten ops, device ms and the peak allocated are
extrapolated as the reference's are: ``C = C1 + (n_blocks - 1)(C2 -
C1)``.  ``--full-depth`` runs the whole depth too, where the rank fits
the card.  ``full.memory`` holds the rank's argument bytes at full depth
from the shape trees (params, opt state, cache, batch).  ``--opt`` takes
the reference's perf-knob overrides.

Each cell writes one JSON record to
``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__opt-<knobs>][__<mode>].json``
with the reference's fields where they mean the same thing (``arch``,
``shape``, ``mesh``, ``devices``, ``kind``, ``skipped``, ``opt``,
``analytic``, ``extrapolated``), and ``device``, ``device_name`` and
``torch``.

What the fake group hides: no byte crosses a wire, so no wire time is
measured, only the bytes each collective would move
(``analysis/collectives.py``); the relabel's all-reduce of MIN combines
nothing, so its sweep count is this rank's local fixpoint; and an LM
rank's numbers are its own shards' (an all-gather tiles the local
chunk).  The collectives are the ones DTensor's sharding propagation
chooses, not GSPMD's.  XLA's ``bytes_accessed``, ``transcendentals`` and
lower / compile times have no eager counterpart and are left out, not
estimated.
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
#: timed calls of an LM cell's step a variant (after the census's call)
LM_REPS = 2
SKIP_REASON = ("full-attention arch: long-context decode is quadratic; "
               "skipped per DESIGN.md §5")


def _mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def record_name(arch: str, shape: str, mesh_tag: str,
                graph_mode: str = "replicated", opt_slug: str = "") -> str:
    """A record's file name (the reference's tag, with the mode)."""
    tag = f"{arch}__{shape}__{mesh_tag}"
    if opt_slug:
        tag += f"__opt-{opt_slug}"
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


# ---------------------------------------------------------------------------
# the language-model cell
# ---------------------------------------------------------------------------

def _analytic_lm(cfg, cell):
    n_active = cfg.active_param_count()
    n_total = cfg.param_count()
    if cell.kind == "train":
        tokens = cell.batch * cell.seq
        model_flops = 6 * n_active * tokens
    elif cell.kind == "prefill":
        tokens = cell.batch * cell.seq
        model_flops = 2 * n_active * tokens
    else:
        tokens = cell.batch
        model_flops = 2 * n_active * tokens
    return {"params": n_total, "active_params": n_active,
            "tokens": tokens, "model_flops": model_flops}


def _apply_overrides(cfg, opt: str):
    if not opt:
        return cfg, ""
    kw = {}
    for item in opt.split(","):
        k, _, v = item.partition("=")
        kw[k.strip()] = bool(int(v)) if v in ("0", "1") else v
    slug = "-".join(k for k, v in kw.items() if v)
    return dataclasses.replace(cfg, **kw), slug


def depth_variant(cfg, n_super: int):
    """``cfg`` cut to ``n_super`` superblocks (the reference's
    ``_cost_variant_cfg`` depth; whisper's encoder to as many layers)."""
    kw = dict(n_layers=len(cfg.block_pattern) * n_super)
    if cfg.is_encoder_decoder:
        kw["n_enc_layers"] = n_super
    return dataclasses.replace(cfg, **kw)


def arg_bytes(cfg, cell, mesh) -> dict:
    """One rank's argument bytes of the cell's step from the shape trees
    (``specs.input_specs``): params, opt state, cache, batch."""
    from repro_torch.launch import specs as S
    from repro_torch.models import transformer as T

    args, kind = S.input_specs(cfg, cell, mesh)
    out = {"params": T.tree_bytes(args[0]), "opt_state": 0, "cache": 0,
           "batch": 0}
    if kind == "train":
        out["opt_state"] = T.tree_bytes(args[1])
        out["batch"] = T.tree_bytes(args[2])
    elif kind == "prefill":
        out["batch"] = sum(T.tree_bytes(a) for a in args[1:])
    else:
        out["cache"] = T.tree_bytes(args[1])
        out["batch"] = T.tree_bytes(args[2])
    out["total"] = sum(out.values())
    return out


def lm_step(cfg, cell, mesh, dmesh, device, seed: int = 0):
    """Rank :data:`RANK`'s step of ``cell`` on ``dmesh`` (a ``DeviceMesh``
    of ``mesh`` over the open group) and its arguments: ``(fn, args,
    kind)``, ``fn(*args)`` one train step (``cfg.optimizer``, the grads
    pinned with ``cfg.pin_grads``), prefill or decode step."""
    from repro_torch.launch import specs as S
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import (make_decode_step,
                                                 make_prefill_step,
                                                 make_train_step)

    specs, kind = S.input_specs(cfg, cell, mesh)
    params = T.init_local_params(cfg, dmesh, seed, device)
    rest = [S.materialize(a, dmesh, device, seed, vocab=cfg.vocab)
            for a in specs[1:]]
    if kind == "train":
        opt = O.make_optimizer(cfg.optimizer)
        gs = T.param_shardings(cfg, dmesh) if cfg.pin_grads else None
        return (make_train_step(cfg, opt, grad_shardings=gs),
                (params, opt.init(params), rest[1]), kind)
    if kind == "prefill":
        return make_prefill_step(cfg), (params, *rest), kind
    return make_decode_step(cfg), (params, *rest), kind


def flop_mode():
    """A dispatch mode that counts the flops of the ops it sees
    (``.total``) by ``FlopCounterMode``'s formulas (matmuls, attention's
    included as its matmuls).  ``FlopCounterMode`` itself would count an
    op on DTensors at its global shapes; this mode lets DTensor run first,
    as the census does, so it counts this rank's local ops."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode

    registry = FlopCounterMode(display=False).flop_registry

    class _LocalFlops(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            f = registry.get(func._overloadpacket)
            if f is not None:
                self.total += int(f(*args, **kwargs, out_val=out))
            return out

    return _LocalFlops()


def _lm_variant(cfg, cell, mesh, dev, seed: int, reps: int) -> dict:
    """One depth variant of an LM cell, under a fake group of its own:
    after a first call, one call under the census (collective bytes by
    kind, aten ops, kernel launches) and :func:`flop_mode`, then ``reps``
    timed calls (device ms by CUDA
    events on the card, host ms on both; the peak allocated across
    them)."""
    import torch

    from repro_torch.analysis import ir
    from repro_torch.analysis.collectives import collective_bytes
    from repro_torch.launch.mesh import device_mesh, fake_world

    cuda = dev.type == "cuda"
    with fake_world(mesh.size, RANK):
        dmesh = device_mesh(mesh, dev.type)
        t0 = time.perf_counter()
        fn, args, _ = lm_step(cfg, cell, mesh, dmesh, dev, seed)
        setup_s = time.perf_counter() - t0
        launches0 = _kernel_launches()
        # the first call fills DTensor's sharding-propagation caches (the
        # propagation runs ops of its own): the counts are of a later one
        t0 = time.perf_counter()
        fn(*args)
        first_s = time.perf_counter() - t0
        fm = flop_mode()
        with fm:
            _, c = ir.record(fn, *args)
        flops = fm.total
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        walls, events = [], []
        for _ in range(reps):
            if cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
            t0 = time.perf_counter()
            fn(*args)
            if cuda:
                b.record()
                torch.cuda.synchronize()
                events.append(a.elapsed_time(b))
            walls.append(1e3 * (time.perf_counter() - t0))
        out = {"n_layers": cfg.n_layers, "flops": flops,
               "collectives": collective_bytes(c), "aten_ops": c.op_count,
               "kernel_launches": _kernel_launches() - launches0,
               "reps": reps, "wall_ms": statistics.median(walls),
               "device_ms": statistics.median(events) if cuda else None,
               "peak_allocated_bytes": (torch.cuda.max_memory_allocated()
                                        if cuda else None),
               "setup_s": setup_s, "first_call_s": first_s}
        del fn, args
    if cuda:
        torch.cuda.empty_cache()
    return out


def extrapolate(c1: dict, c2: dict, n_blocks: int) -> dict:
    """``C = C1 + (n_blocks - 1)(C2 - C1)`` of every cost the variants
    share: flops, collective bytes (in all and by kind), aten ops, device
    ms and the peak allocated (``None`` where a variant has none)."""
    def ex(a, b):
        if a is None or b is None:
            return None
        return a + (n_blocks - 1) * (b - a)

    kinds = set(c1["collectives"]["by_op"]) | set(c2["collectives"]["by_op"])
    return {
        "flops": ex(c1["flops"], c2["flops"]),
        "collective_bytes": ex(c1["collectives"]["total_bytes"],
                               c2["collectives"]["total_bytes"]),
        "collective_bytes_by_op": {
            k: ex(c1["collectives"]["by_op"].get(k, 0.0),
                  c2["collectives"]["by_op"].get(k, 0.0)) for k in kinds},
        "collectives_by_op_1sb": c1["collectives"]["by_op"],
        "aten_ops": ex(c1["aten_ops"], c2["aten_ops"]),
        "device_ms": ex(c1["device_ms"], c2["device_ms"]),
        "peak_allocated_bytes": ex(c1["peak_allocated_bytes"],
                                   c2["peak_allocated_bytes"]),
    }


def _lower_lm(cfg, cell, mesh, dev, seed: int, reps: int,
              full_depth: bool) -> dict:
    """The LM cell's costs: the 1- and 2-superblock variants, their
    extrapolation to ``cfg.n_blocks``, and with ``full_depth`` the whole
    depth's run."""
    c1 = _lm_variant(depth_variant(cfg, 1), cell, mesh, dev, seed, reps)
    c2 = _lm_variant(depth_variant(cfg, 2), cell, mesh, dev, seed, reps)
    out = {"variant_costs": {"c1": c1, "c2": c2},
           "extrapolated": extrapolate(c1, c2, cfg.n_blocks)}
    if full_depth:
        out["full_run"] = _lm_variant(cfg, cell, mesh, dev, seed, reps)
    return out


def skip_record(arch: str, shape: str, mesh_tag: str) -> dict:
    """The reference's record of a cell ``cells_for`` leaves out."""
    return {"arch": arch, "shape": shape, "mesh": mesh_tag,
            "skipped": True, "reason": SKIP_REASON}


def run_cell(arch: str, shape, multi_pod: bool = False,
             graph_mode: str = "replicated", *, opt: str = "", mesh=None,
             device=None, seed: int = 0, reps: int | None = None,
             full_depth: bool = False, cfg=None) -> dict:
    """The record of one cell.  ``shape`` is a cell's name or a
    ``ShapeCell``; ``mesh`` (a ``launch.mesh.Mesh``) overrides the
    production mesh ``multi_pod`` picks, and ``cfg`` the arch's config,
    so that tests run small cells.  ``opt`` (an LM cell's perf knobs,
    ``shard_activations=1,...``) and ``full_depth`` as on the command
    line."""
    from repro_torch.configs import registry
    from repro_torch.launch import shapes as SH
    from repro_torch.launch.mesh import production_mesh

    cfg = cfg or registry.get_config(arch)
    lm = cfg.family != "graph"
    opt_slug = ""
    if lm:
        cfg, opt_slug = _apply_overrides(cfg, opt)
    mesh = mesh or production_mesh(multi_pod)
    cells = {c.name: c for c in SH.cells_for(cfg)}
    cell = shape if isinstance(shape, SH.ShapeCell) else cells.get(shape)
    if cell is None:
        if lm and shape in SH.LM_SHAPES:
            return skip_record(arch, shape, mesh.tag)
        raise KeyError(f"unknown shape {shape!r} for {arch!r}; expected one "
                       f"of {sorted(cells)}")
    import torch

    from repro_torch.kernels.runtime import resolve_device

    dev = resolve_device(device)
    rec = {"arch": arch, "shape": cell.name, "mesh": mesh.tag,
           "devices": mesh.size, "kind": cell.kind, "skipped": False,
           "opt": opt or None, "rank": RANK, "device": dev.type,
           "device_name": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
           "torch": torch.__version__}
    t0 = time.time()
    if lm:
        if opt_slug:
            rec["opt_slug"] = opt_slug
        rec.update(_lower_lm(cfg, cell, mesh, dev, seed,
                             LM_REPS if reps is None else reps, full_depth))
        rec["run_s"] = time.time() - t0
        rec["full"] = {"memory": {
            "arg_bytes": arg_bytes(cfg, cell, mesh),
            "peak_allocated_bytes":
                rec["extrapolated"]["peak_allocated_bytes"]}}
        rec["analytic"] = _analytic_lm(cfg, cell)
        return rec
    rec["graph_mode"] = graph_mode
    meta, shapes, per_iter, full, graph = _lower_graph(
        cell, mesh, graph_mode, dev, seed, CYCLES,
        REPS if reps is None else reps)
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
    """``(arch, shape, multi_pod, mode)`` of every cell ``--all`` runs:
    every arch of ``registry.ARCH_IDS`` (``--arch``: that one); an LM arch at every
    ``LM_SHAPES`` entry (the ones it skips give their skip record), the
    graph arch in each exchange."""
    from repro_torch.configs import registry
    from repro_torch.launch import shapes as SH

    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    modes = (args.graph_mode,) if args.graph_mode else GRAPH_MODES
    jobs = []
    only = getattr(args, "arch", None)
    for arch in registry.ARCH_IDS:
        if only and arch != only:
            continue
        cfg = registry.get_config(arch)
        if cfg.family == "graph":
            for cell in SH.cells_for(cfg):
                for mp in meshes:
                    jobs += [(arch, cell.name, mp, m) for m in modes]
        else:
            jobs += [(arch, shape, mp, "replicated")
                     for shape in SH.LM_SHAPES for mp in meshes]
    return jobs


def run_all(args, out_dir: pathlib.Path) -> int:
    """Every cell, one after another in this process, each under a fake
    group of its own (``_lower_graph`` / ``_lm_variant`` open it and
    destroy it on exit), with the card's cached memory freed between
    cells; a record that exists is kept unless ``--fresh``.  The
    reference runs each cell in a subprocess because XLA's host-device
    count is fixed at start-up; nothing here is.  Returns the number of
    cells that failed."""
    import traceback

    import torch

    opt = getattr(args, "opt", "")
    full_depth = getattr(args, "full_depth", False)
    todo = []
    for arch, shape, mp, mode in _jobs(args):
        slug = _slug(arch, opt)
        fout = out_dir / record_name(arch, shape, _mesh_tag(mp), mode, slug)
        if fout.exists() and not args.fresh:
            print(f"[skip-cached] {fout.stem}", flush=True)
            continue
        fout.unlink(missing_ok=True)
        todo.append((fout, arch, shape, mp, mode))
    failures = []
    for fout, arch, shape, mp, mode in todo:
        t0, ok = time.time(), True
        try:
            rec = run_cell(arch, shape, mp, mode, opt=opt,
                           device=args.device, seed=args.seed,
                           full_depth=full_depth)
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


def _slug(arch: str, opt: str) -> str:
    """The override slug of ``--opt`` for an LM arch ('' for the graph)."""
    from repro_torch.configs import registry

    cfg = registry.get_config(arch)
    return "" if cfg.family == "graph" else _apply_overrides(cfg, opt)[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--graph-mode", default=None, choices=GRAPH_MODES,
                    help="one cell: default replicated; --all: default "
                         "every mode")
    ap.add_argument("--opt", default="",
                    help="LM perf-knob overrides, e.g. shard_activations=1")
    ap.add_argument("--full-depth", action="store_true",
                    help="LM cells: also run the whole depth")
    ap.add_argument("--all", action="store_true",
                    help="run every cell, one after another")
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
                   opt=args.opt, device=args.device, seed=args.seed,
                   full_depth=args.full_depth)
    fout = out_dir / record_name(args.arch, args.shape, rec["mesh"], mode,
                                 rec.get("opt_slug", ""))
    fout.write_text(json.dumps(rec, indent=2))
    print(json.dumps({k: rec.get(k) for k in
                      ("arch", "shape", "mesh", "graph_mode", "skipped",
                       "run_s")}))
    if rec["skipped"]:
        print("skipped:", rec["reason"])
    elif "per_iter" in rec:
        print("memory:", rec["full"]["memory"])
        print("per step:", rec["per_iter"]["step"])
        print("per sweep:", rec["per_iter"]["gr_sweep"])
        print("extrapolated:", rec["extrapolated"])
    else:
        print("memory:", rec["full"]["memory"])
        print("extrapolated:", rec["extrapolated"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
