"""The multi-device LM checks that ``chip_smoke.py``'s ``lm_sharded``
phase runs on the card, kept in the port so the script only calls
:func:`run`.  Each row runs one rank at full width, under the ``fake``
process group (``launch/mesh.fake_world``) with its real local shards on
the card, or on a one-rank NCCL group; a failed check raises
``AssertionError``.  Rows, in priority order:

1. :func:`decode_row` — qwen2-72b ``decode_32k`` on 16x16, rank
   :data:`~repro_torch.launch.dryrun.RANK`, all 80 layers (one card
   cannot hold the model: 145 GB in bf16; the rank holds its weights'
   shards and 5.37 GB of KV cache).  Two decode steps from ``pos`` =
   2047, the last slot of the sequence shard before this rank's, then
   2048, its first: every cache leaf's local shape is
   ``cache_shape_tree``'s, ``pos`` advances on the device, the first
   step writes nothing here and the second writes local slot 0 of every
   layer and row and nothing else (the shards start at a sentinel
   value), and the logits are finite.  Device
   ms, the peak allocated and the collective bytes by kind.
2. :func:`train_row` — qwen3-4b ``train_4k`` on 16x16 (a local batch of
   16 x 4096) with AdamW at 1 and 2 superblocks and whole (36 layers):
   the 1/2-superblock extrapolation of flops and collective bytes equals
   the whole run's; both peaks are recorded.
3. :func:`gpipe_rows` — GPipe (``training/pipeline_pp``) on a one-rank
   NCCL group, ``stages=1``, ``microbatches=4``: qwen3-4b cut to 2 layers
   in float32 at B = 4 x 128, its loss and gradients against
   ``make_loss_fn`` / ``value_and_grad`` on the card (the CPU tests'
   tolerances); then stage 1 of ``stages=4`` under the fake group at
   full width (9 of 36 layers), its peak and device ms.
4. :func:`pod_psum_row` — ``hierarchical_pod_psum`` on one NCCL rank:
   with groups of one, the compressed sum is ``_dequantize(_quantize(g))``
   of the card's ``g``, bit for bit against the CPU's.
5. :func:`family_rows` — the 1-superblock ``train_4k`` cell at 16x16 of
   one config of each other family (:data:`FAMILY_ROWS`), while the
   phase's time budget lasts; the rows not reached are returned as cut.

``smoke=True`` runs SMOKE configs at small cells on a (2, 2) mesh, so
that the phase rehearses on the CPU (``device="cpu"``)."""
from __future__ import annotations

import dataclasses
import os
import socket
import statistics
import time

import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import dryrun as D
from repro_torch.launch import shapes as SH
from repro_torch.launch.mesh import (Mesh, device_mesh, fake_world,
                                     production_mesh)

#: the families' rows of :func:`family_rows`, in order.  Not among them:
#: jamba-1.5-large-398b, whose 1-superblock cell does not fit one card
#: (its 8 layers, 7 of them Mamba, at 16 x 4096 a rank hold 77 GiB)
FAMILY_ROWS = ("mixtral-8x7b", "rwkv6-1.6b", "whisper-tiny",
               "llama-3.2-vision-90b", "grok-1-314b")
#: the seconds a family row takes on an H100 (17-21 s cold, 3-8 s warm):
#: a row starts only while this much of the budget is left
FAMILY_ROW_S = 20.0
#: the value the decode row fills its K/V shards with (exact in bf16)
SENTINEL = 7.0
#: GPipe: the card-held hold's tolerances (the reference test's): the
#: loss relative, each gradient leaf over its rms
PP_LOSS_TOL, PP_GRAD_TOL = 1e-4, 5e-3


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _peak(dev):
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else None


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _timed(fn, dev):
    """``(result, device ms by CUDA events | None, wall ms)`` of one
    call."""
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
    t0 = time.perf_counter()
    out = fn()
    ms = None
    if dev.type == "cuda":
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b)
    return out, ms, 1e3 * (time.perf_counter() - t0)


def _mesh_cell(smoke: bool, shape: str):
    """The mesh and the cell of a row: production's, or a (2, 2) mesh and
    a small cell of the same kind for a rehearsal."""
    if not smoke:
        return production_mesh(False), SH.LM_SHAPES[shape]
    small = {"decode_32k": SH.ShapeCell("decode_32k", "decode", 64, 4),
             "train_4k": SH.ShapeCell("train_4k", "train", 32, 4)}
    return Mesh((2, 2), ("data", "model")), small[shape]


def _config(arch: str, smoke: bool):
    return (registry.get_smoke_config if smoke else registry.get_config)(
        arch)


def decode_row(emit, *, smoke: bool = False, device=None) -> dict:
    """Row 1 (see the module docstring)."""
    from repro_torch.analysis import ir
    from repro_torch.analysis.collectives import collective_bytes
    from repro_torch.models import transformer as T

    dev = resolve_device(device)
    cfg = _config("qwen2-72b", smoke)
    mesh, cell = _mesh_cell(smoke, "decode_32k")
    t_row = time.perf_counter()
    with fake_world(mesh.size, D.RANK):
        dmesh = device_mesh(mesh, dev.type)
        fn, (params, cache, tok), _ = D.lm_step(cfg, cell, mesh, dmesh, dev)
        want = dict(T.tree_leaves(T.cache_shape_tree(
            cfg, mesh, cell.batch, cell.seq), T._is_tensor_spec))
        for path, t in T.tree_leaves(cache):
            if path != "pos":
                _require(tuple(t.to_local().shape) == want[path].local_shape,
                         f"cache leaf {path}: local {tuple(t.shape)} != "
                         f"{want[path].local_shape}")
        # the sequence shard this rank holds, and a pos just before it
        seq_mesh = mesh.axis_names.index("model")
        coord = dmesh.get_coordinate()[seq_mesh]
        sl = want["blocks.p0.k"].local_shape[2]
        first = coord * sl
        cache["pos"].fill_(first - 1)
        # a sentinel in this rank's K/V shards shows where a step writes
        # (under the fake group a token outside this rank's vocab shard
        # embeds to zeros, and so may its K and V)
        ks = [t.to_local() for p, t in T.tree_leaves(cache)
              if p.endswith((".k", ".v"))]
        for k in ks:
            k.fill_(SENTINEL)
        _reset_peak(dev)
        (_, lg1, cache), ms1, wall1 = _timed(lambda: fn(params, cache, tok),
                                             dev)
        _require(int(cache["pos"]) == first, "pos did not advance")
        _require(all(bool((k == SENTINEL).all()) for k in ks),
                 f"slot {first - 1} (another rank's shard) was written "
                 f"here")
        fm = D.flop_mode()
        with fm:
            (_, lg2, cache), c = ir.record(fn, params, cache, tok)
        _require(int(cache["pos"]) == first + 1, "pos did not advance")
        written = [int((k[:, :, 0] != SENTINEL).any(dim=-1).any(dim=-1)
                       .sum()) for k in ks]
        elsewhere = [int((k[:, :, 1:] != SENTINEL).sum()) for k in ks]
        want_rows = ks[0].shape[0] * ks[0].shape[1]
        _require(all(w == want_rows for w in written) and
                 not any(elsewhere),
                 f"slot {first} did not land on local slot 0 of every "
                 f"layer and row alone: (layer, row) pairs written "
                 f"{written} of {want_rows}, nonzeros elsewhere "
                 f"{elsewhere}")
        (_, lg3, cache), ms3, wall3 = _timed(lambda: fn(params, cache, tok),
                                             dev)
        for lg in (lg1, lg2, lg3):
            _require(bool(torch.isfinite(lg.to_local()).all()),
                     "non-finite logits")
        row = {"row": "decode", "arch": cfg.name, "shape": cell.name,
               "mesh": mesh.tag, "rank": D.RANK, "layers": cfg.n_layers,
               "cache_local_bytes": sum(k.numel() * k.element_size()
                                        for k in ks),
               "pos_steps": [first - 1, first, first + 1],
               "first_step_device_ms": ms1, "first_step_wall_ms": wall1,
               "device_ms": ms3, "wall_ms": wall3,
               "peak_allocated_bytes": _peak(dev),
               "collectives": collective_bytes(c), "aten_ops": c.op_count,
               "flops": fm.total, "kernel_launches": c.kernel_call_count,
               "seconds": time.perf_counter() - t_row}
        del fn, params, cache, tok, ks
    _free(dev)
    emit({"phase": "lm_sharded", **row})
    return row


def _free(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def train_row(emit, *, smoke: bool = False, device=None) -> dict:
    """Row 2 (see the module docstring)."""
    dev = resolve_device(device)
    cfg = _config("qwen3-4b", smoke)
    if smoke:
        cfg = dataclasses.replace(cfg, n_layers=3)
    mesh, cell = _mesh_cell(smoke, "train_4k")
    t0 = time.perf_counter()
    out = D._lower_lm(cfg, cell, mesh, dev, 0, 1, True)
    e, f = out["extrapolated"], out["full_run"]
    fb = f["collectives"]
    _require(e["flops"] == f["flops"],
             f"extrapolated flops {e['flops']} != the whole run's "
             f"{f['flops']}")
    _require(e["collective_bytes"] == fb["total_bytes"] and all(
        e["collective_bytes_by_op"].get(k, 0.0) == v
        for k, v in fb["by_op"].items()),
        f"extrapolated collective bytes {e['collective_bytes_by_op']} != "
        f"the whole run's {fb['by_op']}")
    row = {"row": "train", "arch": cfg.name, "shape": cell.name,
           "mesh": mesh.tag, "rank": D.RANK, "layers": cfg.n_layers,
           "local_batch": [cell.batch // 16 if not smoke else cell.batch // 2,
                           cell.seq],
           "flops": f["flops"], "collectives": fb,
           "extrapolated_peak_bytes": e["peak_allocated_bytes"],
           "whole_peak_bytes": f["peak_allocated_bytes"],
           "whole_device_ms": f["device_ms"], "whole_wall_ms": f["wall_ms"],
           "extrapolated_device_ms": e["device_ms"],
           "kernel_launches": sum(v["kernel_launches"] for v in (
               *out["variant_costs"].values(), f)),
           "variants": {k: {x: v[x] for x in ("n_layers", "flops",
                                              "device_ms",
                                              "peak_allocated_bytes",
                                              "first_call_s")}
                        for k, v in (*out["variant_costs"].items(),
                                     ("whole", f))},
           "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_sharded", **row})
    return row


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _one_rank_group(dev):
    """A one-rank group on ``dev``: NCCL on the card, gloo on the CPU."""
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)


def _rms(t) -> float:
    return float(t.float().pow(2).mean().sqrt())


def gpipe_rows(emit, *, smoke: bool = False, device=None) -> list:
    """Row 3 (see the module docstring)."""
    from repro_torch.models import transformer as T
    from repro_torch.training import pipeline_pp as PP
    from repro_torch.training import train_step as S

    dev = resolve_device(device)
    base = _config("qwen3-4b", smoke)
    if smoke:
        base = dataclasses.replace(base, n_layers=8)
    cfg = dataclasses.replace(base, n_layers=2, dtype=torch.float32)
    b, s = (4, 128) if not smoke else (4, 16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tok = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    rows = []
    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    _one_rank_group(dev)
    try:
        params = T.init_params(cfg, 0, device=dev)
        (loss, grads), ms, _ = _timed(lambda: PP.make_pp_grad(
            cfg, dist.group.WORLD, stages=1, microbatches=4)(params, batch),
            dev)
        (want, _), wgrads = S.value_and_grad(S.make_loss_fn(cfg))(
            params, batch)
        loss_err = abs(float(loss) - float(want)) / abs(float(want))
        worst = max(float((g - wg).abs().max()) / max(_rms(wg), 1e-30)
                    for (_, g), (_, wg) in zip(T.tree_leaves(grads),
                                               T.tree_leaves(wgrads)))
        _require(loss_err <= PP_LOSS_TOL, f"GPipe loss {float(loss)} != "
                 f"{float(want)}")
        _require(worst <= PP_GRAD_TOL, f"GPipe gradients off by {worst} "
                 "of a leaf's rms")
        rows.append({"row": "gpipe_stages1", "arch": cfg.name,
                     "layers": cfg.n_layers, "batch": [b, s],
                     "microbatches": 4, "loss": float(loss),
                     "loss_rel_err": loss_err, "worst_grad_over_rms": worst,
                     "device_ms": ms, "seconds": time.perf_counter() - t0})
        del params, grads, wgrads
    finally:
        dist.destroy_process_group()
        torch.backends.cuda.matmul.allow_tf32 = tf32
    _free(dev)
    # stage 1 of 4 at full width under the fake group
    t0 = time.perf_counter()
    stages = 4
    per = base.n_blocks // stages
    bb, ss = (8, 512) if not smoke else (4, 16)
    tok = torch.randint(0, base.vocab, (bb, ss), generator=gen, device=dev)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    with fake_world(stages, 1):
        params = T.init_params(dataclasses.replace(
            base, n_layers=per * len(base.block_pattern)), 0, device=dev)
        grad_fn = PP.make_pp_grad(base, dist.group.WORLD, stages=stages,
                                  microbatches=4)
        _reset_peak(dev)
        (loss, grads), ms, wall = _timed(lambda: grad_fn(params, batch), dev)
        _require(all(bool(torch.isfinite(g).all())
                     for _, g in T.tree_leaves(grads)),
                 "GPipe stage 1 gradients not finite")
        rows.append({"row": "gpipe_stage1_of_4", "arch": base.name,
                     "layers": per * len(base.block_pattern),
                     "batch": [bb, ss], "microbatches": 4,
                     "device_ms": ms, "wall_ms": wall,
                     "peak_allocated_bytes": _peak(dev),
                     "seconds": time.perf_counter() - t0})
        del params, grads
    _free(dev)
    for r in rows:
        emit({"phase": "lm_sharded", **r})
    return rows


def pod_psum_row(emit, *, device=None) -> dict:
    """Row 4 (see the module docstring)."""
    from repro_torch.training import grad_compress as G

    dev = resolve_device(device)
    t0 = time.perf_counter()
    gen = torch.Generator()
    gen.manual_seed(0)
    tree = {"w": torch.randn((1024, 4096), generator=gen) * 0.03,
            "b": torch.randn((4096,), generator=gen).to(torch.bfloat16)}
    _one_rank_group(dev)
    try:
        w = dist.group.WORLD
        got = G.hierarchical_pod_psum(
            {k: v.to(dev) for k, v in tree.items()}, in_pod_group=w,
            pod_group=w)
        plain = G.hierarchical_pod_psum(
            {k: v.to(dev) for k, v in tree.items()}, in_pod_group=w,
            pod_group=w, compress=False)
    finally:
        dist.destroy_process_group()
    equal = {}
    for k, v in tree.items():
        want = G._dequantize(*G._quantize(v.float())).to(v.dtype)
        equal[k] = bool(torch.equal(got[k].cpu(), want))
        _require(equal[k], f"hierarchical_pod_psum[{k}] differs from the "
                 "CPU's quantize round trip")
        _require(torch.equal(plain[k].cpu(), v), f"uncompressed [{k}]")
    row = {"row": "hierarchical_pod_psum", "bit_equal": equal,
           "seconds": time.perf_counter() - t0}
    emit({"phase": "lm_sharded", **row})
    return row


def family_rows(emit, *, smoke: bool = False, device=None,
                budget_s: float | None = None) -> list:
    """Row 5: the 1-superblock ``train_4k`` cell of each of
    :data:`FAMILY_ROWS` while ``budget_s`` lasts (``None``: all);
    returns the archs cut."""
    dev = resolve_device(device)
    t_start = time.perf_counter()
    cut = []
    for arch in FAMILY_ROWS:
        if budget_s is not None and \
                budget_s - (time.perf_counter() - t_start) < FAMILY_ROW_S:
            cut.append(arch)
            continue
        cfg = _config(arch, smoke)
        mesh, cell = _mesh_cell(smoke, "train_4k")
        t0 = time.perf_counter()
        c = D._lm_variant(D.depth_variant(cfg, 1), cell, mesh, dev, 0, 1)
        _require(c["kernel_launches"] == 0, f"{arch} launched a kernel")
        emit({"phase": "lm_sharded", "row": "family_train_1sb",
              "arch": cfg.name, "shape": cell.name, "mesh": mesh.tag,
              "optimizer": cfg.optimizer, "layers": c["n_layers"],
              "flops": c["flops"], "collectives": c["collectives"],
              "device_ms": c["device_ms"], "wall_ms": c["wall_ms"],
              "first_call_s": c["first_call_s"],
              "peak_allocated_bytes": c["peak_allocated_bytes"],
              "seconds": time.perf_counter() - t0})
    return cut


def run(emit, *, smoke: bool = False, device=None,
        budget_s: float = 120.0) -> dict:
    """Every row, in order; row 5 takes what is left of ``budget_s``.
    Returns ``{"seconds", "cut"}``."""
    t0 = time.perf_counter()
    decode_row(emit, smoke=smoke, device=device)
    train_row(emit, smoke=smoke, device=device)
    gpipe_rows(emit, smoke=smoke, device=device)
    pod_psum_row(emit, device=device)
    left = budget_s - (time.perf_counter() - t0)
    cut = family_rows(emit, smoke=smoke, device=device,
                      budget_s=max(0.0, left))
    out = {"seconds": time.perf_counter() - t0, "cut": cut}
    emit({"phase": "lm_sharded_done", **out})
    return out


if __name__ == "__main__":
    import json
    import sys

    rows = sys.argv[1:] or ["all"]
    out = lambda r: print(json.dumps(r, default=str), flush=True)  # noqa
    smoke = os.environ.get("SHARDED_SMOKE") == "1"
    dev = "cpu" if smoke else None
    for r in rows:
        {"all": lambda: run(out, smoke=smoke, device=dev, budget_s=1e9),
         "decode": lambda: decode_row(out, smoke=smoke, device=dev),
         "train": lambda: train_row(out, smoke=smoke, device=dev),
         "gpipe": lambda: gpipe_rows(out, smoke=smoke, device=dev),
         "psum": lambda: pod_psum_row(out, device=dev),
         "family": lambda: family_rows(out, smoke=smoke, device=dev)}[r]()
