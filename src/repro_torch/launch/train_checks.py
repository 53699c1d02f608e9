"""The LM training checks that ``chip_smoke.py``'s ``train`` phase runs
on the card, kept in the port so the script only calls :func:`run`.

1. **Rows** (:data:`ROWS`), each at full width, B = 4 x 128 tokens, one
   fixed batch of the token pipeline, through ``make_train_step`` with
   the config's optimizer: qwen3-4b whole (AdamW), jamba-1.5-large-398b's
   ``mamba+mlp`` layer alone (Adafactor; the layer's 1,024,327,680
   parameters plus the embedding) and mixtral-8x7b cut to 1 layer
   (AdamW; its aux loss must be finite and above 0); the two cut rows
   drawn at :func:`unit_gain` (:data:`ROWS` says why).  Each row: the
   build against its specs and element count; a warm step, then
   :data:`STEPS` steps, each under ``set_sync_debug_mode("error")`` and
   timed to a synchronize after it; one step's device time by
   ``torch.profiler`` (so the idle share shows) and one under the op
   census (aten ops, host reads: 0); the peak allocated bytes; the loss
   falling over the steps on the fixed batch (the reference's
   ``test_train_loss_decreases``); and the step's bound, :func:`bound`.
2. **Card against CPU** (:func:`card_vs_cpu`): qwen3-4b cut to 1 layer at
   full width in float32, TF32 off, B = 1 x 64: the loss, every gradient
   leaf (each element within 1e-3 of the leaf's rms or 1e-5 of its
   largest entry; the largest difference over the rms is reported) and
   the global norm on the same weights and batch; the same gate must
   refuse the card's gradients with TF32 on and through the bfloat16
   model (its controls); then one AdamW update fed the same gradients on
   both devices.
3. **Restart** (:func:`restart`): ``run_loop`` on qwen3-4b cut to 1 layer
   (bf16, the config's dtype) with a fault injected after the first of
   two checkpoints: one restart, and the final loss of the same steps run
   uninterrupted, exactly.

A failed check raises ``AssertionError``.  Every function takes
``device`` (``None``: the card), and ``smoke=True`` runs the SMOKE
configs, so that the phase rehearses on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
import pathlib
import tempfile
import time

import torch

from repro_torch.launch.lm_serve_checks import (HBM_BYTES_PER_S, MAMBA_ARCH,
                                                MAMBA_KIND, MAMBA_PARAMS,
                                                PEAK_FLOPS, REL_TOL,
                                                _device_us, _require,
                                                _sync, check_tree, unit_gain)

#: the rows: ``arch``, the depth (``layers``) or the one layer kind
#: (``pattern``) kept, the elements expected (of the layer alone for a
#: ``pattern`` row, of the whole tree otherwise), and ``gain``: whether
#: the block leaves are drawn at :func:`unit_gain` (each at its own
#: fan-in).  The reference's rule divides a stacked leaf's std by
#: ``n_blocks``, 1 for a one-layer cut: at jamba's width (8192) a std of
#: 1 overflows the Mamba layer's float32 mean square to inf, its final
#: norm to 0 and every gradient to 0 (the loss stays log V); qwen3-4b
#: whole (std 1/6) trains on the reference's draw
ROWS = {
    "qwen3-4b": dict(arch="qwen3-4b", expect_params=4_022_468_096,
                     gain=False),
    f"{MAMBA_ARCH}[{MAMBA_KIND}]": dict(arch=MAMBA_ARCH,
                                        pattern=(MAMBA_KIND,),
                                        expect_params=MAMBA_PARAMS),
    "mixtral-8x7b[1 layer]": dict(arch="mixtral-8x7b", layers=1),
}
#: the launcher's defaults: batch, tokens a sequence, learning rate
BATCH, SEQ, LR = 4, 128, 3e-4
#: steps timed a row (after one warm step; the profiled and the census
#: steps come after them)
STEPS = 4
#: the card-vs-CPU run: layers, B, S; the optimizer update's tolerance
#: (max |diff| over each leaf's largest magnitude).  A gradient element
#: may differ by ``REL_TOL`` of its leaf's rms or ``GRAD_RTOL`` of the
#: leaf's largest entry, whichever is larger: a float32 error scales with
#: the terms summed into an element, and the embedding's rms is some
#: 1/600 of its largest entries (the rows of the batch's 64 tokens among
#: 151,936, where the head's and the lookup's terms cancel), so a few ulp
#: of those reach 2e-3 of its rms
CUT_LAYERS, CUT_BATCH, CUT_SEQ, UPDATE_TOL = 1, 1, 64, 1e-6
GRAD_RTOL = 1e-5
#: the restart hold: steps, a checkpoint every ``RESTART_EVERY`` steps, the
#: fault before step ``RESTART_FAULT`` (0-based)
RESTART_STEPS, RESTART_EVERY, RESTART_FAULT = 3, 2, 2


def config(arch: str, smoke: bool = False, layers=None, pattern=None):
    """``arch``'s config (SMOKE with ``smoke``), cut to ``layers`` or to
    one layer of each kind in ``pattern``."""
    from repro_torch.launch import train

    cfg = train.config(arch, smoke, layers)
    if pattern is not None:
        cfg = dataclasses.replace(cfg, block_pattern=tuple(pattern),
                                  n_layers=len(pattern))
    return cfg


def active_params(cfg, n: int) -> int:
    """Parameters a token's forward multiplies by: all but the experts an
    MoE layer does not route it to (``n_experts - top_k`` of them)."""
    moe_layers = sum(k.endswith("+moe") for k in cfg.block_pattern) \
        * cfg.n_blocks
    idle = max(0, cfg.n_experts - cfg.top_k)
    return n - moe_layers * idle * 3 * cfg.d_model * cfg.d_ff


def optimizer_bytes(state, params) -> int:
    """Bytes one update must move: each gradient read (in its parameter's
    dtype, as one microbatch gives it), each parameter read and written,
    each state leaf read and written (``count`` left out)."""
    from repro_torch.models import transformer as T

    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    return 3 * sum(nbytes(p) for _, p in T.tree_leaves(params)) \
        + 2 * sum(nbytes(s) for path, s in T.tree_leaves(state)
                  if path != "count")


def bound(cfg, n: int, tokens: int, opt_bytes: int) -> dict:
    """The least time a step could take: ``8 N T`` operations (forward,
    the forward recomputed under ``remat``, backward; ``6 N T`` without
    ``remat``; ``N`` the active parameters) over the dtype's dense peak,
    plus the optimizer's bytes over the HBM rate."""
    per = 8 if cfg.remat else 6
    flops = per * active_params(cfg, n) * tokens
    f_ms = 1e3 * flops / PEAK_FLOPS[cfg.dtype]
    b_ms = 1e3 * opt_bytes / HBM_BYTES_PER_S
    return {"step_flops": flops, "flops_bound_ms": f_ms,
            "optimizer_bytes": opt_bytes, "optimizer_bound_ms": b_ms,
            "step_bound_ms": f_ms + b_ms}


def _batch(cfg, batch: int, seq: int, dev, seed: int = 0) -> dict:
    from repro_torch.data.pipeline import TokenPipeline

    return {k: torch.from_numpy(v).to(dev) for k, v in TokenPipeline(
        cfg.vocab, batch, seq, seed=seed).next().items()}


def train_row(emit, name: str, *, arch: str, layers=None, pattern=None,
              expect_params=None, gain: bool = True, smoke: bool = False,
              batch: int = BATCH, seq: int = SEQ, steps: int = STEPS,
              device=None) -> None:
    """Check 1 on one row of :data:`ROWS`."""
    from repro_torch.analysis import ir
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import make_train_step

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    cfg = config(arch, smoke, layers, pattern)
    t0 = time.perf_counter()
    params = T.init_params(cfg, 0, device=dev)
    if gain:
        unit_gain(cfg, params)
    check_tree(cfg, params)
    n = T.param_count(params)
    counted = (n - T.param_count({k: v for k, v in params.items()
                                  if k != "blocks"})
               if pattern is not None else n)
    _require(expect_params is None or counted == expect_params,
             f"{name} has {counted} parameters, expected {expect_params}")
    opt = O.make_optimizer(cfg.optimizer, lr=LR)
    state = opt.init(params)
    batch_t = _batch(cfg, batch, seq, dev)
    step = make_train_step(cfg, opt)
    _sync(dev)
    build_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    metrics = []
    t0 = time.perf_counter()
    params, state, m = step(params, state, batch_t)  # warm
    metrics.append(m)
    _sync(dev)
    warm_s = time.perf_counter() - t0
    walls = []
    for _ in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        with serve.no_host_sync(dev):
            params, state, m = step(params, state, batch_t)
        _sync(dev)
        walls.append(time.perf_counter() - t0)
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    rec = {}
    if cuda:
        dev_us = _device_us(lambda: metrics.append(
            step(params, state, batch_t)[2]), 1)
        rec = {"step_device_ms": sum(dev_us.values()) / 1e3,
               "step_top_kernels_us": dict(list(dev_us.items())[:6])}
    out, c = ir.record(step, params, state, batch_t)
    metrics.append(out[2])
    _require(c.host_reads == 0, f"a {name} train step reads the device: "
             f"{[h.op for h in c.host_calls]}")
    opt_bytes = optimizer_bytes(state, params)
    losses = [float(mm["loss"]) for mm in metrics]
    last = {k: float(v) for k, v in metrics[-1].items()}
    _require(all(math.isfinite(x) for x in losses + list(last.values())),
             f"{name}: a metric is not finite: {losses} {last}")
    _require(losses[-1] < losses[0],
             f"{name}: the loss did not fall on a fixed batch: {losses}")
    if any(k.endswith("+moe") for k in cfg.block_pattern):
        _require(last["aux"] > 0, f"{name}: the MoE aux loss is {last}")
    wall_ms = 1e3 * sorted(walls)[len(walls) // 2]
    rec.update(bound(cfg, n, batch * seq, opt_bytes))
    if "step_device_ms" in rec:
        rec["idle_share"] = max(0.0, 1 - rec["step_device_ms"] / wall_ms)
    emit({"phase": "train", "row": name, "arch": cfg.name,
          "n_layers": cfg.n_layers, "pattern": list(cfg.block_pattern),
          "params": n, "layer_params": counted, "optimizer": cfg.optimizer,
          "unit_gain": gain,
          "dtype": str(cfg.dtype), "device": dev.type, "batch": batch,
          "seq": seq, "build_s": build_s, "warm_step_s": warm_s,
          "step_wall_ms": wall_ms, "step_walls_s": walls,
          "peak_allocated_bytes": peak, "step_aten_ops": c.op_count,
          "step_host_reads": c.host_reads,
          "step_top_ops": dict(sorted(c.op_counts.items(),
                                      key=lambda kv: -kv[1])[:6]),
          "losses": losses, "metrics": last, **rec})
    del params, state, batch_t, metrics, out, c
    if cuda:
        torch.cuda.empty_cache()


class _TF32:
    """float32 matmuls and convolutions in TF32 (``on``) or in float32
    inside."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def _grad_gate(grads, wgrads: dict) -> dict:
    """The gradient gate of check 2, leaf by leaf: the elements outside
    their tolerance (``REL_TOL`` of the leaf's rms or ``GRAD_RTOL`` of its
    largest entry, whichever is larger), the largest difference over that
    tolerance, over the rms and over the largest entry."""
    from repro_torch.models import transformer as T

    out = {"outside": {}, "over_tol": {}, "over_rms": {}, "over_max": {}}
    for path, g in T.tree_leaves(grads):
        w = wgrads[path]
        d = float((g.float() - w).abs().max())
        rms, big = float(w.pow(2).mean().sqrt()), float(w.abs().max())
        tol = max(REL_TOL * rms, GRAD_RTOL * big)
        out["outside"][path] = int(((g.float() - w).abs() > tol).sum())
        out["over_tol"][path] = d / tol
        out["over_rms"][path] = d / rms
        out["over_max"][path] = d / big
    return out


def card_vs_cpu(emit, *, smoke: bool = False, device=None) -> None:
    """Check 2 (on the CPU rehearsal: the CPU twice).  The CPU computes
    only the gradients and the update; every comparison runs on
    ``device``, the CPU's results copied there.  The gradient gate must
    also refuse two controls of lower precision on ``device``, the same
    weights and batch: the gradients with TF32 matmuls (on the card
    only) and through the bfloat16 model."""
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as S

    dev, host = resolve_device(device), resolve_device("cpu")
    cfg = dataclasses.replace(config("qwen3-4b", smoke, CUT_LAYERS),
                              dtype=torch.float32)
    walls = {}
    t0 = time.perf_counter()
    params = T.init_params(cfg, 0, device=dev)
    batch = _batch(cfg, CUT_BATCH, CUT_SEQ, dev, seed=1)
    grad_fn = S.value_and_grad(S.make_loss_fn(cfg))
    on = {}
    with _TF32(False):
        for where in (dev, host):
            t1 = time.perf_counter()
            p = T.tree_map(lambda a: a.to(where), params)
            (loss, _), g = grad_fn(p, {k: v.to(where)
                                       for k, v in batch.items()})
            on[where.type] = dict(p=p, loss=float(loss), grads=g,
                                  norm=float(O.global_norm(g)))
            walls[f"grads_{where.type}_s"] = time.perf_counter() - t1
    got, want = on[dev.type], on["cpu"]
    t1 = time.perf_counter()
    wgrads = {path: w.to(dev) for path, w in T.tree_leaves(want["grads"])}
    gate = _grad_gate(got["grads"], wgrads)
    grad_err, outside = gate["over_rms"], gate["outside"]
    loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    norm_err = abs(got["norm"] - want["norm"]) / want["norm"]
    worst = max(grad_err.values())
    walls["compare_s"] = time.perf_counter() - t1
    _require(max(loss_err, norm_err) <= REL_TOL and not any(outside.values()),
             f"train card vs CPU: loss {loss_err}, norm {norm_err}, grads "
             f"{grad_err}, elements outside {outside}")
    # the controls: the gate must refuse each
    t1 = time.perf_counter()
    controls = {}
    batch_dev = {k: v.to(dev) for k, v in batch.items()}
    if dev.type == "cuda":
        with _TF32(True):
            _, g = grad_fn(got["p"], batch_dev)
        controls["tf32"] = _grad_gate(g, wgrads)
    bcfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    _, g = S.value_and_grad(S.make_loss_fn(bcfg))(
        T.tree_map(lambda a: a.to(torch.bfloat16), got["p"]), batch_dev)
    controls["bf16"] = _grad_gate(g, wgrads)
    del g
    walls["controls_s"] = time.perf_counter() - t1
    for name, c in controls.items():
        _require(any(c["outside"].values()),
                 f"train card vs CPU: the gate passes the {name} control "
                 f"({c['over_tol']})")
    # one update fed the CPU's gradients on both devices, each on its own
    # copy of the same weights
    t1 = time.perf_counter()
    opt = O.make_optimizer("adamw", lr=LR)
    updated = []
    for p, g in ((got["p"], T._unflatten(params, wgrads, _is_leaf)),
                 (want["p"], want["grads"])):
        p = T.tree_map(torch.clone, p)
        st = opt.init(p)
        opt.update(g, st, p)
        updated.append((p, st))
    walls["update_s"] = time.perf_counter() - t1
    (pd, sd), (ph, sh) = updated
    update_err = 0.0
    for a, b in ((pd, ph), (sd["mu"], sh["mu"]), (sd["nu"], sh["nu"])):
        wl = dict(T.tree_leaves(b))
        for path, t in T.tree_leaves(a):
            w = wl[path].to(dev)
            update_err = max(update_err, float(
                (t - w).abs().max() / w.abs().max().clamp_min(1e-30)))
    _require(update_err <= UPDATE_TOL,
             f"the AdamW update on the card vs the CPU: {update_err}")
    emit({"phase": "train_card_vs_cpu", "arch": cfg.name,
          "layers": cfg.n_layers, "params": T.param_count(params),
          "batch": CUT_BATCH, "seq": CUT_SEQ, "device": dev.type,
          "loss": want["loss"], "loss_rel_err": loss_err,
          "grad_norm_rel_err": norm_err, "grad_rel_err_max": worst,
          "grad_rel_err_leaf": max(grad_err, key=grad_err.get),
          "grad_rel_err": grad_err, "rel_tol": REL_TOL,
          "grad_rtol": GRAD_RTOL,
          "gate_over_tol_max": max(gate["over_tol"].values()),
          "gate_over_max_max": max(gate["over_max"].values()),
          "controls": {name: {
              "elements_outside": sum(c["outside"].values()),
              "leaves_outside": sum(n > 0 for n in c["outside"].values()),
              "over_tol_max": max(c["over_tol"].values()),
              "over_rms_max": max(c["over_rms"].values()),
              "over_tol_leaf": max(c["over_tol"], key=c["over_tol"].get)}
              for name, c in controls.items()},
          "update_rel_err": update_err,
          "update_tol": UPDATE_TOL, "wall_s": time.perf_counter() - t0,
          **walls})
    del params, got, want, on, wgrads, updated
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _is_leaf(x) -> bool:
    return not isinstance(x, dict)


def _dir_bytes(path: pathlib.Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def restart(emit, *, smoke: bool = False, device=None,
            batch: int = BATCH, seq: int = SEQ) -> None:
    """Check 3: the clean run (the same steps from the same state,
    uninterrupted and written nowhere) against ``run_loop`` with a fault
    injected before step :data:`RESTART_FAULT`, after its first
    checkpoint, each from ``init_params`` seed 0 and the pipeline's seed
    0."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.runtime.fault import run_loop
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import make_train_step

    dev = resolve_device(device)
    cfg = train.config("qwen3-4b", smoke, CUT_LAYERS)
    opt = O.make_optimizer(cfg.optimizer, lr=LR)
    step = make_train_step(cfg, opt)

    def make_state():
        params = T.init_params(cfg, 0, device=dev)
        return params, opt.init(params)

    def step_fn(params, opt_state, b):
        return step(params, opt_state,
                    {k: torch.from_numpy(v).to(dev) for k, v in b.items()})

    def pipeline():
        return TokenPipeline(cfg.vocab, batch, seq, seed=0)

    t0 = time.perf_counter()
    params, opt_state = make_state()
    pipe = pipeline()
    for _ in range(RESTART_STEPS):
        params, opt_state, m = step_fn(params, opt_state, pipe.next())
    clean_loss = float(m["loss"])
    del params, opt_state, m
    clean_s = time.perf_counter() - t0
    fired = []

    def hook(i):
        if i == RESTART_FAULT and not fired:
            fired.append(i)
            raise RuntimeError("injected fault")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        fault = run_loop(ckpt_dir=tmp, total_steps=RESTART_STEPS,
                         make_state=make_state, step_fn=step_fn,
                         pipeline=pipeline(), ckpt_every=RESTART_EVERY,
                         fault_hook=hook, device=dev)
        written = _dir_bytes(pathlib.Path(tmp))
        ckpts = sorted(p.name for p in pathlib.Path(tmp).iterdir())
    fault_s = time.perf_counter() - t0
    _require(fault.restarts == 1 and fault.steps_done == RESTART_STEPS,
             f"restarts {fault.restarts}, steps {fault.steps_done}")
    _require(fault.last_loss == clean_loss,
             f"the restarted run's loss {fault.last_loss} != the clean "
             f"run's {clean_loss}")
    emit({"phase": "train_restart", "arch": cfg.name,
          "layers": cfg.n_layers, "dtype": str(cfg.dtype),
          "device": dev.type, "batch": batch, "seq": seq,
          "steps": RESTART_STEPS, "ckpt_every": RESTART_EVERY,
          "fault_before_step": RESTART_FAULT, "restarts": fault.restarts,
          "clean_loss": clean_loss, "restarted_loss": fault.last_loss,
          "checkpoints": ckpts, "bytes_written": written,
          "clean_s": clean_s, "faulty_s": fault_s,
          "step_s_faulty": fault.step_times})


def run(emit, *, smoke: bool = False, device=None) -> None:
    """Every row of :data:`ROWS`, then :func:`card_vs_cpu` and
    :func:`restart`."""
    for name, row in ROWS.items():
        if smoke:
            row = {k: v for k, v in row.items() if k != "expect_params"}
        t0 = time.perf_counter()
        train_row(emit, name, smoke=smoke, device=device, **row)
        emit({"phase": "train_row_done", "row": name,
              "seconds": time.perf_counter() - t0})
    card_vs_cpu(emit, smoke=smoke, device=device)
    restart(emit, smoke=smoke, device=device)
