"""The LM serving checks that ``chip_smoke.py``'s ``lm_serve`` phase runs
on the card, kept in the port so the script only calls :func:`run`.

1. **Build** the model at full width and depth in its dtype
   (``serve.inputs``): the tree's element count and every leaf's shape
   and dtype against ``param_specs``.
2. **Serve** through the entry point, ``launch/serve.main`` with
   ``--census``: its record (prefill wall, decode ms per token, tokens/s,
   peak allocated bytes, the aten ops of one decode step), the decode loop
   under ``set_sync_debug_mode("error")``, and the bounds of a decode
   step (bytes) and of the prefill (operations) from this run's shapes.
   Then, on the card, the warm prefill's wall and device time and a
   decode step's device time (:func:`timing`, ``torch.profiler``), so
   the host's share shows.
3. **Hold the full-width path in float32** on the same weights cast to
   float32, with TF32 off: the prefill's last logits against
   ``forward(mode="train")``'s last position, and the decode steps'
   logits against one teacher-forced train forward over prompt + decoded
   tokens.  With the default sizes the 2048-token prefill takes the
   flash branch (chunks of 1024) and the 2080-token forward the naive
   one, so the flash-filled cache and decode are held against naive full
   attention at full width.
4. **Card against CPU**: the config cut to :data:`CUT_LAYERS` layers at
   full width in float32, B = 1, a short prefill and a few decode steps
   on each device with the same weights and tokens.

Tolerances (3, 4): the largest absolute difference over the logits' rms
must stay within :data:`REL_TOL`.  Random weights give near-uniform
logits, so values are compared, not argmaxes.  A failed check raises
``AssertionError``.

Every function takes ``device`` (``None``: the card), so the phase can
be rehearsed on the CPU at a SMOKE size (``smoke=True``).
"""
from __future__ import annotations

import dataclasses
import time

import torch

#: the config served: the dense arch that fits one card in float32 too
ARCH = "qwen3-4b"
#: max |got - want| / rms(want) allowed in the float32 checks
REL_TOL = 1e-3
#: the card-vs-CPU run: layers kept, prompt and decoded tokens (B = 1)
CUT_LAYERS, CUT_PROMPT, CUT_TOKENS = 2, 64, 4
#: the card's published HBM rate and bf16 / fp32 dense peaks (H100 SXM)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max |got - want| / rms(want)``, in float64 on ``want``'s device."""
    got = got.to(want.device, torch.float64)
    want = want.to(torch.float64)
    return float((got - want).abs().max() / want.pow(2).mean().sqrt())


def check_tree(cfg, params) -> int:
    """Every leaf of ``params`` has its spec's shape and ``cfg.dtype``;
    returns the element count."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    specs = dict(T.tree_leaves(T.param_specs(cfg),
                               lambda x: isinstance(x, L.PSpec)))
    leaves = dict(T.tree_leaves(params))
    _require(set(leaves) == set(specs),
             f"tree paths {sorted(set(leaves) ^ set(specs))} differ")
    for path, t in leaves.items():
        _require(tuple(t.shape) == specs[path].shape and t.dtype == cfg.dtype,
                 f"{path}: {tuple(t.shape)} {t.dtype}, spec "
                 f"{specs[path].shape} {cfg.dtype}")
    return T.param_count(params)


def _fingerprint(params) -> list[float]:
    """Sums of three leaves, to see that a second build is the same."""
    leaves = (params["embed"], params["final_norm"],
              params["blocks"]["p0"]["mlp"]["w_down"])
    return [float(t.double().sum()) for t in leaves]


def bounds(cfg, batch: int, prompt_len: int, cache_len: int) -> dict:
    """The least time the card could take, from the shapes: a decode step
    reads every weight once and the K/V of ``cache_len`` positions (bytes
    over the HBM rate); the prefill does its matmuls (the output head at
    the last position only) and the causal half of its attention squares
    (operations over the dtype's dense peak)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    item = torch.finfo(cfg.dtype).bits // 8
    specs = T.tree_leaves(T.param_specs(cfg), lambda x: isinstance(x, L.PSpec))
    n_param = sum(int(torch.Size(s.shape).numel()) for _, s in specs)
    kv = sum(int(torch.Size(s[0]).numel()) for p, s in T.tree_leaves(
        T.cache_specs(cfg, batch, cache_len), T._is_cache_leaf)
        if p != "pos")
    step_bytes = (n_param + kv) * item
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.d_head
    kvd = cfg.n_kv_heads * cfg.d_head
    per_layer = d * hd + 2 * d * kvd + hd * d + 3 * d * f  # matmul weights
    tokens = batch * prompt_len
    flops = (2 * tokens * per_layer * cfg.n_layers
             + 2 * batch * cfg.n_heads * prompt_len * prompt_len * cfg.d_head
             * cfg.n_layers
             + 2 * batch * d * cfg.vocab)
    return {"decode_step_bytes": step_bytes,
            "decode_bound_ms": 1e3 * step_bytes / HBM_BYTES_PER_S,
            "decode_bound_by": "bytes",
            "prefill_flops": flops,
            "prefill_bound_ms": 1e3 * flops / PEAK_FLOPS[cfg.dtype],
            "prefill_bound_by": "operations"}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def hold_fp32(cfg, params, toks, tokens: int) -> dict:
    """Check 3 on ``params`` (already float32, ``cfg`` in float32)."""
    from repro_torch.models import transformer as T
    from repro_torch.training.train_step import (make_decode_step,
                                                 make_prefill_step)

    dev = toks.device
    if dev.type == "cuda":
        _require(not torch.backends.cuda.matmul.allow_tf32
                 and torch.get_float32_matmul_precision() == "highest",
                 "TF32 is on: the float32 checks need full float32 matmuls")
    prompt_len = toks.shape[1]
    t0 = time.perf_counter()
    with torch.no_grad():
        last, cache = make_prefill_step(
            cfg, max_len=prompt_len + tokens)(params, toks)
        e_prefill = rel_err(last, T.forward(cfg, params, toks)[0][:, -1])
        decode = make_decode_step(cfg)
        nxt = torch.argmax(last, -1)[:, None].to(torch.int32)
        fed, logits = [], []
        for _ in range(tokens):
            fed.append(nxt)
            tok, lg, cache = decode(params, cache, nxt)
            logits.append(lg)
            nxt = tok[:, None]
        del cache
        seq = torch.cat([toks] + fed, dim=1)
        full = T.forward(cfg, params, seq)[0][:, prompt_len:]
        e_decode = rel_err(torch.stack(logits, 1), full)
    _sync(dev)
    out = {"prefill_vs_train_rel": e_prefill,
           "decode_vs_teacher_forced_rel": e_decode, "rel_tol": REL_TOL,
           "logits_rms": float(full.double().pow(2).mean().sqrt()),
           "prefill_branch": T.attn_branch(cfg, prompt_len),
           "teacher_forced_len": seq.shape[1],
           "teacher_forced_branch": T.attn_branch(cfg, seq.shape[1]),
           "wall_s": time.perf_counter() - t0}
    _require(e_prefill <= REL_TOL,
             f"float32 prefill vs train: {e_prefill} > {REL_TOL}")
    _require(e_decode <= REL_TOL,
             f"float32 decode vs teacher forcing: {e_decode} > {REL_TOL}")
    return out


def _device_us(fn, reps: int) -> dict:
    """Device time per call of ``fn`` by kernel (µs, names cut to 80
    characters), from ``torch.profiler`` over ``reps`` calls; ``aten::``
    entries (the host-side operators around the kernels) and CUPTI's
    "Command Buffer Full" (the host waiting on a full launch queue, not a
    kernel) are left out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us: dict = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0 and not e.key.startswith(
                ("aten::", "Command Buffer Full")):
            us[e.key[:80]] = us.get(e.key[:80], 0.0) \
                + e.self_device_time_total / reps
    _require(bool(us), "the profiler saw no device time")
    return dict(sorted(us.items(), key=lambda kv: -kv[1]))


def timing(cfg, params, toks, tokens: int, reps: int = 3) -> dict:
    """On the card, warm: the prefill's wall (twice) and its device time,
    and a decode step's device time (at the prefilled cache; attention
    reads every slot whatever the position), each with its costliest
    kernels, so that the host's share of the served walls shows."""
    from repro_torch.training.train_step import (make_decode_step,
                                                 make_prefill_step)

    dev = toks.device
    prefill = make_prefill_step(cfg, max_len=toks.shape[1] + tokens + 1)
    decode = make_decode_step(cfg)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        last, cache = prefill(params, toks)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    del last, cache
    pre = _device_us(lambda: prefill(params, toks), 1)
    _, cache = prefill(params, toks)
    tok = toks[:, :1]
    decode(params, cache, tok)  # warm; every call writes the same slot
    dec = _device_us(lambda: decode(params, cache, tok), reps)
    return {"prefill_warm_s": walls,
            "prefill_device_ms": sum(pre.values()) / 1e3,
            "prefill_top_kernels_us": dict(list(pre.items())[:6]),
            "decode_step_device_ms": sum(dec.values()) / 1e3,
            "decode_step_kernels": len(dec),
            "decode_step_top_kernels_us": dict(list(dec.items())[:6])}


def _cut_run(cfg, params, toks, prompt_len: int) -> torch.Tensor:
    """The prefill's last logits, then each decode step's, fed ``toks``
    past the prompt; ``(1, 1 + steps, V)`` on the CPU."""
    from repro_torch.training.train_step import (make_decode_step,
                                                 make_prefill_step)

    with torch.no_grad():
        last, cache = make_prefill_step(cfg, max_len=toks.shape[1])(
            params, toks[:, :prompt_len])
        out = [last]
        decode = make_decode_step(cfg)
        for i in range(prompt_len, toks.shape[1]):
            _, lg, cache = decode(params, cache, toks[:, i:i + 1])
            out.append(lg)
    return torch.stack(out, 1).cpu()


def card_vs_cpu(cfg, *, layers: int, prompt_len: int, tokens: int,
                device=None, seed: int = 1) -> dict:
    """Check 4: the same float32 weights and tokens on ``device`` and on
    the CPU (on a CPU rehearsal, the CPU twice)."""
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.models import transformer as T

    dev, host = resolve_device(device), resolve_device("cpu")
    cut = dataclasses.replace(cfg, n_layers=layers, dtype=torch.float32)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = T.init_params(cut, gen, device=dev)
    toks = torch.randint(0, cut.vocab, (1, prompt_len + tokens),
                         generator=gen, device=dev, dtype=torch.int32)
    got = _cut_run(cut, params, toks, prompt_len)
    want = _cut_run(cut, T.tree_map(lambda a: a.to(host), params),
                    toks.to(host), prompt_len)
    err = rel_err(got, want)
    _require(err <= REL_TOL, f"card vs CPU: {err} > {REL_TOL}")
    return {"layers": layers, "prompt_len": prompt_len, "tokens": tokens,
            "device": dev.type, "rel_err": err, "rel_tol": REL_TOL,
            "wall_s": time.perf_counter() - t0}


def run(emit, *, smoke: bool = False, batch: int = 4, prompt_len: int = 2048,
        tokens: int = 32, expect_params=None, device=None) -> None:
    """All four checks on :data:`ARCH` (its SMOKE config with ``smoke``),
    each ``emit``-ted as one dict."""
    from repro_torch.configs import registry
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    dev = resolve_device(device)
    cfg = (registry.get_smoke_config(ARCH) if smoke
           else registry.get_config(ARCH))
    # 1. build
    t0 = time.perf_counter()
    params, _ = serve.inputs(cfg, batch, prompt_len, device=dev)
    _sync(dev)
    n = check_tree(cfg, params)
    _require(expect_params is None or n == expect_params,
             f"{cfg.name} has {n} parameters, expected {expect_params}")
    fingerprint = _fingerprint(params)
    del params
    emit({"phase": "lm_build", "arch": cfg.name, "params": n,
          "dtype": str(cfg.dtype), "wall_s": time.perf_counter() - t0})
    # 2. serve through the entry point
    argv = ["--arch", ARCH, "--batch", str(batch), "--prompt-len",
            str(prompt_len), "--tokens", str(tokens), "--census",
            "--device", dev.type] + (["--smoke"] if smoke else [])
    rec = serve.main(argv)
    _require(rec["decode_step_host_reads"] == 0,
             f"a decode step reads the device: {rec}")
    # a decode step attends to prompt_len + 1 ... prompt_len + tokens - 1
    # positions: the middle one stands for them
    rec.update(bounds(cfg, batch, prompt_len, prompt_len + tokens // 2))
    emit({"phase": "lm_serve", **rec})
    # 3. the same weights in float32
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    params, toks = serve.inputs(cfg, batch, prompt_len, device=dev)
    _require(_fingerprint(params) == fingerprint,
             "a second build from the same seed gave other weights")
    if dev.type == "cuda":
        t = timing(cfg, params, toks, tokens)
        t["decode_idle_share"] = max(0.0, 1 - t["decode_step_device_ms"]
                                     / rec["decode_ms_per_token"])
        emit({"phase": "lm_timing", **t})
    params = T.tree_map(lambda a: a.float(), params)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    fp32 = hold_fp32(cfg32, params, toks, tokens)
    del params, toks
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    emit({"phase": "lm_fp32", **fp32})
    # 4. card against CPU
    emit({"phase": "lm_card_vs_cpu",
          **card_vs_cpu(cfg, layers=CUT_LAYERS, prompt_len=CUT_PROMPT,
                        tokens=CUT_TOKENS, device=dev)})
