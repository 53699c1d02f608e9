"""The LM serving checks that ``chip_smoke.py``'s ``lm_serve`` phase runs
on the card, kept in the port so the script only calls :func:`run` (one
arch: a row of :data:`ROWS`) and :func:`mamba_layer` (jamba's Mamba layer
at full width, and its SMOKE config whole).

1. **Build** the model at full width, whole or cut in depth (a multiple
   of its block pattern), in its dtype (``serve.inputs``): the tree's
   element count and every leaf's shape and dtype against
   ``param_specs``.
2. **Serve** through the entry point, ``launch/serve.main`` with
   ``--census`` (and ``--layers`` for a depth cut): its record (prefill
   wall, decode ms per token, tokens/s, peak allocated bytes, the aten ops
   of one decode step, no host read in it), the decode loop under
   ``set_sync_debug_mode("error")``, and the bounds of a decode step
   (bytes) and of the prefill (operations) from this run's shapes and
   the family's layers (:func:`bounds`).  Then, on the card, the warm
   prefill's wall and device time and a decode step's device time
   (:func:`timing`, ``torch.profiler``), so the host's share shows.
3. **Hold the path in float32**, TF32 off: the prefill's last logits
   against ``forward(mode="train")``'s last position, and the decode
   steps' logits against one teacher-forced train forward over prompt +
   decoded tokens.  On the same weights cast to float32 where the model
   fits the card in float32; else on a depth cut built anew from the
   seed in float32 (never a float32 copy of a bf16 tree that would not
   fit); for the families whose attention the reference's draw makes
   one-hot, each normal leaf at its layer's own gain (:func:`unit_gain`:
   there a float32 difference of one ulp grows past the tolerance
   whatever the path).  An MoE arch's decode chain is held at
   ``capacity_factor`` = ``n_experts``, so that the full sequence drops
   no entry a decode step keeps (the reference's own decode test does so
   at 32); its prefill against train keeps the config's factor (same
   sequence, same drops); and it is held in float64 (``hold_dtype``: in
   float32 a near-tie of the router flips an expert, :data:`ROWS`).
4. **Card against CPU**: the config cut to a depth (or one layer of a
   kind) that the host's memory holds, at full width in float32 (drawn
   as in 3), B = 1,
   a short prefill and a few decode steps on each device with the same
   weights and tokens.

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

#: the dense arch of the first slice (the default of :func:`run`)
ARCH = "qwen3-4b"
#: max |got - want| / rms(want) allowed in the float32 checks
REL_TOL = 1e-3
#: the card-vs-CPU run: layers kept, prompt and decoded tokens (B = 1)
CUT_LAYERS, CUT_PROMPT, CUT_TOKENS = 2, 64, 4
#: the card's published HBM rate and bf16 / fp32 dense peaks (H100 SXM)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: each family's row on the card, :func:`run`'s keywords: ``layers`` the
#: depth served (``None``: whole), ``fp32_layers`` the depth held in
#: float32 (``None``: the served weights cast), ``fp32_batch`` its batch
#: (``None``: the served one), the card-vs-CPU cut, ``cut_layers``
#: layers or the one layer ``cut_pattern``, and ``gain``: whether checks 3
#: and 4 draw at :func:`unit_gain` (the families whose attention the
#: reference's draw makes one-hot) or keep the reference's draw (qwen3-4b,
#: with qk-norm over 36 blocks, and rwkv6-1.6b, which has no attention),
#: and ``hold_dtype``, check 3's dtype: float64 for the MoE arch, whose
#: 2048-token prefill and 2080-token teacher forcing round their hidden
#: states differently in float32, so that a near-tie among the router's
#: 16,384 top-2 choices flips an expert at some earlier position and
#: changes its K/V at every later layer; and for rwkv6-1.6b, whose float32
#: decode chain on its served weights cast to float32 misses teacher
#: forcing by more than the tolerance at 24 layers (the chunked form and
#: the step-by-step recurrence round the projections and the state
#: differently, and the stack amplifies it).
#: An SSM arch's prompt plus tokens is a multiple of its ``ssm_chunk``
#: (64), which the teacher-forced forward needs.
ROWS = {
    "qwen3-4b": dict(prompt_len=2048, tokens=32, gain=False,
                     expect_params=4_022_468_096),
    "rwkv6-1.6b": dict(prompt_len=2048, tokens=64, cut_layers=1,
                       gain=False, hold_dtype=torch.float64,
                       expect_params=1_449_723_904),
    "whisper-tiny": dict(prompt_len=384, tokens=64, cut_layers=4,
                         expect_params=41_159_808),
    "mixtral-8x7b": dict(layers=16, prompt_len=2048, tokens=32,
                         fp32_layers=4, fp32_batch=1, cut_layers=1,
                         hold_dtype=torch.float64,
                         expect_params=23_351_398_400),
    "llama-3.2-vision-90b": dict(layers=10, prompt_len=2048, tokens=32,
                                 fp32_layers=5, cut_pattern=("cross+mlp",),
                                 expect_params=9_607_225_344),
}
#: jamba's layer held at full width (:func:`mamba_layer`)
MAMBA_ARCH, MAMBA_KIND = "jamba-1.5-large-398b", "mamba+mlp"
MAMBA_PARAMS = 1_024_327_680


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
    """Sums of three leaves, to see that a second build is the same (in
    float64, 2^26 elements at a time, summed on the device: a float64
    copy of mixtral's 7.5G-element expert leaf would not fit)."""
    from repro_torch.models import transformer as T

    leaves = (params["embed"], params["final_norm"],
              T.tree_leaves(params["blocks"])[-1][1])
    out = []
    for t in leaves:
        flat = t.reshape(-1)
        step = 1 << 26  # elements a float64 slice
        out.append(float(sum(flat[i:i + step].double().sum()
                             for i in range(0, flat.numel(), step))))
    return out


def _fan_in(path: str, shape: tuple) -> int:
    """The width a block leaf of this (unstacked) shape contracts over in
    the forward: an expert matrix's per-expert input, the attention
    output's heads x head dim, else its first dim."""
    name = path.rsplit(".", 1)[-1]
    if ".moe." in path and len(shape) == 3:
        return shape[1]
    if name == "wo":
        return shape[0] * shape[1]
    return shape[0]


def unit_gain(cfg, params) -> dict:
    """``params`` (drawn by ``init_params``) rescaled IN PLACE so that every
    normal leaf of the blocks (and the encoder's) has std ``scale /
    sqrt(fan_in)`` with the width it contracts over (:func:`_fan_in`),
    where the reference's rule divides by the stacked spec's first dim,
    ``n_blocks``.  The reference's draw makes these random models
    chaotic where they attend: at whisper-tiny's width (``n_blocks`` 4,
    std 0.5 over 384 inputs) the attention is one-hot, and a decode chain
    differs from its teacher-forced forward by more than the tolerance in
    float32 (and, at B = 4, even in float64), whatever the path.  The
    float32 checks (3, 4) of those families run on this draw: the same
    normal numbers at each layer's own gain.  RWKV6 keeps the reference's
    draw (no attention; at its 24 layers that draw is the better
    conditioned of the two)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    specs = dict(T.tree_leaves(T.param_specs(cfg), T._is_spec))
    with torch.no_grad():
        for path, t in T.tree_leaves(params):
            spec = specs[path]
            if spec.init != "normal" or not path.startswith(
                    ("blocks.", "encoder.blocks.")):
                continue
            want = spec.scale / float(_fan_in(path, spec.shape[1:])) ** 0.5
            t.mul_(want / float(L.init_std(spec)))
    return params


def _numel(shape) -> int:
    return int(torch.Size(shape).numel())


def _causal_pairs(s: int, window) -> float:
    """(query, key) pairs a causal sequence of ``s`` attends: ``s^2 / 2``,
    or ``s w - w^2 / 2`` under a window ``w < s``."""
    if window and window < s:
        return s * window - window * window / 2
    return s * s / 2


def layer_flops(cfg, kind: str, batch: int, s: int, ext_len: int = 0,
                ) -> float:
    """Operations of one layer over ``batch`` sequences of ``s`` tokens
    (2 a multiply-add): the matmuls, the attention's score pairs (4 a
    pair and head dim: QK and PV), and, for MoE, only the ``top_k``
    experts a token goes to, plus the router.  Elementwise work is not
    counted."""
    from repro_torch.models import rwkv as R
    from repro_torch.models import transformer as T

    mixer, ffn = T._mixer_ffn(kind)
    d, t = cfg.d_model, batch * s
    hd, kvd = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    f = 0.0
    if mixer in ("attn", "attn_cross"):
        f += 2 * t * (d * hd + 2 * d * kvd + hd * d)
        f += 4 * batch * cfg.n_heads * cfg.d_head * _causal_pairs(
            s, cfg.window)
    if mixer in ("cross", "attn_cross"):
        f += 2 * t * (d * hd + hd * d)  # queries and output
        f += 2 * batch * ext_len * 2 * d * kvd  # K/V of the frames/patches
        f += 4 * batch * cfg.n_heads * cfg.d_head * s * ext_len
    if mixer == "mamba":
        di, n = cfg.d_inner, cfg.d_state
        dt_rank = max(1, d // 16)
        f += 2 * t * (d * 2 * di + di * cfg.d_conv + di * (dt_rank + 2 * n)
                      + dt_rank * di + di * n + di * d)
    if mixer == "rwkv":
        h, dk = R._heads(cfg)
        c = min(cfg.ssm_chunk, s)
        f += 2 * t * (5 * d * d + 2 * d * R.LORA_R)  # r k v g o, decay LoRA
        f += 2 * t * (2 * d * cfg.d_ff + d * d)  # channel mix
        f += 2 * t * h * (2 * dk * dk + 2 * c * dk)  # the chunked wkv
    if ffn == "mlp":
        f += 2 * t * 3 * d * cfg.d_ff
    elif ffn == "moe":
        f += 2 * t * (d * cfg.n_experts + cfg.top_k * 3 * d * cfg.d_ff)
    return f


def _moe_untouched(cfg, batch: int) -> int:
    """Expert weights a decode step of ``batch`` tokens cannot read: at
    most ``batch * top_k`` of each MoE layer's experts are touched."""
    moe_layers = sum(k.endswith("+moe") for k in cfg.block_pattern) \
        * cfg.n_blocks
    idle = max(0, cfg.n_experts - batch * cfg.top_k)
    return moe_layers * idle * 3 * cfg.d_model * cfg.d_ff


#: cache leaves a decode step reads and writes whole (the recurrent
#: states); the rest (K/V, cross K/V) it reads, writing one slot
RECURRENT = ("ssm", "conv", "wkv", "tm_x", "cm_x")


def bounds(cfg, batch: int, prompt_len: int, cache_len: int) -> dict:
    """The least time the card could take, from the shapes: a decode step
    reads every decoder weight once (an MoE layer only the experts its
    ``batch * top_k`` tokens can touch; the encoder not at all), the
    cache's K/V and cross K/V, and reads and writes the recurrent states
    (``ssm``, ``conv``, ``wkv``, ``tm_x``, ``cm_x``) in their own dtypes
    (bytes over the HBM rate); the prefill does :func:`layer_flops` for
    every layer, the encoder's bidirectional blocks over its frames and
    the output head at the last position only (operations over the
    dtype's dense peak)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    item = torch.finfo(cfg.dtype).bits // 8
    specs = T.tree_leaves(T.param_specs(cfg), lambda x: isinstance(x, L.PSpec))
    n_dec = sum(_numel(s.shape) for p, s in specs
                if not p.startswith("encoder."))
    n_read = n_dec - _moe_untouched(cfg, batch)
    cache = 0
    for path, (shape, _, dtype) in T.tree_leaves(
            T.cache_specs(cfg, batch, cache_len), T._is_cache_leaf):
        if path != "pos":
            n = _numel(shape) * (torch.finfo(dtype).bits // 8)
            cache += 2 * n if path.rsplit(".", 1)[-1] in RECURRENT else n
    step_bytes = n_read * item + cache
    ext_len = (cfg.enc_len if cfg.is_encoder_decoder else cfg.img_tokens)
    flops = sum(layer_flops(cfg, kind, batch, prompt_len, ext_len)
                for kind in cfg.block_pattern) * cfg.n_blocks
    if cfg.is_encoder_decoder:
        enc = dataclasses.replace(cfg, window=None)
        flops += cfg.n_enc_layers * (layer_flops(
            enc, "attn+mlp", batch, cfg.enc_len)
            + 4 * batch * cfg.n_heads * cfg.d_head * cfg.enc_len ** 2 / 2)
    flops += 2 * batch * cfg.d_model * cfg.vocab
    return {"decode_step_bytes": step_bytes,
            "decode_weight_bytes": n_read * item,
            "decode_cache_bytes": cache,
            "decode_bound_ms": 1e3 * step_bytes / HBM_BYTES_PER_S,
            "decode_bound_by": "bytes",
            "prefill_flops": flops,
            "prefill_bound_ms": 1e3 * flops / PEAK_FLOPS[cfg.dtype],
            "prefill_bound_by": "operations"}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def nodrop(cfg):
    """``cfg`` with ``capacity_factor = n_experts`` for an MoE arch (each
    expert can take every token's ``top_k`` entries: nothing is dropped),
    else ``cfg``."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))


def measure_hold(cfg, params, toks, tokens: int, ext=None) -> dict:
    """Check 3's measurements on ``params`` (in ``cfg``'s dtype): the
    prefill against train at ``cfg``, the decode chain against teacher
    forcing at :func:`nodrop` ``(cfg)``; :func:`hold_fp32` gates them."""
    from repro_torch.models import transformer as T
    from repro_torch.training.train_step import (make_decode_step,
                                                 make_prefill_step)

    dev = toks.device
    if dev.type == "cuda":
        _require(not torch.backends.cuda.matmul.allow_tf32
                 and torch.get_float32_matmul_precision() == "highest",
                 "TF32 is on: the float32 checks need full float32 matmuls")
    prompt_len = toks.shape[1]
    chain_cfg = nodrop(cfg)
    t0 = time.perf_counter()
    with torch.no_grad():
        last, cache = make_prefill_step(
            cfg, max_len=prompt_len + tokens)(params, toks, ext)
        e_prefill = rel_err(last, T.forward(cfg, params, toks,
                                            ext_embed=ext)[0][:, -1])
        if chain_cfg is not cfg:
            del cache
            last, cache = make_prefill_step(
                chain_cfg, max_len=prompt_len + tokens)(params, toks, ext)
        decode = make_decode_step(chain_cfg)
        nxt = torch.argmax(last, -1)[:, None].to(torch.int32)
        fed, logits = [], []
        for _ in range(tokens):
            fed.append(nxt)
            tok, lg, cache = decode(params, cache, nxt)
            logits.append(lg)
            nxt = tok[:, None]
        del cache
        seq = torch.cat([toks] + fed, dim=1)
        full = T.forward(chain_cfg, params, seq,
                         ext_embed=ext)[0][:, prompt_len:]
        e_decode = rel_err(torch.stack(logits, 1), full)
    _sync(dev)
    out = {"prefill_vs_train_rel": e_prefill,
           "decode_vs_teacher_forced_rel": e_decode, "rel_tol": REL_TOL,
           "logits_rms": float(full.double().pow(2).mean().sqrt()),
           "n_layers": cfg.n_layers, "batch": toks.shape[0],
           "prompt_len": prompt_len, "tokens": tokens,
           "prefill_branch": T.attn_branch(cfg, prompt_len),
           "teacher_forced_len": seq.shape[1],
           "teacher_forced_branch": T.attn_branch(cfg, seq.shape[1]),
           "chain_capacity_factor": (chain_cfg.capacity_factor
                                     if cfg.n_experts else None),
           "wall_s": time.perf_counter() - t0}
    return out


def hold_fp32(cfg, params, toks, tokens: int, ext=None) -> dict:
    """Check 3: :func:`measure_hold`, each error within :data:`REL_TOL`."""
    out = measure_hold(cfg, params, toks, tokens, ext)
    e_prefill = out["prefill_vs_train_rel"]
    e_decode = out["decode_vs_teacher_forced_rel"]
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

    # the device's activity only: the host's operator events add nothing
    # to the kernels' times, and an SSM prefill has some 30,000 of them
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def timing(cfg, params, toks, tokens: int, reps: int = 3,
           ext=None) -> dict:
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
        last, cache = prefill(params, toks, ext)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    del last, cache
    pre = _device_us(lambda: prefill(params, toks, ext), 1)
    _, cache = prefill(params, toks, ext)
    tok = toks[:, :1]
    decode(params, cache, tok)  # warm; every call writes the same slot
    dec = _device_us(lambda: decode(params, cache, tok), reps)
    return {"prefill_warm_s": walls,
            "prefill_device_ms": sum(pre.values()) / 1e3,
            "prefill_top_kernels_us": dict(list(pre.items())[:6]),
            "decode_step_device_ms": sum(dec.values()) / 1e3,
            "decode_step_kernels": len(dec),
            "decode_step_top_kernels_us": dict(list(dec.items())[:6])}


def _cut_run(cfg, params, toks, prompt_len: int, ext=None) -> torch.Tensor:
    """The prefill's last logits, then each decode step's, fed ``toks``
    past the prompt; ``(1, 1 + steps, V)`` on the CPU."""
    from repro_torch.training.train_step import (make_decode_step,
                                                 make_prefill_step)

    with torch.no_grad():
        last, cache = make_prefill_step(cfg, max_len=toks.shape[1])(
            params, toks[:, :prompt_len], ext)
        out = [last]
        decode = make_decode_step(cfg)
        for i in range(prompt_len, toks.shape[1]):
            _, lg, cache = decode(params, cache, toks[:, i:i + 1])
            out.append(lg)
    return torch.stack(out, 1).cpu()


def cut(cfg, *, layers=None, pattern=None):
    """``cfg`` cut in depth to ``layers``, or to one repeat of ``pattern``
    (a layer kind alone: llama-vision's ``cross+mlp``), in float32."""
    if pattern is not None:
        return dataclasses.replace(cfg, block_pattern=tuple(pattern),
                                   n_layers=len(pattern),
                                   dtype=torch.float32)
    return dataclasses.replace(cfg, n_layers=layers, dtype=torch.float32)


def card_vs_cpu(cfg, *, layers=None, pattern=None, prompt_len: int,
                tokens: int, device=None, seed: int = 1,
                gain: bool = True) -> dict:
    """Check 4: the same float32 weights, tokens (and external
    embeddings) on ``device`` and on the CPU (on a CPU rehearsal, the CPU
    twice)."""
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    dev, host = resolve_device(device), resolve_device("cpu")
    small = cut(cfg, layers=layers, pattern=pattern)
    t0 = time.perf_counter()
    params, toks, ext = serve.inputs(small, 1, prompt_len + tokens,
                                     seed=seed, device=dev)
    if gain:
        unit_gain(small, params)
    got = _cut_run(small, params, toks, prompt_len, ext)
    params = T.tree_map(lambda a: a.to(host), params)
    want = _cut_run(small, params, toks.to(host), prompt_len,
                    None if ext is None else ext.to(host))
    err = rel_err(got, want)
    _require(err <= REL_TOL, f"card vs CPU: {err} > {REL_TOL}")
    return {"arch": cfg.name, "layers": small.n_layers,
            "pattern": list(small.block_pattern),
            "params": T.param_count(params), "prompt_len": prompt_len,
            "tokens": tokens, "device": dev.type, "unit_gain": gain,
            "rel_err": err, "rel_tol": REL_TOL,
            "wall_s": time.perf_counter() - t0}


def config(arch: str, smoke: bool = False, layers=None):
    """``arch``'s config (SMOKE with ``smoke``), cut to ``layers``."""
    from repro_torch.configs import registry

    cfg = (registry.get_smoke_config(arch) if smoke
           else registry.get_config(arch))
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def run(emit, *, arch: str = ARCH, smoke: bool = False, batch: int = 4,
        prompt_len: int = 2048, tokens: int = 32, layers=None,
        expect_params=None, fp32_layers=None, fp32_batch=None,
        cut_layers=CUT_LAYERS, cut_pattern=None, gain: bool = True,
        hold_dtype=torch.float32, device=None) -> None:
    """All four checks on ``arch`` (its SMOKE config with ``smoke``),
    served at ``layers`` (``None``: whole), each ``emit``-ted as one dict
    (the keywords: :data:`ROWS`)."""
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    dev = resolve_device(device)
    cfg = config(arch, smoke, layers)
    # 1. build
    t0 = time.perf_counter()
    params, _, _ = serve.inputs(cfg, batch, prompt_len, device=dev)
    _sync(dev)
    n = check_tree(cfg, params)
    _require(expect_params is None or n == expect_params,
             f"{cfg.name} has {n} parameters, expected {expect_params}")
    fingerprint = _fingerprint(params)
    del params
    emit({"phase": "lm_build", "arch": cfg.name, "n_layers": cfg.n_layers,
          "params": n, "dtype": str(cfg.dtype),
          "wall_s": time.perf_counter() - t0})
    # 2. serve through the entry point
    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len",
            str(prompt_len), "--tokens", str(tokens), "--census",
            "--device", dev.type] + (["--smoke"] if smoke else []) \
        + (["--layers", str(layers)] if layers is not None else [])
    t0 = time.perf_counter()
    rec = serve.main(argv)
    rec["wall_s"] = time.perf_counter() - t0
    _require(rec["decode_step_host_reads"] == 0,
             f"a decode step reads the device: {rec}")
    _require(rec["params"] == n, f"the launcher built {rec['params']}")
    # a decode step attends to prompt_len + 1 ... prompt_len + tokens - 1
    # positions: the middle one stands for them
    rec.update(bounds(cfg, batch, prompt_len, prompt_len + tokens // 2))
    emit({"phase": "lm_serve", **rec})
    # 3. timing on the same weights, then float32
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params, toks, ext = serve.inputs(cfg, batch, prompt_len, device=dev)
    _require(_fingerprint(params) == fingerprint,
             "a second build from the same seed gave other weights")
    if dev.type == "cuda":
        t = timing(cfg, params, toks, tokens, ext=ext)
        t["decode_idle_share"] = max(0.0, 1 - t["decode_step_device_ms"]
                                     / rec["decode_ms_per_token"])
        emit({"phase": "lm_timing", "arch": cfg.name,
              "wall_s": time.perf_counter() - t0, **t})
    t0 = time.perf_counter()
    if fp32_layers is None and fp32_batch is None:
        params = T.tree_map(lambda a: a.to(hold_dtype), params)
        ext = None if ext is None else ext.to(hold_dtype)
        cfg32 = dataclasses.replace(cfg, dtype=hold_dtype)
    else:
        # a cut built anew in float32: a float32 copy of the served tree
        # would not fit beside it
        del params, toks, ext
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(config(arch, smoke, fp32_layers),
                                    dtype=hold_dtype)
        params, toks, ext = serve.inputs(cfg32, fp32_batch or batch,
                                         prompt_len, device=dev)
    if gain:
        unit_gain(cfg32, params)
    _sync(dev)
    build_s = time.perf_counter() - t0
    fp32 = hold_fp32(cfg32, params, toks, tokens, ext)
    fp32.update(build_s=build_s, unit_gain=gain, dtype=str(hold_dtype))
    del params, toks, ext
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    emit({"phase": "lm_fp32", "arch": cfg.name, **fp32})
    # 4. card against CPU
    emit({"phase": "lm_card_vs_cpu",
          **card_vs_cpu(cfg, layers=cut_layers, pattern=cut_pattern,
                        prompt_len=CUT_PROMPT, tokens=CUT_TOKENS,
                        device=dev, gain=gain)})
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _layer_step(cfg, kind, p, x, cache=None, mode="train"):
    from repro_torch.models import transformer as T

    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device).expand(b, s)
    return T.apply_layer(cfg, kind, p, x, positions=pos, cache=cache,
                         mode=mode)


def _layer_chain(cfg, kind, p, x, prompt_len: int):
    """One layer prefilled on ``x[:, :prompt_len]``, then decoded a
    position at a time: ``(prefill out, decode outs (B, steps, D))``."""
    with torch.no_grad():
        y, cache, _ = _layer_step(cfg, kind, p, x[:, :prompt_len],
                                  mode="prefill")
        outs = []
        for i in range(prompt_len, x.shape[1]):
            o, cache, _ = _layer_step(cfg, kind, p, x[:, i:i + 1], cache,
                                      mode="decode")
            outs.append(o)
    return y, torch.cat(outs, 1) if outs else None


def mamba_layer(emit, *, smoke: bool = False, batch: int = 4,
                prompt_len: int = 2048, tokens: int = 64,
                expect_params=None, device=None) -> None:
    """Jamba's ``mamba+mlp`` layer at full width (its ``layer_specs`` drawn
    by ``init_param``, run through ``apply_layer``), which the card holds
    where the whole model (an 8-layer repeat of 89 GB in bf16) does not:
    prefilled on ``batch`` x ``prompt_len`` standard-normal inputs and
    decoded ``tokens`` steps in bf16 (the loop under sync-debug "error",
    one step under the op census, walls and the layer's bounds); held in
    float32 (prefill against train, the decode chain against one train
    pass over ``prompt_len + tokens`` positions); the same layer on the
    card against the CPU; then jamba's SMOKE config served whole on the
    card through ``launch/serve.main`` (its ``attn+moe`` and ``mamba+moe``
    layers and the hybrid cache) and held against the CPU."""
    from repro_torch.analysis import ir
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    cfg = config(MAMBA_ARCH, smoke)
    name = f"{cfg.name}[{MAMBA_KIND}]"
    specs = T.layer_specs(cfg, MAMBA_KIND)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    leaves = {path: L.init_param(gen, ps, cfg.dtype, dev)
              for path, ps in T.tree_leaves(specs, T._is_spec)}
    p = T._unflatten(specs, leaves, T._is_spec)
    del leaves
    x = torch.randn((batch, prompt_len + tokens, cfg.d_model),
                    generator=gen, device=dev).to(cfg.dtype)
    n = T.param_count(p)
    _require(expect_params is None or n == expect_params,
             f"{name} has {n} parameters, expected {expect_params}")
    _sync(dev)
    emit({"phase": "lm_build", "arch": name, "params": n,
          "dtype": str(cfg.dtype), "wall_s": time.perf_counter() - t0})
    # serve the layer: prefill, then the decode loop under sync-debug
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        _, cache, _ = _layer_step(cfg, MAMBA_KIND, p, x[:, :prompt_len],
                                  mode="prefill")
        _sync(dev)
        t1 = time.perf_counter()
        clock = serve._Clock(dev)
        with serve.no_host_sync(dev):
            clock.mark()
            for i in range(prompt_len, prompt_len + tokens):
                _, cache, _ = _layer_step(cfg, MAMBA_KIND, p,
                                          x[:, i:i + 1], cache,
                                          mode="decode")
                clock.mark()
        _sync(dev)
        t2 = time.perf_counter()
        c = ir.census(lambda: _layer_step(cfg, MAMBA_KIND, p,
                                          x[:, -1:], cache, mode="decode"))
    _require(c.host_reads == 0, f"a {name} decode step reads the device")
    step_ms = clock.intervals_ms()
    one = dataclasses.replace(cfg, block_pattern=(MAMBA_KIND,), n_layers=1)
    state = sum(_numel(s[0]) * (torch.finfo(s[2]).bits // 8) for pth, s in
                T.tree_leaves(T.cache_specs(one, batch, 1), T._is_cache_leaf)
                if pth != "pos")
    step_bytes = n * (torch.finfo(cfg.dtype).bits // 8) + 2 * state
    flops = layer_flops(cfg, MAMBA_KIND, batch, prompt_len)
    emit({"phase": "lm_serve", "arch": name, "device": dev.type,
          "batch": batch, "prompt_len": prompt_len, "tokens": tokens,
          "prefill_s": t1 - t0, "decode_s": t2 - t1, "decode_steps": tokens,
          "decode_ms_per_token": (sorted(step_ms[1:])[len(step_ms[1:]) // 2]
                                  if len(step_ms) > 1 else None),
          "tokens_per_s": tokens * batch / max(t2 - t1, 1e-9),
          "peak_allocated_bytes": (torch.cuda.max_memory_allocated(dev)
                                   if cuda else None),
          "decode_step_aten_ops": c.op_count,
          "decode_step_host_reads": c.host_reads,
          "decode_step_bytes": step_bytes, "decode_state_bytes": 2 * state,
          "decode_bound_ms": 1e3 * step_bytes / HBM_BYTES_PER_S,
          "decode_bound_by": "bytes", "prefill_flops": flops,
          "prefill_bound_ms": 1e3 * flops / PEAK_FLOPS[cfg.dtype],
          "prefill_bound_by": "operations"})
    del cache
    # float32: prefill against train, the chain against one train pass
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p = T.tree_map(lambda a: a.float(), p)
    x = x.float()
    with torch.no_grad():
        y, chain = _layer_chain(cfg32, MAMBA_KIND, p, x, prompt_len)
        full = _layer_step(cfg32, MAMBA_KIND, p, x)[0]
    e_pre = rel_err(y, full[:, :prompt_len])
    e_dec = rel_err(chain, full[:, prompt_len:])
    _sync(dev)
    emit({"phase": "lm_fp32", "arch": name, "prefill_vs_train_rel": e_pre,
          "decode_vs_teacher_forced_rel": e_dec, "rel_tol": REL_TOL,
          "teacher_forced_len": x.shape[1],
          "wall_s": time.perf_counter() - t0})
    _require(e_pre <= REL_TOL, f"{name} float32 prefill vs train: {e_pre}")
    _require(e_dec <= REL_TOL, f"{name} float32 decode vs teacher forcing: "
             f"{e_dec}")
    del y, chain, full
    # the layer on the card against the CPU (B = 1, short)
    t0 = time.perf_counter()
    xs = x[:1, :CUT_PROMPT + CUT_TOKENS]
    got = [a.cpu() for a in _layer_chain(cfg32, MAMBA_KIND, p, xs,
                                         CUT_PROMPT)]
    host = resolve_device("cpu")
    p = T.tree_map(lambda a: a.to(host), p)
    want = _layer_chain(cfg32, MAMBA_KIND, p, xs.to(host), CUT_PROMPT)
    err = max(rel_err(g, w) for g, w in zip(got, want))
    _require(err <= REL_TOL, f"{name} card vs CPU: {err} > {REL_TOL}")
    emit({"phase": "lm_card_vs_cpu", "arch": name, "layers": 1,
          "prompt_len": CUT_PROMPT, "tokens": CUT_TOKENS,
          "device": dev.type, "rel_err": err, "rel_tol": REL_TOL,
          "wall_s": time.perf_counter() - t0})
    del p, x, xs
    if cuda:
        torch.cuda.empty_cache()
    # the whole SMOKE config on the card: its hybrid cache and MoE layers
    rec = serve.main(["--arch", MAMBA_ARCH, "--smoke", "--census",
                      "--device", dev.type, "--batch", str(batch),
                      "--prompt-len", "64", "--tokens", "16"])
    _require(rec["decode_step_host_reads"] == 0,
             f"a decode step reads the device: {rec}")
    emit({"phase": "lm_serve", **rec})
    emit({"phase": "lm_card_vs_cpu",
          **card_vs_cpu(config(MAMBA_ARCH, True),
                        layers=config(MAMBA_ARCH, True).n_layers,
                        prompt_len=CUT_PROMPT, tokens=CUT_TOKENS,
                        device=dev)})
