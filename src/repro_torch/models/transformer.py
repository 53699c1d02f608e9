"""Model assembly: pattern-based layer stacks over stacked block weights.

Port of the JAX package's ``repro.models.transformer``.
Parameters live in the reference's tree:

    {"embed": (V, D), "final_norm": (D,),
     "blocks": {"p0": {...}, "p1": {...}},      # leaves stacked (n_blocks, ...)
     "encoder": {...}}                          # enc-dec only

so that weights and caches carry across one to one
(:func:`params_from_numpy`).  ``forward`` covers three modes:

  * train:   full-sequence causal, returns logits (+ MoE aux loss)
  * prefill: full-sequence, also returns a filled KV cache
  * decode:  one token against the cache (``serve_step``)

The reference scans the block repeat (``scan_layers``) or unrolls it; the
port runs one Python loop over the stacked leaves for both.  ``remat`` in
train mode is ``torch.utils.checkpoint`` around each block when grad is
on.  A decode step writes its token's K and V into the cache in place (the
reference's launcher donates the cache to its decode step) and returns
the same tensors with ``pos + 1``.

Every family of the reference runs: the ``attn``, ``cross`` and
``attn_cross`` mixers (GQA, sliding window, cross-attention onto image
patches or the encoder's frames), ``mamba`` (``models/mamba.py``) and
``rwkv`` (``models/rwkv.py``), with the ``mlp`` or ``moe``
(``models/moe.py``) ffn, and whisper's bidirectional encoder.  A decode
step updates every cache leaf of its block in place: the attention's
K/V slot, and the recurrent states (``ssm``, ``conv``, ``wkv``,
``tm_x``, ``cm_x``) copied into their block's slice; the cross K/V made
at prefill are read only.  The sharded shape trees wait for the sharding
rules (ROADMAP.md, Queue 1 item 6).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as R


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_map(fn, tree, is_leaf=None):
    """``fn`` on every leaf of a tree of dicts (``None`` stays ``None``)."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def tree_leaves(tree, is_leaf=None) -> list:
    """``(path, leaf)`` in the reference's flatten order (sorted keys),
    the path dot-joined (``blocks.p0.attn.wq``)."""
    out: list = []
    _walk(tree, "", is_leaf, out)
    return out


def _walk(t, prefix: str, is_leaf, out: list) -> None:
    # a module-level function, not a recursive closure: a closure that
    # names itself is a reference cycle, which would keep ``out`` (and
    # every leaf in it) alive until the garbage collector runs
    if isinstance(t, dict) and not (is_leaf and is_leaf(t)):
        for k in sorted(t):
            _walk(t[k], f"{prefix}{k}.", is_leaf, out)
    elif t is not None:
        out.append((prefix[:-1], t))


def _is_spec(x) -> bool:
    return isinstance(x, L.PSpec)


# ---------------------------------------------------------------------------
# parameter spec tree
# ---------------------------------------------------------------------------

def _mixer_ffn(kind: str):
    mixer, _, ffn = kind.partition("+")
    return mixer, (ffn or None)


def layer_specs(cfg, kind: str) -> dict:
    mixer, ffn = _mixer_ffn(kind)
    s: dict = {}
    if mixer == "attn":
        s["attn"] = L.attn_specs(cfg)
    elif mixer == "cross":
        s["cross"] = L.attn_specs(cfg, cross=True)
    elif mixer == "attn_cross":
        s["attn"] = L.attn_specs(cfg)
        s["cross"] = L.attn_specs(cfg, cross=True)
        s["cross"]["norm2"] = L.PSpec((cfg.d_model,), (None,), "ones")
    elif mixer == "mamba":
        s["mamba"] = M.mamba_specs(cfg)
    elif mixer == "rwkv":
        s["rwkv"] = R.rwkv_specs(cfg)
    else:
        raise ValueError(kind)
    if ffn == "mlp":
        s["mlp"] = L.mlp_specs(cfg)
    elif ffn == "moe":
        s["moe"] = MOE.moe_specs(cfg)
    return s


def _stacked(n: int, sub: dict) -> dict:
    return tree_map(lambda ps: L.PSpec((n,) + ps.shape, (None,) + ps.logical,
                                       ps.init, ps.scale), sub)


def param_specs(cfg) -> dict:
    d = cfg.d_model
    specs: dict = {
        "embed": L.PSpec((cfg.vocab, d), ("vocab", "fsdp")),
        "final_norm": L.PSpec((d,), (None,), "ones"),
        "blocks": {},
    }
    for i, kind in enumerate(cfg.block_pattern):
        # leaves always stacked (n_blocks, ...), as in the reference
        specs["blocks"][f"p{i}"] = _stacked(cfg.n_blocks,
                                            layer_specs(cfg, kind))
    if cfg.is_encoder_decoder:
        specs["encoder"] = {
            "blocks": _stacked(cfg.n_enc_layers,
                               layer_specs(cfg, "attn+mlp")),
            "norm": L.PSpec((d,), (None,), "ones")}
    return specs


def init_params(cfg, seed: int | torch.Generator = 0, *,
                device=None) -> dict:
    """A tree of the reference's shapes and dtypes, drawn from the
    reference's distributions (``layers.init_param``) by one
    ``torch.Generator`` on ``device`` (``None``: the card), leaf after
    leaf in the reference's flatten order.  Deterministic for a seed."""
    dev = resolve_device(device)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    specs = param_specs(cfg)
    leaves = {path: L.init_param(gen, ps, cfg.dtype, dev)
              for path, ps in tree_leaves(specs, _is_spec)}
    return _unflatten(specs, leaves, _is_spec)


def _unflatten(template, leaves: dict, is_leaf, prefix: str = ""):
    if isinstance(template, dict) and not is_leaf(template):
        return {k: _unflatten(v, leaves, is_leaf, f"{prefix}{k}.")
                for k, v in template.items()}
    return leaves[prefix[:-1]]


def params_from_numpy(cfg, tree, device=None) -> dict:
    """The JAX package's parameter tree, as numpy arrays (``np.asarray``
    of each leaf), as the port's tree on ``device`` (``None``: the card)
    in ``cfg.dtype``.  A bfloat16 leaf goes through float32 and back,
    which is exact."""
    import numpy as np

    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(
        device=dev, dtype=cfg.dtype), tree)


def param_count(tree) -> int:
    return sum(t.numel() for _, t in tree_leaves(tree))


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def cache_specs(cfg, batch: int, cache_len: int, *,
                shard_cache_seq: bool = False) -> dict:
    """Spec tree for the decode cache (leaves: (shape, logical, dtype))."""
    kvh, dh, d = cfg.n_kv_heads, cfg.d_head, cfg.d_model
    seq_ax = "seq_kv_wide" if shard_cache_seq else "seq_kv"
    out: dict = {"pos": ((), (), torch.int32), "blocks": {}}
    for i, kind in enumerate(cfg.block_pattern):
        mixer, _ = _mixer_ffn(kind)
        c: dict = {}
        nb = (cfg.n_blocks,)
        if mixer in ("attn", "attn_cross"):
            clen = min(cache_len, cfg.window) if cfg.window else cache_len
            c["k"] = (nb + (batch, clen, kvh, dh),
                      (None, "batch", seq_ax, "kv_heads", None), cfg.dtype)
            c["v"] = (nb + (batch, clen, kvh, dh),
                      (None, "batch", seq_ax, "kv_heads", None), cfg.dtype)
        if mixer in ("cross", "attn_cross"):
            klen = cfg.enc_len if cfg.is_encoder_decoder else cfg.img_tokens
            c["ck"] = (nb + (batch, klen, kvh, dh),
                       (None, "batch", None, "kv_heads", None), cfg.dtype)
            c["cv"] = (nb + (batch, klen, kvh, dh),
                       (None, "batch", None, "kv_heads", None), cfg.dtype)
        if mixer == "mamba":
            c["ssm"] = (nb + (batch, cfg.d_inner, cfg.d_state),
                        (None, "batch", "d_inner", None), torch.float32)
            c["conv"] = (nb + (batch, cfg.d_conv - 1, cfg.d_inner),
                         (None, "batch", None, "d_inner"), cfg.dtype)
        if mixer == "rwkv":
            h = max(1, d // 64)
            dk = d // h
            c["wkv"] = (nb + (batch, h, dk, dk),
                        (None, "batch", "rwkv_heads", None, None),
                        torch.float32)
            c["tm_x"] = (nb + (batch, d), (None, "batch", None), cfg.dtype)
            c["cm_x"] = (nb + (batch, d), (None, "batch", None), cfg.dtype)
        out["blocks"][f"p{i}"] = c
    return out


def _is_cache_leaf(x):
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[0], tuple)


def cache_zeros(cfg, batch, cache_len, *, device=None, **kw) -> dict:
    dev = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s[0], dtype=s[2], device=dev),
                    cache_specs(cfg, batch, cache_len, **kw),
                    is_leaf=_is_cache_leaf)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _repeat_kv(cfg, k):
    """Repeat kv heads to n_heads for sequence attention (``jnp.repeat``
    along heads: each kv head ``g`` times in a row)."""
    g = cfg.n_heads // cfg.n_kv_heads
    return torch.repeat_interleave(k, g, dim=2) if g > 1 else k


def attn_branch(cfg, s: int) -> str:
    """The attention a sequence of ``s`` takes: the blockwise flash when
    ``s`` is a multiple of ``attn_chunk`` above it, else the naive one."""
    return ("flash" if s > cfg.attn_chunk and s % cfg.attn_chunk == 0
            else "naive")


def _attn_seq(cfg, p, x, positions, *, causal=True, make_cache=False,
              cache_len=None):
    q, k, v = L.qkv_project(cfg, p, L.rms_norm(x, p["norm"]))
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    kf, vf = _repeat_kv(cfg, k), _repeat_kv(cfg, v)
    s = x.shape[1]
    if attn_branch(cfg, s) == "flash":
        o = L.flash_attention(q, kf, vf, causal=causal, window=cfg.window,
                              chunk=cfg.attn_chunk)
    else:
        o = L.attn_naive(q, kf, vf, causal=causal, window=cfg.window)
    out = torch.einsum("bshd,hde->bse", o, p["wo"])
    if not make_cache:
        return out, None
    clen = max(cache_len or s, s)
    if cfg.window:  # ring buffer holds the last `window` positions
        w = cfg.window
        keep = min(s, w)
        idx = torch.arange(s - keep, s, device=x.device) % w
        ck = torch.zeros((k.shape[0], w) + k.shape[2:], dtype=k.dtype,
                         device=k.device)
        cv = torch.zeros_like(ck)
        ck[:, idx] = k[:, -keep:]
        cv[:, idx] = v[:, -keep:]
        return out, (ck, cv)
    if clen > s:  # headroom for subsequent decode steps
        pad = (0, 0, 0, 0, 0, clen - s)
        k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    return out, (k, v)


def _attn_decode(cfg, p, x1, k_cache, v_cache, pos):
    """x1 (B,1,D); cache (B,S,KV,Dh), written in place; pos a 0-d int32
    tensor on the device.  Nothing here reads the device from the host."""
    q, k, v = L.qkv_project(cfg, p, L.rms_norm(x1, p["norm"]))
    ppos = pos.reshape(1, 1).expand(x1.shape[0], 1)
    q = L.rope(q, ppos, cfg.rope_theta)
    k = L.rope(k, ppos, cfg.rope_theta)
    clen = k_cache.shape[1]
    slot_ids = torch.arange(clen, device=x1.device)
    if cfg.window:
        # floor-mod (torch's %), as jnp's
        slot = pos % clen
        slot_pos = pos - ((pos - slot_ids) % clen)
        valid = slot_pos >= 0
    else:
        # dynamic_update_slice clamps its start into range: a position past
        # the cache writes the last slot
        slot = pos.clamp(0, clen - 1)
        valid = slot_ids <= pos
    idx = slot.reshape(1).to(torch.int64)
    k_cache.index_copy_(1, idx, k)
    v_cache.index_copy_(1, idx, v)
    if cfg.window:
        valid = valid | (slot_ids == slot)
    o = L.attn_decode(q, k_cache, v_cache, valid)
    return torch.einsum("bshd,hde->bse", o, p["wo"]), k_cache, v_cache


def _cross_attn(cfg, p, x, ext_kv=None, ck=None, cv=None):
    """Cross-attention; ext_kv (B,L,D) at prefill/train, (ck, cv) at
    decode.  Every key is valid; GQA groups query heads under kv heads
    inside the attention, as in the reference."""
    norm_w = p.get("norm2", p["norm"])
    xq = L.rms_norm(x, norm_w)
    if ck is None:
        q, ck, cv = L.qkv_project(cfg, p, xq, kv_x=ext_kv)
    else:
        q = torch.einsum("bsd,dhk->bshk", xq, p["wq"])
        if "qnorm" in p:
            q = L.rms_norm(q, p["qnorm"])
    if q.shape[1] == 1:
        valid = torch.ones((ck.shape[1],), dtype=torch.bool,
                           device=x.device)
        o = L.attn_decode(q, ck, cv, valid)
    else:
        o = L.attn_naive(q, ck, cv, causal=False)
    return torch.einsum("bshd,hde->bse", o, p["wo"]), ck, cv


def apply_layer(cfg, kind, p, x, *, positions, ext_kv=None, cache=None,
                pos=None, mode="train", cache_len=None):
    """One layer. Returns (x, new_cache, aux); aux is the MoE router's
    loss (a float32 scalar), or the float 0.0 for a layer without one.

    In decode, ``new_cache`` holds each leaf's new value: the attention's
    K/V are the cache's own tensors, written in place; the recurrent
    states are new tensors for the caller to store."""
    mixer, ffn = _mixer_ffn(kind)
    aux = 0.0
    newc: dict = {}
    if mixer in ("attn", "attn_cross"):
        if mode == "decode":
            o, nk, nv = _attn_decode(cfg, p["attn"], x, cache["k"],
                                     cache["v"], pos)
            newc["k"], newc["v"] = nk, nv
        else:
            o, kv = _attn_seq(cfg, p["attn"], x, positions,
                              make_cache=(mode == "prefill"),
                              cache_len=cache_len)
            if kv is not None:
                newc["k"], newc["v"] = kv
        x = x + o
    if mixer in ("cross", "attn_cross"):
        if mode == "decode":
            o, _, _ = _cross_attn(cfg, p["cross"], x, ck=cache["ck"],
                                  cv=cache["cv"])
            newc["ck"], newc["cv"] = cache["ck"], cache["cv"]
        else:
            o, ck, cv = _cross_attn(cfg, p["cross"], x, ext_kv=ext_kv)
            if mode == "prefill":
                newc["ck"], newc["cv"] = ck, cv
        x = x + o
    if mixer == "mamba":
        xin = L.rms_norm(x, p["mamba"]["norm"])
        if mode == "decode":
            o, h, conv = M.mamba_decode(cfg, p["mamba"], xin, cache["ssm"],
                                        cache["conv"])
            newc["ssm"], newc["conv"] = h, conv
        elif mode == "prefill":
            o, newc["ssm"], newc["conv"] = M.mamba_seq(
                cfg, p["mamba"], xin, with_tail=True)
        else:
            o, _ = M.mamba_seq(cfg, p["mamba"], xin)
        x = x + o
    if mixer == "rwkv":
        xin = L.rms_norm(x, p["rwkv"]["tm_norm"])
        if mode == "decode":
            o, s_new, tmx = R.time_mix_decode(cfg, p["rwkv"], xin,
                                              cache["wkv"], cache["tm_x"])
            newc["wkv"], newc["tm_x"] = s_new, tmx
        else:
            o, (s_new, tmx) = R.time_mix_seq(cfg, p["rwkv"], xin)
            if mode == "prefill":
                newc["wkv"], newc["tm_x"] = s_new, tmx
        x = x + o
        xcm = L.rms_norm(x, p["rwkv"]["cm_norm"])
        prev = cache["cm_x"] if mode == "decode" else None
        o, cmx = R.channel_mix(cfg, p["rwkv"], xcm, prev)
        if mode in ("decode", "prefill"):
            newc["cm_x"] = cmx
        x = x + o
    if ffn == "mlp":
        x = x + L.mlp(p["mlp"], L.rms_norm(x, p["mlp"]["norm"]),
                      bf16_reduce=cfg.bf16_reduce)
    elif ffn == "moe":
        o, a = MOE.moe_ffn(cfg, p["moe"], L.rms_norm(x, p["moe"]["norm"]))
        x = x + o
        aux = aux + a
    return x, newc, aux


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def block_views(stacked: dict, n: int) -> list:
    """Block ``i``'s tree of ``stacked`` (leaves ``(n, ...)``), for each
    ``i``: ``torch.unbind`` once per leaf.  Its backward is one ``stack``,
    where ``a[i]``'s backward makes a zero tensor of the whole stacked
    leaf for every block and adds the ``n`` of them."""
    parts = tree_map(torch.unbind, stacked)  # leaves: tuples of n views
    return [tree_map(lambda t, i=i: t[i], parts) for i in range(n)]


def _encoder(cfg, params, frames):
    """Whisper-style encoder over precomputed frame embeddings (stub
    frontend): bidirectional ``attn+mlp`` blocks, then ``encoder.norm``."""
    b, s, _ = frames.shape
    positions = torch.arange(s, device=frames.device).expand(b, s)
    x = frames
    views = block_views(params["encoder"]["blocks"], cfg.n_enc_layers)
    for i in range(cfg.n_enc_layers):
        p = views[i]
        o, _ = _attn_seq(cfg, p["attn"], x, positions, causal=False)
        x = x + o
        x = x + L.mlp(p["mlp"], L.rms_norm(x, p["mlp"]["norm"]))
    return L.rms_norm(x, params["encoder"]["norm"])


def forward(cfg, params, tokens, *, ext_embed=None, mode="train",
            cache=None, cache_len=None):
    """tokens (B,S) int; ext_embed (B,L,D) — image patches / audio frames.

    Returns (logits, new_cache | None, aux_loss)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode: {mode!r}")
    b, s = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens].to(cfg.dtype)
    ext_kv = None
    if cfg.is_encoder_decoder and mode != "decode":
        ext_kv = _encoder(cfg, params, ext_embed)
    elif cfg.img_tokens and mode != "decode":
        ext_kv = ext_embed
    if mode == "decode":
        pos = cache["pos"]
        positions = pos.reshape(1, 1).expand(b, 1)
    else:
        pos = None
        positions = torch.arange(s, device=dev).expand(b, s)

    def superblock(x, bp, bc):
        aux = 0.0
        newc = {}
        for i, kind in enumerate(cfg.block_pattern):
            c_i = bc[f"p{i}"] if bc is not None else None
            x, nc, a = apply_layer(cfg, kind, bp[f"p{i}"], x,
                                   positions=positions, ext_kv=ext_kv,
                                   cache=c_i, pos=pos, mode=mode,
                                   cache_len=cache_len)
            aux = aux + a
            newc[f"p{i}"] = nc
        return x, aux, newc

    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    aux = 0.0
    bc_all = cache["blocks"] if cache is not None else None
    newblocks: dict = {}
    views = block_views(params["blocks"], cfg.n_blocks)
    for i in range(cfg.n_blocks):
        bp_i = views[i]
        bc_i = tree_map(lambda a: a[i], bc_all) if bc_all is not None \
            else None
        if remat:
            x, a, nc = checkpoint(superblock, x, bp_i, bc_i,
                                  use_reentrant=False)
        else:
            x, a, nc = superblock(x, bp_i, bc_i)
        aux = aux + a
        if mode == "prefill":
            # the stacked cache is made once and filled a block at a time
            if i == 0:
                newblocks = tree_map(lambda t: t.new_empty(
                    (cfg.n_blocks,) + tuple(t.shape)), nc)
            for pk, leaves in nc.items():
                for name, t in leaves.items():
                    newblocks[pk][name][i].copy_(t)
        elif mode == "decode":
            # K/V were written in place; the recurrent states are stored
            # into this block's slice of the stacked cache
            for pk, leaves in nc.items():
                for name, t in leaves.items():
                    if t is not bc_i[pk][name]:
                        bc_i[pk][name].copy_(t)
            newblocks = bc_all

    if mode == "prefill":
        # serving only consumes the last position's logits; skipping the
        # full (B, S, V) head drops its flops
        x = x[:, -1:]
    x = L.rms_norm(x, params["final_norm"])
    logits = torch.einsum("bsd,vd->bsv", x, params["embed"]).to(torch.float32)
    if not torch.is_tensor(aux):
        aux = torch.full((), aux, dtype=torch.float32, device=dev)
    new_cache = None
    if mode in ("prefill", "decode"):
        newpos = (cache["pos"] + 1) if mode == "decode" else torch.full(
            (), s, dtype=torch.int32, device=dev)
        new_cache = {"pos": newpos, "blocks": newblocks}
    return logits, new_cache, aux


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

class TransformerLM(nn.Module):
    """The model as an ``nn.Module``: it owns the tree as parameters whose
    ``state_dict`` keys are the reference's tree paths
    (``blocks.p0.attn.wq``, ...), and its ``forward`` is :func:`forward`."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        _register(self, params)

    def tree(self) -> dict:
        """The parameter tree :func:`forward` takes (the parameters
        themselves, not copies)."""
        return _as_tree(self)

    def forward(self, tokens, **kw):
        return forward(self.cfg, self.tree(), tokens, **kw)


def _register(m: nn.Module, tree: dict) -> None:
    """Each leaf of ``tree`` a parameter of ``m`` (sharing its storage),
    each sub-tree a child module of the same name."""
    for k, v in tree.items():
        if isinstance(v, dict):
            child = nn.Module()
            _register(child, v)
            m.add_module(k, child)
        else:
            m.register_parameter(k, nn.Parameter(v))


def _as_tree(m: nn.Module) -> dict:
    out = {k: p for k, p in m.named_parameters(recurse=False)}
    out.update({k: _as_tree(c) for k, c in m.named_children()})
    return out
