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
at prefill are read only.

On a mesh the same ``forward`` runs on DTensors (``torch.distributed.
tensor``, the counterpart of the reference's GSPMD): every leaf carries
logical axes, ``sharding.rules`` maps them to placements
(``shape_tree``, ``param_shardings``, ``cache_shape_tree`` give the
sharded trees as :class:`TensorSpec` leaves; ``distribute_params`` and
``init_local_params`` make the DTensors), sharding propagation inserts
the collectives, and ``_constrain`` is a ``redistribute``.  Where
DTensor has no rule for an op, or its rule fails, the op runs on each
rank's shards under ``shard_map`` (``local_map``): the attention, the
MoE's routing and dispatch, the Mamba and RWKV scans, the embedding
lookup, and the decode's cache write, which lands on the rank whose
sequence shard holds ``pos``.  The plain tensors ``forward`` makes
(positions, masks) count as replicated (``sharding.rules.on_mesh``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as R
from repro_torch.sharding import rules as SR


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
# sharded trees (the reference's ShapeDtypeStructs with NamedShardings)
# ---------------------------------------------------------------------------

class TensorSpec(NamedTuple):
    """A leaf of a sharded shape tree: the global shape and dtype, the
    spec on the mesh (``sharding.rules.spec_for``) and one rank's shard
    shape.  Nothing is allocated."""

    shape: tuple
    dtype: torch.dtype
    spec: tuple
    local_shape: tuple

    @property
    def local_bytes(self) -> int:
        return math.prod(self.local_shape) * _itemsize(self.dtype)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def tensor_spec(mesh, shape, dtype, logical, rules=None) -> TensorSpec:
    spec = SR.spec_for(mesh, logical, shape, rules)
    return TensorSpec(tuple(shape), dtype, spec,
                      SR.local_shape(mesh, spec, shape))


def _rules(cfg, rules):
    """The reference's merge order: the config's rules override."""
    return {**(rules or {}), **SR.rules_for_config(cfg)}


def shape_tree(cfg, mesh, rules=None) -> dict:
    """The parameter tree as :class:`TensorSpec` leaves on ``mesh``."""
    rules = _rules(cfg, rules)
    return tree_map(lambda ps: tensor_spec(mesh, ps.shape, cfg.dtype,
                                           ps.logical, rules),
                    param_specs(cfg))


def param_shardings(cfg, mesh, rules=None) -> dict:
    rules = _rules(cfg, rules)
    return tree_map(lambda ps: SR.sharding_for(mesh, ps.logical, ps.shape,
                                               rules), param_specs(cfg))


def cache_shape_tree(cfg, mesh, batch, cache_len, rules=None, **kw) -> dict:
    """The decode cache as :class:`TensorSpec` leaves on ``mesh``."""
    rules = _rules(cfg, rules)
    return tree_map(lambda s: tensor_spec(mesh, s[0], s[2], s[1], rules),
                    cache_specs(cfg, batch, cache_len, **kw),
                    is_leaf=_is_cache_leaf)


def place_cache(cfg, cache: dict, dmesh, rules=None, **kw) -> dict:
    """A decode cache (a prefill's, as DTensors in whatever placements
    the prefill gave, or whole tensors) placed by the rules on the
    ``DeviceMesh`` ``dmesh``, as :func:`cache_shape_tree` gives them;
    ``pos`` stays as it is."""
    k0 = next(t for path, t in tree_leaves(cache) if path != "pos")
    b = k0.shape[1]
    clen = max([t.shape[2] for path, t in tree_leaves(cache)
                if path.endswith((".k", ".v"))] or [1])
    specs = cache_shape_tree(cfg, dmesh, b, clen, rules, **kw)

    def one(path, t):
        if path == "pos":
            return t
        pl = SR.placements(dmesh, specs_flat[path].spec)
        if isinstance(t, DTensor):
            return t.redistribute(dmesh, pl)
        return SR.from_full(t, dmesh, pl)

    specs_flat = dict(tree_leaves(specs, _is_tensor_spec))
    return _unflatten(cache, {p: one(p, t) for p, t in tree_leaves(cache)},
                      lambda x: not isinstance(x, dict))


def tree_bytes(tree) -> int:
    """One rank's bytes of a :class:`TensorSpec` tree."""
    return sum(t.local_bytes for _, t in tree_leaves(tree, _is_tensor_spec))


def _is_tensor_spec(x) -> bool:
    return isinstance(x, TensorSpec)


def _placed(cfg, dmesh, rules):
    """path -> (PSpec, spec, DTensor placements) of every parameter
    leaf."""
    rules = _rules(cfg, rules)
    out = {}
    for path, ps in tree_leaves(param_specs(cfg), _is_spec):
        spec = SR.spec_for(dmesh, ps.logical, ps.shape, rules)
        out[path] = (ps, spec, SR.placements(dmesh, spec))
    return out


def distribute_params(cfg, tree: dict, dmesh, rules=None) -> dict:
    """A full parameter tree (every rank holds all of it, as
    :func:`params_from_numpy` makes it) as DTensors on the
    ``DeviceMesh`` ``dmesh``: each rank keeps its own shard of each leaf,
    placed by the sharding rules; nothing crosses the group."""
    placed = _placed(cfg, dmesh, rules)
    leaves = {path: SR.from_full(t, dmesh, placed[path][2])
              for path, t in tree_leaves(tree)}
    return _unflatten(tree, leaves, lambda x: not isinstance(x, dict))


def init_local_params(cfg, dmesh, seed: int = 0, device=None,
                      rules=None) -> dict:
    """A random parameter tree as DTensors on ``dmesh`` whose every rank
    draws only its own shards (the full tree is never made: qwen2-72b is
    145 GB in bf16).  Each leaf has the reference's distribution
    (``layers.init_std`` of the GLOBAL spec); the numbers come from one
    ``torch.Generator`` seeded by ``seed`` and this rank's coordinate."""
    dev = resolve_device(device)
    gen = SR.rank_generator(dmesh, seed, dev)
    leaves = {}
    for path, (ps, spec, pl) in _placed(cfg, dmesh, rules).items():
        shp = SR.local_shape(dmesh, spec, ps.shape)
        local = L.init_param(gen, ps._replace(shape=shp), cfg.dtype, dev,
                             std=float(L.init_std(ps)))
        leaves[path] = SR.from_local(local, dmesh, pl, ps.shape)
    return _unflatten(param_specs(cfg), leaves, _is_spec)


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

def _constrain(x, *axes):
    """The reference's ``with_sharding_constraint``: a DTensor
    redistributed to the spec ``axes`` (an entry a dim: ``None``, a mesh
    axis or a tuple of them) on its own mesh; a no-op off a mesh, or
    when an axis is not in the mesh, as there."""
    if not isinstance(x, DTensor):
        return x
    names = set(x.device_mesh.mesh_dim_names)
    flat = [a for e in axes if e is not None
            for a in (e if isinstance(e, tuple) else (e,))]
    if not all(a in names for a in flat):
        return x
    return x.redistribute(x.device_mesh,
                          SR.placements(x.device_mesh, tuple(axes)))


def _batch_axes(x):
    """Mesh axes carrying the batch dim on ``x``'s mesh (if any), as the
    rules' ``batch`` gives them."""
    if not isinstance(x, DTensor):
        return None
    return SR.spec_for(x.device_mesh, ("batch",), (0,))[0]


def _constrain_act(cfg, x):
    """Layer-boundary activation pin (perf knob ``shard_activations``):
    keeps (B, S, D) batch-sharded so the propagation gathers the (small)
    FSDP weight shards instead of the (huge) activations."""
    if not cfg.shard_activations:
        return x
    seq = "model" if cfg.attn_seq_shard else None
    return _constrain(x, _batch_axes(x), seq, None)


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
    s = x.shape[1]
    flash = attn_branch(cfg, s) == "flash"
    if isinstance(q, DTensor):
        o = _attn_sharded(cfg, q, k, v, causal=causal, flash=flash)
    else:
        kf, vf = _repeat_kv(cfg, k), _repeat_kv(cfg, v)
        if flash:
            o = L.flash_attention(q, kf, vf, causal=causal,
                                  window=cfg.window, chunk=cfg.attn_chunk)
        else:
            o = L.attn_naive(q, kf, vf, causal=causal, window=cfg.window)
    out = L.proj_out(o, p["wo"])
    if not make_cache:
        return out, None
    clen = max(cache_len or s, s)
    if cfg.window:  # ring buffer holds the last `window` positions
        # position t lands in slot t % w: the last w positions rolled by
        # s % w, or the s < w positions at the front (the reference's
        # scatter, as slices, a cat and a pad, which DTensor also takes)
        w = cfg.window
        if s >= w:
            r = s % w  # torch.roll(t, r, dims=1), as slices and a cat
            return out, tuple(torch.cat([t[:, s - r:], t[:, s - w:s - r]],
                                        dim=1) for t in (k, v))
        pad = (0, 0, 0, 0, 0, w - s)
        return out, (torch.nn.functional.pad(k, pad),
                     torch.nn.functional.pad(v, pad))
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
    if isinstance(k_cache, DTensor):
        o = _attn_decode_sharded(cfg, q, k, v, k_cache, v_cache, pos)
        return L.proj_out(o, p["wo"]), k_cache, v_cache
    clen = k_cache.shape[1]
    slot, valid = _slots(cfg, pos, torch.arange(clen, device=x1.device),
                         clen)
    idx = slot.reshape(1).to(torch.int64)
    k_cache.index_copy_(1, idx, k)
    v_cache.index_copy_(1, idx, v)
    o = L.attn_decode(q, k_cache, v_cache, valid)
    return L.proj_out(o, p["wo"]), k_cache, v_cache


def _attn_sharded(cfg, q, k, v, *, causal, flash, window="cfg"):
    """The attention of ``q`` (B,S,H,Dh) over ``k``/``v`` (B,Sk,KV,Dh) on
    DTensors, under ``shard_map``: each rank takes its rows of the batch
    and, where the heads split over ``model``, its query heads, and
    attends with the kv head of each (the reference's ``jnp.repeat`` of
    the kv heads, then this rank's slice of them; the same products as
    the grouped attention of the cross layers).  The keys and values are
    whole over the heads; their gradients come back as partial sums."""
    window = cfg.window if window == "cfg" else window
    mesh = q.device_mesh
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    qs = SR.spec_for(mesh, ("batch", None, "heads", None), tuple(q.shape))
    ks = (qs[0], None, None, None)
    heads = qs[2] if isinstance(qs[2], tuple) else (
        () if qs[2] is None else (qs[2],))
    shard = SR.shard_index(mesh, [mesh.mesh_dim_names.index(a)
                                  for a in heads])

    def local(q, k, v):
        hl = q.shape[2]
        sel = (shard * hl + torch.arange(hl, device=q.device)) // g
        kf, vf = k.index_select(2, sel), v.index_select(2, sel)
        if flash:
            return L.flash_attention(q, kf, vf, causal=causal,
                                     window=window, chunk=cfg.attn_chunk)
        return L.attn_naive(q, kf, vf, causal=causal, window=window)

    return SR.shard_map(local, mesh, (qs, ks, ks), (qs,))(q, k, v)


def _slots(cfg, pos, slot_ids, clen):
    """The slot a decode step at ``pos`` writes and the mask of the slots
    ``slot_ids`` it attends to, in a cache of ``clen`` slots."""
    if cfg.window:
        # floor-mod (torch's %), as jnp's
        slot = pos % clen
        valid = (pos - ((pos - slot_ids) % clen)) >= 0
        return slot, valid | (slot_ids == slot)
    # dynamic_update_slice clamps its start into range: a position past
    # the cache writes the last slot
    return pos.clamp(0, clen - 1), slot_ids <= pos


def _attn_decode_sharded(cfg, q, k, v, k_cache, v_cache, pos):
    """The decode attention on a cache sharded over the mesh (DTensors),
    on each rank's local tensors (no gradient flows in decode): the rank
    writes the step's K/V into its own shard of the cache when the slot
    falls in it (an offset from the shard's first slot, clamped, and a
    ``where`` that keeps the old row elsewhere; nothing is read to the
    host), attends over its shard, and the softmax's max, sum and output
    are combined over the mesh dims that shard the sequence.  Returns
    ``o`` (B,1,H,Dh) as a DTensor."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = k_cache.device_mesh
    cpl = k_cache.placements
    seq_dims = [i for i, pl in enumerate(cpl) if pl == Shard(1)]
    # q/k/v follow the cache's batch and kv-head shards, whole elsewhere
    qpl = tuple(pl if pl in (Shard(0), Shard(2)) else Replicate()
                for pl in cpl)
    groups = [mesh.get_group(i) for i in seq_dims]
    nseq = math.prod(mesh.size(i) for i in seq_dims)
    shard = SR.shard_index(mesh, seq_dims)
    ql, kl, vl = (t.redistribute(mesh, qpl).to_local() for t in (q, k, v))
    kc, vc = k_cache.to_local(), v_cache.to_local()
    sl = kc.shape[1]
    first = shard * sl
    slot_ids = first + torch.arange(sl, device=kc.device)
    slot, valid = _slots(cfg, pos, slot_ids, sl * nseq)
    off = slot - first
    here = (off >= 0) & (off < sl)
    li = off.clamp(0, sl - 1).reshape(1).to(torch.int64)
    for c, new in ((kc, kl), (vc, vl)):
        c.index_copy_(1, li, torch.where(here, new.to(c.dtype),
                                         c.index_select(1, li)))
    o = L.attn_decode(ql, kc, vc, valid, seq_groups=groups)
    return SR.from_local(o, mesh, qpl, tuple(q.shape))


def _cross_attn(cfg, p, x, ext_kv=None, ck=None, cv=None):
    """Cross-attention; ext_kv (B,L,D) at prefill/train, (ck, cv) at
    decode.  Every key is valid; GQA groups query heads under kv heads
    inside the attention, as in the reference."""
    norm_w = p.get("norm2", p["norm"])
    xq = L.rms_norm(x, norm_w)
    if ck is None:
        q, ck, cv = L.qkv_project(cfg, p, xq, kv_x=ext_kv)
    else:
        q = L.proj_heads(xq, p["wq"])
        if "qnorm" in p:
            q = L.rms_norm(q, p["qnorm"])
    if isinstance(q, DTensor):
        o = _attn_sharded(cfg, q, ck, cv, causal=False, flash=False,
                          window=None)
    elif q.shape[1] == 1:
        valid = torch.ones((ck.shape[1],), dtype=torch.bool,
                           device=x.device)
        o = L.attn_decode(q, ck, cv, valid)
    else:
        o = L.attn_naive(q, ck, cv, causal=False)
    return L.proj_out(o, p["wo"]), ck, cv


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
                      bf16_reduce=cfg.bf16_reduce, batch_axes=_batch_axes(x))
    elif ffn == "moe":
        o, a = MOE.moe_ffn(cfg, p["moe"], L.rms_norm(x, p["moe"]["norm"]))
        x = x + o
        aux = aux + a
    return x, newc, aux


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def _head(x, embed):
    """The tied LM head, ``einsum("bsd,vd->bsv")`` in float32, as a
    matmul.  On DTensors ``x`` is batch-sharded and whole along D and
    the embedding vocab-sharded and whole along D (its FSDP shards
    gathered): the logits come out sharded over the batch and the vocab,
    never whole (a propagation left free gathers them whole on torch
    2.11: 297 GiB for qwen3-4b's ``train_4k``)."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        x = x.redistribute(mesh, SR.placements(mesh, SR.spec_for(
            mesh, ("batch", None, None), tuple(x.shape))))
        embed = embed.redistribute(mesh, SR.placements(mesh, SR.spec_for(
            mesh, ("vocab", None), tuple(embed.shape))))
    return (x @ embed.transpose(0, 1)).to(torch.float32)


def _layer(a, i: int):
    """Block ``i`` of a stacked cache leaf, as a view: on a DTensor, a
    DTensor over the view of its local tensor (its stacked dim is never
    sharded), so that a decode step's writes land in the stacked
    cache."""
    if not isinstance(a, DTensor):
        return a[i]
    from torch.distributed.tensor import Shard

    pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
               for p in a.placements)
    return SR.from_local(a.to_local()[i], a.device_mesh, pl,
                         tuple(a.shape[1:]))


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
    positions = SR.replicated(
        torch.arange(s, device=frames.device).expand(b, s), frames)
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

    Returns (logits, new_cache | None, aux_loss).  On a mesh (DTensor
    parameters) the plain tensors made here count as replicated."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode: {mode!r}")
    with SR.on_mesh(params):
        return _forward(cfg, params, tokens, ext_embed, mode, cache,
                        cache_len)


def _forward(cfg, params, tokens, ext_embed, mode, cache, cache_len):
    b, s = tokens.shape
    dev = tokens.device
    if isinstance(params["embed"], DTensor):
        # the lookup on each rank's vocab rows (DTensor's own rule for the
        # backward's index_put fails on torch 2.11)
        x = SR.reduce_partial(SR.vocab_gather(
            params["embed"], tokens, ("batch", None))).to(cfg.dtype)
    else:
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
        positions = SR.replicated(torch.arange(s, device=dev).expand(b, s),
                                  params["embed"])

    def superblock(x, bp, bc):
        aux = 0.0
        newc = {}
        # entered again here: remat recomputes this outside ``forward``
        with SR.on_mesh(bp):
            x = _constrain_act(cfg, x)
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
        bc_i = tree_map(lambda a: _layer(a, i), bc_all) \
            if bc_all is not None else None
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
    logits = _head(x, params["embed"])
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
