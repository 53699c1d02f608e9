"""Core transformer layers: norms, RoPE, GQA attention (naive / blockwise
flash with its own backward / decode), SwiGLU MLP, and the ParamSpec
machinery that carries logical sharding axes for every weight.

Port of the JAX package's ``repro.models.layers``.  Each function follows
the reference's algorithm and its casts, so that the two compute the same
values up to the matmul kernels' rounding: scores are cast to float32
after a matmul in the input dtype, masked entries take ``NEG_INF`` and a
fully masked chunk contributes exact zeros.  No fused attention library
call stands in for these (a faster attention is a measured change of its
own)."""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.sharding import rules as SR

NEG_INF = -1e30


class PSpec(NamedTuple):
    """Declarative parameter: shape + logical sharding axes + init."""
    shape: tuple
    logical: tuple
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0


def init_std(spec: PSpec) -> float:
    """The std a ``normal`` leaf is drawn with: ``scale / sqrt(fan_in)``,
    ``fan_in`` the spec's FIRST dim (on a stacked block spec that is
    ``n_blocks``, as in the reference)."""
    fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[-1], 1)
    return spec.scale / np.sqrt(fan_in)


#: the largest leaf drawn in one piece (elements)
DRAW_WHOLE = 2**28


def init_param(generator: torch.Generator, spec: PSpec, dtype: torch.dtype,
               device: torch.device, std: float | None = None
               ) -> torch.Tensor:
    """One leaf: zeros, ones, or a float32 normal draw times
    :func:`init_std` (or ``std``: a shard's draw takes its whole leaf's)
    cast to ``dtype`` (the reference's distribution; ``torch.Generator``
    cannot give its numbers).  A leaf of more than :data:`DRAW_WHOLE`
    elements is drawn in slices of its first dim, from the same
    generator."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    std = float(init_std(spec)) if std is None else std
    # drawn in slices of the first dim of at most DRAW_WHOLE elements (one
    # slice if a row is larger; the whole leaf if it is no larger), so that
    # a large leaf's float32 draw never stands beside it whole (mixtral's
    # stacked expert weights are 7.5G elements: 30 GB in float32)
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    step = max(1, DRAW_WHOLE // int(np.prod(spec.shape[1:])))
    for i in range(0, spec.shape[0], step):
        part = out[i:i + step]
        part.copy_(torch.randn(part.shape, generator=generator,
                               dtype=torch.float32, device=device).mul_(std))
    return out


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps=1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


@functools.lru_cache(maxsize=64)
def _freqs(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """The rotary frequencies, made on the host in float32 as the
    reference makes them, then kept on ``device`` (read, never written),
    so that a decode step copies nothing from the host."""
    half = d // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(np.asarray(freqs, np.float32)).to(device)


def rope(x, positions, theta: float):
    """x: (..., S, H, D) with rotary over D; positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = _freqs(d, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention — parameter specs
# ---------------------------------------------------------------------------

def attn_specs(cfg, cross: bool = False) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = {
        "norm": PSpec((d,), (None,), "ones"),
        "wq": PSpec((d, h, dh), ("embed", "heads", None)),
        "wk": PSpec((d, kv, dh), ("embed", "kv_heads", None)),
        "wv": PSpec((d, kv, dh), ("embed", "kv_heads", None)),
        "wo": PSpec((h, dh, d), ("heads", None, "fsdp"), scale=1.0),
    }
    if cfg.qkv_bias and not cross:
        s["bq"] = PSpec((h, dh), ("heads", None), "zeros")
        s["bk"] = PSpec((kv, dh), ("kv_heads", None), "zeros")
        s["bv"] = PSpec((kv, dh), ("kv_heads", None), "zeros")
    if cfg.qk_norm:
        s["qnorm"] = PSpec((dh,), (None,), "ones")
        s["knorm"] = PSpec((dh,), (None,), "ones")
    return s


def qkv_project(cfg, p, x, kv_x=None):
    """x: (B,S,D) -> q (B,S,H,Dh), k/v (B,Skv,KV,Dh). kv_x for cross-attn."""
    kv_x = x if kv_x is None else kv_x
    q = proj_heads(x, p["wq"])
    k = proj_heads(kv_x, p["wk"])
    v = proj_heads(kv_x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if "qnorm" in p:
        q = rms_norm(q, p["qnorm"])
        k = rms_norm(k, p["knorm"])
    return q, k, v


def proj_heads(x, w):
    """``einsum("bsd,dhk->bshk", x, w)`` as a matmul with ``w`` seen as
    (D, H*K) and a reshape: DTensor (torch 2.11) cannot flatten the
    sharded dims an einsum would, a sharded head dim being the outer one
    of (H, K) here.  A weight's FSDP shards are gathered first."""
    d, h, k = w.shape
    w = SR.fsdp_gather(w)
    return (x @ w.reshape(d, h * k)).reshape(x.shape[:-1] + (h, k))


def proj_out(o, w):
    """``einsum("bshd,hde->bse", o, w)``.  On DTensors a matmul of ``o``
    seen as (B, S, H*D) with ``w`` as (H*D, E), the partial sums over
    the head shards all-reduced.  Plain tensors keep the einsum, which
    sums in (D, H) order: the (H, D) order, the only one a sharded head
    dim flattens in, moves whisper's float32 decode chain past the
    reference's own float32 error."""
    if not isinstance(o, DTensor):
        return torch.einsum("bshd,hde->bse", o, w)
    h, d, e = w.shape
    w = SR.fsdp_gather(w)
    return SR.reduce_partial(o.reshape(o.shape[:-2] + (h * d,))
                             @ w.reshape(h * d, e))


def _mask(qpos, kpos, causal: bool, window):
    """(Sq, Sk) bool of the pairs attended, or ``None`` when all are."""
    mask = None
    if causal:
        mask = qpos[:, None] >= kpos[None, :]
    if window is not None:
        w = kpos[None, :] > qpos[:, None] - window
        mask = w if mask is None else mask & w
    return mask


# ---------------------------------------------------------------------------
# attention — naive reference (small S; also the flash test oracle)
# ---------------------------------------------------------------------------

def attn_naive(q, k, v, *, causal: bool, window=None, q_offset: int = 0):
    """q: (B,Sq,H,D), k/v: (B,Sk,KV,D) — GQA by head grouping: query head
    ``h`` attends with kv head ``h // (H // KV)``."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32)
    s = s / float(np.sqrt(d))
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = _mask(qpos, kpos, causal, window)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", a.to(v.dtype), v)
    return o.reshape(b, sq, h, d)


# ---------------------------------------------------------------------------
# attention — blockwise "flash" with its own backward (O(S) memory)
# ---------------------------------------------------------------------------

def _flash_fwd_impl(q, k, v, *, causal, window, chunk):
    """q (b,sq,kvh,g,d), k/v (b,sk,kvh,d) -> out (b,kvh,g,sq,d), lse."""
    b, sq, kvh, g, d = q.shape
    sk = k.shape[1]
    nchunks = sk // chunk
    scale = float(1.0 / np.sqrt(d))
    qpos = torch.arange(sq, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, d), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    for ci in range(nchunks):
        kc = k[:, ci * chunk:(ci + 1) * chunk]
        vc = v[:, ci * chunk:(ci + 1) * chunk]
        s = torch.einsum("bqkgd,bskd->bkgqs", q, kc).to(torch.float32) \
            * scale
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        mask = _mask(qpos, kpos, causal, window)
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # explicit zero for masked entries: when a whole chunk is masked for
        # a row, s == m_new == NEG_INF and exp(s - m_new) would be 1, not 0
        p = torch.exp(s - m_new[..., None])
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(v.dtype), vc).to(torch.float32)
        m = m_new
    l_safe = torch.where(l == 0, 1.0, l)
    out = (acc / l_safe[..., None]).to(q.dtype)  # (b,kv,g,sq,d)
    lse = m + torch.log(l_safe)
    return out, lse


def _flash_bwd_impl(q, k, v, out, lse, dout, *, causal, window, chunk):
    """The reference's explicit backward: per kv chunk, the probabilities
    from ``lse``, ``dS = P (dP - rowsum(dO O)) scale``."""
    b, sq, kvh, g, d = q.shape
    sk = k.shape[1]
    nchunks = sk // chunk
    scale = float(1.0 / np.sqrt(d))
    qpos = torch.arange(sq, device=q.device)
    # D_i = rowsum(dout * out)
    delta = torch.einsum("bkgqd,bkgqd->bkgq", dout.to(torch.float32),
                         out.to(torch.float32))
    dq = torch.zeros_like(q)
    dks, dvs = [], []
    for ci in range(nchunks):
        kc = k[:, ci * chunk:(ci + 1) * chunk]
        vc = v[:, ci * chunk:(ci + 1) * chunk]
        s = torch.einsum("bqkgd,bskd->bkgqs", q, kc).to(torch.float32) \
            * scale
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        mask = _mask(qpos, kpos, causal, window)
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - lse[..., None])  # (b,kv,g,q,s)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        dp = torch.einsum("bkgqd,bskd->bkgqs", dout.to(torch.float32),
                          vc.to(torch.float32))
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bkgqs,bskd->bqkgd", ds.to(q.dtype), kc)
        dks.append(torch.einsum("bkgqs,bqkgd->bskd", ds.to(q.dtype), q))
        dvs.append(torch.einsum("bkgqs,bkgqd->bskd", p.to(q.dtype), dout))
    return dq, torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


class _Flash(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward keeps ``(q, k, v, out,
    lse)``; the backward is :func:`_flash_bwd_impl`, not autograd through
    the forward's chunks."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk):
        out, lse = _flash_fwd_impl(q, k, v, causal=causal, window=window,
                                   chunk=chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, chunk = ctx.opts
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, dout.contiguous(),
                                     causal=causal, window=window,
                                     chunk=chunk)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, chunk=1024):
    """Blockwise attention, O(S) memory: q (B,S,H,D), k/v (B,S,KV,D)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, d)
    sk = k.shape[1]
    chunk = min(chunk, sk)
    if sk % chunk:  # pad kv to a chunk multiple; masked out via positions
        pad = chunk - sk % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if not causal:  # causal mask already kills padded keys (kpos > qpos)
            raise NotImplementedError("pad only supported for causal")
    out = _Flash.apply(qg, k, v, causal, window, chunk)  # (b,kv,g,sq,d)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)


def attn_decode(q, k_cache, v_cache, valid_mask, seq_groups=()):
    """Single-token attention over a cache.

    q: (B,1,H,D); k/v_cache: (B,S,KV,D); valid_mask: (B,S) or (S,).
    Softmax is written max/sum-decomposed, as in the reference (whose
    cache may be sharded along S).  With ``seq_groups`` the cache is one
    rank's shard of the sequence: the max, the sum and the output are
    all-reduced over each of those process groups (the output in
    float32)."""
    import torch.distributed as dist

    b, _, h, d = q.shape
    kvh = k_cache.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).to(torch.float32)
    s = s / float(np.sqrt(d))
    if valid_mask.ndim == 1:
        valid_mask = valid_mask[None]
    s = torch.where(valid_mask[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).detach()
    for g in seq_groups:
        dist.all_reduce(m, dist.ReduceOp.MAX, group=g)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    for g in seq_groups:
        dist.all_reduce(l, group=g)
    o = torch.einsum("bkgs,bskd->bkgd", (p / l).to(v_cache.dtype), v_cache)
    if seq_groups:
        o = o.to(torch.float32)
        for g in seq_groups:
            dist.all_reduce(o, group=g)
        o = o.to(v_cache.dtype)
    return o.reshape(b, 1, h, d)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def tp_matmul_bf16reduce(x, w, *, batch_axes=None, group=None):
    """Tensor-parallel contraction with an explicit **bf16** cross-device
    combine: x (..., F/tp) x w (F/tp, D) -> all-reduce_bf16(..., D).

    The propagation (as GSPMD) would all-reduce float32 partial sums, at
    twice the wire bytes; here each rank's partial ``x @ w`` over its own
    ``F/tp`` slice is rounded to bf16 and summed over the ``model`` group
    by an all-reduce in bf16 (Megatron-style).  Three forms:

    * DTensors on a mesh with a ``model`` axis: under ``shard_map``, ``x``
      sharded over ``batch_axes`` on its first dim and over ``model`` on
      its last, ``w`` over ``model`` on its first; the result is sharded
      over ``batch_axes`` and whole over ``model``;
    * plain tensors with ``group``: they are this rank's slices, summed
      over ``group``;
    * otherwise (one device, or a mesh without ``model``) ``x @ w``."""
    if group is not None:
        return SR.sum_over((x @ w).to(torch.bfloat16), group)
    if not isinstance(x, DTensor) or \
            "model" not in x.device_mesh.mesh_dim_names:
        return x @ w
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    ba = batch_axes
    if isinstance(ba, tuple):
        ba = tuple(a for a in ba if a in names) or None
    elif ba not in names:
        ba = None
    nd = x.ndim
    model = mesh.get_group("model")
    return SR.shard_map(
        functools.partial(tp_matmul_bf16reduce, group=model), mesh,
        ((ba,) + (None,) * (nd - 2) + ("model",), ("model", None)),
        ((ba,) + (None,) * (nd - 1),))(x, w)


def mlp_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm": PSpec((d,), (None,), "ones"),
        "w_gate": PSpec((d, f), ("fsdp", "ffn")),
        "w_up": PSpec((d, f), ("fsdp", "ffn")),
        "w_down": PSpec((f, d), ("ffn", "fsdp")),
    }


def mlp(p, x, bf16_reduce: bool = False, batch_axes=None):
    """SwiGLU.  On DTensors the weights' FSDP shards are gathered first
    and the down product's partial sums all-reduced (column- then
    row-parallel, as Megatron and the reference's GSPMD lay it out)."""
    wg, wu, wd = (SR.fsdp_gather(p[k]) for k in ("w_gate", "w_up",
                                                  "w_down"))
    h = F.silu(x @ wg) * (x @ wu)
    if bf16_reduce:
        return tp_matmul_bf16reduce(h, wd, batch_axes=batch_axes)
    return SR.reduce_partial(h @ wd)
