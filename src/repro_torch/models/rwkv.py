"""RWKV6 "Finch" block: time-mix with data-dependent decay + channel-mix.

Port of the JAX package's ``repro.models.rwkv``.  Recurrence per head
(state S in R^{dk x dv}):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t        (w_t data-dependent, in (0,1))
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

Training/prefill uses the *chunked* parallel form: a loop over chunks
carries S (the reference's ``lax.scan``); within a chunk the pairwise
decay tensor ``exp(Ce_t - C_s)`` (log-cumulative decays, always <= 1 for
s < t, so numerically safe) turns the recurrence into masked matmuls.
Decode is the O(1) per-step update.  Token-shift mixing uses static
per-channel mus (the data-dependent decay LoRA is kept, the 5-way
data-dependent token-shift LoRA is simplified away, as in the reference).
The decays, the state and the group norm run in float32, as there.  The
chunk's cumulative log-decays are summed in float64 and rounded once to
float32 (:func:`_chunk_step`): the chunked form and the decode step's
recurrence then round alike, where the reference's float32 sums let a
deep stack's decode chain drift from its teacher forcing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import PSpec

LORA_R = 64


def rwkv_specs(cfg) -> dict:
    d = cfg.d_model
    h = max(1, d // 64)
    dk = d // h
    return {
        "tm_norm": PSpec((d,), (None,), "ones"),
        "cm_norm": PSpec((d,), (None,), "ones"),
        "mu": PSpec((5, d), (None, None), "zeros"),  # r,k,v,g,w shifts
        "w_r": PSpec((d, d), ("fsdp", "d_inner")),
        "w_k": PSpec((d, d), ("fsdp", "d_inner")),
        "w_v": PSpec((d, d), ("fsdp", "d_inner")),
        "w_g": PSpec((d, d), ("fsdp", "d_inner")),
        "w_o": PSpec((d, d), ("d_inner", "fsdp")),
        "decay_base": PSpec((d,), (None,), "zeros"),
        "decay_a": PSpec((d, LORA_R), (None, None)),
        "decay_b": PSpec((LORA_R, d), (None, None)),
        "bonus_u": PSpec((h, dk), ("rwkv_heads", None), "zeros"),
        "ln_x": PSpec((d,), (None,), "ones"),
        "cm_mu": PSpec((2, d), (None, None), "zeros"),  # k, r shifts
        "cm_k": PSpec((d, cfg.d_ff), ("fsdp", "ffn")),
        "cm_v": PSpec((cfg.d_ff, d), ("ffn", "fsdp")),
        "cm_r": PSpec((d, d), ("fsdp", "d_inner")),
    }


def _heads(cfg):
    d = cfg.d_model
    h = max(1, d // 64)
    return h, d // h


def _shift(x, prev):
    """Token shift: x_{t-1} (prev carries across chunk/cache boundary)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _time_mix_inputs(cfg, p, x, x_prev):
    b, s, d = x.shape
    h, dk = _heads(cfg)
    xs = _shift(x, x_prev)
    mixed = x[None] + p["mu"][:, None, None, :] * (xs - x)[None]  # (5,B,S,D)
    xr, xk, xv, xg, xw = mixed.unbind(0)
    r = (xr @ p["w_r"]).reshape(b, s, h, dk)
    k = (xk @ p["w_k"]).reshape(b, s, h, dk)
    v = (xv @ p["w_v"]).reshape(b, s, h, dk)
    g = F.silu(xg @ p["w_g"])
    # data-dependent decay (Finch): w = exp(-exp(base + lora(xw)))
    dec = p["decay_base"] + torch.tanh(xw @ p["decay_a"]) @ p["decay_b"]
    logw = -torch.exp(torch.clamp(dec.to(torch.float32), -10.0, 4.0))
    logw = torch.clamp(logw, -8.0, -1e-4).reshape(b, s, h, dk)
    return r, k, v, g, logw


def _out_proj(cfg, p, o, g, x_dtype):
    b, s = o.shape[0], o.shape[1]
    d = cfg.d_model
    # per-head group norm; the population variance, as ``jnp.var``
    h, dk = _heads(cfg)
    oh = o.reshape(b, s, h, dk).to(torch.float32)
    mu = oh.mean(-1, keepdim=True)
    var = oh.var(-1, keepdim=True, correction=0)
    oh = (oh - mu) * torch.rsqrt(var + 1e-5)
    o = (oh.reshape(b, s, d) * p["ln_x"]).to(x_dtype)
    return (o * g) @ p["w_o"]


def _chunk_step(S, rc, kc, vc, lwc, u):
    """One chunk of the parallel form: (b,h,c,dk) inputs, state (b,h,dk,dv)
    -> (S', o (b,h,c,dv))."""
    rc32, kc32, vc32 = (a.to(torch.float32) for a in (rc, kc, vc))
    # the cumulative log-decays and their differences in float64, each
    # rounded once to float32 (the clip and the exp stay in float32, as
    # in the reference): a float32 cumsum reaches -60 to -500 over a
    # chunk of 64, and its rounding puts a relative error of that order
    # times float32's epsilon into every pairwise decay, which a deep
    # stack compounds against the decode step's recurrence
    cum64 = torch.cumsum(lwc, dim=2, dtype=torch.float64)  # C_t
    ce64 = cum64 - lwc  # exclusive: Ce_t = C_{t-1}
    ce = ce64.to(torch.float32)
    inter = torch.einsum("bhti,bhij->bhtj", rc32 * torch.exp(ce), S)
    # pairwise decays exp(Ce_t - C_s) for s < t  (<= 1, stable)
    dmat = torch.exp(torch.clamp(
        (ce64[:, :, :, None, :] - cum64[:, :, None, :, :]).to(torch.float32),
        -60.0, 0.0))
    # sum_i r_t k_s d_ts elementwise (as a three-operand einsum it lowers
    # to a batched GEMV, which led rwkv6-1.6b's prefill on an H100)
    amat = (rc32[:, :, :, None, :] * kc32[:, :, None, :, :] * dmat).sum(-1)
    c = rc.shape[2]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=rc.device),
                     -1)  # strictly lower: s < t
    amat = torch.where(tri[None, None], amat, 0.0)
    adiag = (rc32 * u[:, None, :] * kc32).sum(-1)
    intra = torch.einsum("bhts,bhsj->bhtj", amat, vc32) + \
        adiag[..., None] * vc32
    o = inter + intra  # (b,h,c,dv)
    # state to chunk end: S' = diag(e^{C_c}) S + sum_s diag(e^{C_c-C_s}) k v
    wtot = torch.exp(cum64[:, :, -1].to(torch.float32))  # (b,h,dk)
    kw = kc32 * torch.exp((cum64[:, :, -1:, :] - cum64).to(torch.float32))
    S_new = wtot[..., None] * S + torch.einsum("bhsi,bhsj->bhij", kw, vc32)
    return S_new, o


def time_mix_seq(cfg, p, x, state=None, x_prev=None):
    """x: (B,S,D). Returns (out, (S_state, last_x))."""
    b, s, d = x.shape
    h, dk = _heads(cfg)
    if x_prev is None:
        x_prev = x.new_zeros((b, d))
    r, k, v, g, logw = _time_mix_inputs(cfg, p, x, x_prev)
    chunk = min(max(cfg.ssm_chunk, 1), s)
    assert s % chunk == 0, (s, chunk)
    nch = s // chunk

    def per_chunk(a):  # (b,s,h,dk) -> (n,b,h,c,dk)
        return a.reshape(b, nch, chunk, h, dk).permute(1, 0, 3, 2, 4)

    rs, ks, vs, lw = (per_chunk(a) for a in (r, k, v, logw))
    u = p["bonus_u"].to(torch.float32)
    S = (torch.zeros((b, h, dk, dk), dtype=torch.float32, device=x.device)
         if state is None else state)
    outs = []
    for i in range(nch):
        S, o = _chunk_step(S, rs[i], ks[i], vs[i], lw[i], u)
        outs.append(o)
    o = torch.stack(outs, 0).permute(1, 0, 3, 2, 4).reshape(b, s, h, dk)
    out = _out_proj(cfg, p, o, g, x.dtype)
    return out, (S, x[:, -1])


def time_mix_decode(cfg, p, x1, state, x_prev):
    """Single step: x1 (B,1,D); state (B,H,dk,dv); x_prev (B,D)."""
    r, k, v, g, logw = _time_mix_inputs(cfg, p, x1, x_prev)
    r32 = r[:, 0].to(torch.float32)  # (b,h,dk)
    k32 = k[:, 0].to(torch.float32)
    v32 = v[:, 0].to(torch.float32)
    u = p["bonus_u"].to(torch.float32)
    kv = torch.einsum("bhi,bhj->bhij", k32, v32)
    o = torch.einsum("bhi,bhij->bhj", r32, state + u[..., None] * kv)
    S_new = torch.exp(logw[:, 0])[..., None] * state + kv
    out = _out_proj(cfg, p, o[:, None], g, x1.dtype)
    return out, S_new, x1[:, -1]


def channel_mix(cfg, p, x, x_prev=None):
    """RWKV channel-mix ffn. Returns (out, last_x)."""
    b, s, d = x.shape
    if x_prev is None:
        x_prev = x.new_zeros((b, d))
    xs = _shift(x, x_prev)
    xk = x + p["cm_mu"][0] * (xs - x)
    xr = x + p["cm_mu"][1] * (xs - x)
    k = torch.square(torch.relu(xk @ p["cm_k"]))
    out = torch.sigmoid(xr @ p["cm_r"]) * (k @ p["cm_v"])
    return out, x[:, -1]
