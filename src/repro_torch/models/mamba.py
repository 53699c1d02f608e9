"""Mamba (selective SSM) block for the Jamba hybrid.

Port of the JAX package's ``repro.models.mamba``.  Recurrence per channel
c and state dim n:

    h_t = exp(dt_t * A[c,n]) * h_{t-1} + dt_t * B_t[n] * x_t[c]
    y_t = sum_n C_t[n] * h_t[c,n] + D[c] * x_t[c]

Training/prefill runs a *chunked scan*: a loop over chunks of
``cfg.ssm_chunk`` steps carries the (B, d_inner, N) state, and inside a
chunk a log-step (Hillis-Steele) scan over the chunk axis takes the
place of the reference's ``jax.lax.associative_scan``: ceil(log2(chunk))
doublings, 6 for a chunk of 64.  The float operations are grouped
otherwise than XLA's, so the two agree to float32 rounding, not bit for
bit.  The per-step decays ``da`` and inputs ``db`` are formed one chunk
at a time (the reference forms them for the whole sequence): the values
are elementwise, so they are the same, and at jamba's width a chunk's
pair is some 0.5 GB where the whole sequence's is 17 GB.  Decode is the
O(1) single-step update.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import PSpec


def mamba_specs(cfg) -> dict:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.d_state
    dt_rank = max(1, d // 16)
    return {
        "norm": PSpec((d,), (None,), "ones"),
        "in_proj": PSpec((d, 2 * di), ("fsdp", "d_inner")),
        "conv_w": PSpec((cfg.d_conv, di), (None, "d_inner")),
        "conv_b": PSpec((di,), ("d_inner",), "zeros"),
        "x_proj": PSpec((di, dt_rank + 2 * n), ("d_inner", None)),
        "dt_proj": PSpec((dt_rank, di), (None, "d_inner")),
        "dt_bias": PSpec((di,), ("d_inner",), "zeros"),
        "a_log": PSpec((di, n), ("d_inner", None), "ones"),
        "d_skip": PSpec((di,), ("d_inner",), "ones"),
        "out_proj": PSpec((di, d), ("d_inner", "fsdp")),
    }


def _ssm_params(cfg, p, u):
    """u: (B, S, di) post-conv activations -> (dt (B,S,di) in u's dtype,
    B (B,S,n) and C (B,S,n) in float32, A (di,n) float32, negative)."""
    n = cfg.d_state
    dt_rank = p["dt_proj"].shape[0]
    proj = torch.einsum("bsd,dk->bsk", u, p["x_proj"])
    dt_in, bmat, cmat = torch.split(proj, [dt_rank, n, n], dim=-1)
    # F.softplus returns x itself for x > 20 where jax.nn.softplus keeps
    # log1p(exp(x)): about 2e-9 relative, inside float32's tolerance
    dt = F.softplus(torch.einsum("bsk,kd->bsd", dt_in, p["dt_proj"])
                    + p["dt_bias"])
    a = -torch.exp(p["a_log"].to(torch.float32))
    return dt, bmat.to(torch.float32), cmat.to(torch.float32), a


def _discretize(dt, u, bmat, a):
    """The reference's per-step ``da = exp(dt A)`` and ``db = (dt u) B``,
    (B, c, di, n) float32, for the steps given."""
    da = torch.exp(dt.to(torch.float32)[..., None] * a)
    db = (dt * u).to(torch.float32)[..., None] * bmat[..., None, :]
    return da, db


def _chunk_scan(da, db, h0):
    """Within-chunk scan of ``h_t = da_t * h_{t-1} + db_t`` along dim 1:
    Hillis-Steele doublings of the reference's combine
    ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``."""
    c = da.shape[1]
    a, b = da, db
    off = 1
    while off < c:
        a_new = a.clone()
        b_new = b.clone()
        a_new[:, off:] = a[:, :-off] * a[:, off:]
        b_new[:, off:] = a[:, off:] * b[:, :-off] + b[:, off:]
        a, b = a_new, b_new
        off *= 2
    return a * h0[:, None] + b  # (B, c, di, n)


def _conv(cfg, p, u):
    """Causal depthwise conv (kernel ``cfg.d_conv``) and silu, as the
    reference sums its taps."""
    s = u.shape[1]
    pad = cfg.d_conv - 1
    u_pad = F.pad(u, (0, 0, pad, 0))
    u_conv = 0
    for i in range(cfg.d_conv):
        u_conv = u_conv + u_pad[:, i:i + s] * p["conv_w"][i]
    return F.silu(u_conv + p["conv_b"])


def mamba_seq(cfg, p, x, state=None, *, with_tail: bool = False):
    """Full-sequence mamba: x (B,S,D) -> (y (B,S,D), final_state), and
    with ``with_tail`` the last ``d_conv - 1`` rows of the pre-conv
    activations (zero-padded on the left), the decode cache's conv tail."""
    b, s, d = x.shape
    di, n = cfg.d_inner, cfg.d_state
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    u, z = torch.split(xz, di, dim=-1)
    u_conv = _conv(cfg, p, u)

    chunk = min(cfg.ssm_chunk, s)
    assert s % chunk == 0, (s, chunk)
    dt, bmat, cmat, a = _ssm_params(cfg, p, u_conv)
    h = (torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
         if state is None else state)
    ys = []
    for i in range(0, s, chunk):
        sl = slice(i, i + chunk)
        da, db = _discretize(dt[:, sl], u_conv[:, sl], bmat[:, sl], a)
        hs = _chunk_scan(da, db, h)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, cmat[:, sl]))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)
    y = y + u_conv.to(torch.float32) * p["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    if not with_tail:
        return out, h
    pad = cfg.d_conv - 1
    return out, h, F.pad(u, (0, 0, pad, 0))[:, -pad:]


def mamba_decode(cfg, p, x1, ssm_state, conv_tail):
    """Single-step: x1 (B,1,D); ssm_state (B,di,N); conv_tail (B,d_conv-1,di)."""
    di = cfg.d_inner
    xz = torch.einsum("bsd,de->bse", x1, p["in_proj"])
    u, z = torch.split(xz, di, dim=-1)  # (B,1,di)
    window = torch.cat([conv_tail, u], dim=1)  # (B,d_conv,di)
    u_conv = F.silu(torch.einsum("bkd,kd->bd", window, p["conv_w"])
                    + p["conv_b"])[:, None]
    dt, bmat, cmat, a = _ssm_params(cfg, p, u_conv)
    da, db = _discretize(dt, u_conv, bmat, a)  # (B,1,di,n)
    h = da[:, 0] * ssm_state + db[:, 0]
    y = torch.einsum("bdn,bn->bd", h, cmat[:, 0])[:, None]
    y = y + u_conv.to(torch.float32) * p["d_skip"]
    y = y.to(x1.dtype) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return out, h, window[:, 1:]
