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

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import PSpec
from repro_torch.sharding import rules as SR


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
    # on a mesh the product over the sharded channels is all-reduced here
    # (small: dt_rank + 2n wide), where torch 2.11's DTensor would ask the
    # next product for a Shard -> Partial redistribution it lacks
    proj = SR.reduce_partial(torch.einsum("bsd,dk->bsk", u, p["x_proj"]))
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


def _scan(chunk, dt, u, bmat, cmat, a, h):
    """The selective scan over the sequence from the state ``h``, a chunk
    at a time: ``(y (B,S,di) float32 before the skip, final state)``."""
    ys = []
    for i in range(0, dt.shape[1], chunk):
        sl = slice(i, i + chunk)
        da, db = _discretize(dt[:, sl], u[:, sl], bmat[:, sl], a)
        hs = _chunk_scan(da, db, h)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, cmat[:, sl]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def _sharded_scan(scan, dt, h):
    """``scan`` under ``shard_map``: each rank scans its rows of the batch
    and its ``d_inner`` channels (the rules' shards; the recurrence is
    elementwise over both), with ``B``/``C`` whole over the channels."""
    mesh = dt.device_mesh
    b, s, di = dt.shape
    n = h.shape[-1]

    def spec(logical, shape):
        return SR.spec_for(mesh, logical, shape)

    chan = spec(("batch", None, "d_inner"), (b, s, di))
    bc = spec(("batch", None, None), (b, s, n))
    hsp = spec(("batch", "d_inner", None), (b, di, n))
    fn = SR.shard_map(scan, mesh, (chan, chan, bc, bc, spec(
        ("d_inner", None), (di, n)), hsp), (chan, hsp))

    def run(dt, u, bmat, cmat, a, h):
        if not isinstance(h, DTensor):  # the zero state of a new sequence
            h = SR.from_full(h, mesh, SR.placements(mesh, hsp))
        return fn(dt, u, bmat, cmat, a, h)
    return run


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
    xz = torch.einsum("bsd,de->bse", x, SR.fsdp_gather(p["in_proj"]))
    u, z = torch.split(xz, di, dim=-1)
    conv = functools.partial(_conv, cfg)
    if isinstance(x, DTensor):
        # the causal pad along the sequence, on each rank's rows and
        # channels (DTensor's pad fails to redistribute on torch 2.11)
        mesh = x.device_mesh
        chan = SR.spec_for(mesh, ("batch", None, "d_inner"), tuple(u.shape))
        conv = SR.shard_map(
            lambda u, w, b_: _conv(cfg, {"conv_w": w, "conv_b": b_}, u),
            mesh, (chan, (None, chan[2]), (chan[2],)), (chan,))
        u_conv = conv(u, p["conv_w"], p["conv_b"])
    else:
        u_conv = conv(p, u)

    chunk = min(cfg.ssm_chunk, s)
    assert s % chunk == 0, (s, chunk)
    dt, bmat, cmat, a = _ssm_params(cfg, p, u_conv)
    h = (torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
         if state is None else state)
    scan = functools.partial(_scan, chunk)
    if isinstance(x, DTensor):
        scan = _sharded_scan(scan, dt, h)
    y, h = scan(dt, u_conv, bmat, cmat, a, h)
    y = y + u_conv.to(torch.float32) * p["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    out = SR.reduce_partial(torch.einsum("bse,ed->bsd", y, SR.fsdp_gather(
        p["out_proj"])))
    if not with_tail:
        return out, h
    pad = cfg.d_conv - 1
    if isinstance(u, DTensor):
        return out, h, SR.shard_map(
            lambda u: F.pad(u, (0, 0, pad, 0))[:, -pad:], u.device_mesh,
            (chan,), (chan,))(u)
    return out, h, F.pad(u, (0, 0, pad, 0))[:, -pad:]


def mamba_decode(cfg, p, x1, ssm_state, conv_tail):
    """Single-step: x1 (B,1,D); ssm_state (B,di,N); conv_tail (B,d_conv-1,di)."""
    di = cfg.d_inner
    xz = torch.einsum("bsd,de->bse", x1, SR.fsdp_gather(p["in_proj"]))
    u, z = torch.split(xz, di, dim=-1)  # (B,1,di)
    window = torch.cat([conv_tail, u], dim=1)  # (B,d_conv,di)
    # broadcast sums, not einsums (DTensor has none over sharded
    # batch-like dims); the taps' products in float32 and rounded once,
    # as the einsum's
    taps = (window.float() * p["conv_w"].float()).sum(dim=1).to(
        window.dtype)
    u_conv = F.silu(taps + p["conv_b"])[:, None]
    dt, bmat, cmat, a = _ssm_params(cfg, p, u_conv)
    da, db = _discretize(dt, u_conv, bmat, a)  # (B,1,di,n)
    h = da[:, 0] * ssm_state + db[:, 0]
    y = (h * cmat[:, 0][:, None, :]).sum(dim=-1)[:, None]
    y = y + u_conv.to(torch.float32) * p["d_skip"]
    y = y.to(x1.dtype) * F.silu(z)
    out = SR.reduce_partial(torch.einsum("bse,ed->bsd", y, SR.fsdp_gather(
        p["out_proj"])))
    return out, h, window[:, 1:]
