"""Top-k Mixture-of-Experts with group-local, capacity-sorted dispatch.

Port of the JAX package's ``repro.models.moe``.  Tokens are grouped by
their batch row, sorted by expert id *within the group* (a stable sort,
as ``jnp.argsort``, so that the same tokens keep their slots), bucketed
into (E, C) capacity slots, run through a batched expert einsum, and
combined back with router weights.  Overflow beyond capacity is dropped
(GShard-style) into a sentinel row that is sliced off; underflow is
padded with zeros.

Every index is a device tensor and no mask selects rows (no ``nonzero``),
so a decode step through an MoE layer never reads the device from the
host.  The expert-parallel placement (``cfg.expert_parallel``) is a
sharding of the multi-device LM (ROADMAP.md, Queue 1 item 6): on one
device every expert is local.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import PSpec


def moe_specs(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "norm": PSpec((d,), (None,), "ones"),
        "router": PSpec((d, e), ("fsdp", None)),
        "w_gate": PSpec((e, d, f), ("experts", "fsdp", "ffn")),
        "w_up": PSpec((e, d, f), ("experts", "fsdp", "ffn")),
        "w_down": PSpec((e, f, d), ("experts", "ffn", "fsdp")),
    }


def capacity(cfg, s: int) -> int:
    """Slots an expert has in a group of ``s`` tokens: the reference's own
    Python expression, so that float rounding gives the same integer."""
    return int(cfg.capacity_factor * cfg.top_k * s / cfg.n_experts) + 1


def route(cfg, p, x):
    """The router and the dispatch plan of ``x`` (B, S, D): a dict of
    ``probs`` (B,S,E) float32, ``top_w``/``top_e`` (B,S,k), ``order`` (the
    stable sort of the flattened (B, S*k) expert ids), ``slot`` (each
    sorted entry's row of the (E*cap + 1) dispatch buffer, ``E*cap`` the
    drop sentinel), ``keep`` and ``cap``."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = torch.einsum("bsd,de->bse", x, p["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)  # (b,s,k), descending
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = capacity(cfg, s)

    # sort (expert, position) within each group
    flat_e = top_e.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.take_along_dim(flat_e, order, dim=-1)
    # rank within expert bucket = position - first position of that expert
    pos = torch.arange(s * k, device=x.device)
    experts = torch.arange(e, device=x.device)
    first = torch.where(sorted_e[:, None, :] == experts[None, :, None],
                        pos, s * k).amin(dim=-1)  # (b, e)
    rank = pos[None, :] - torch.take_along_dim(first, sorted_e, dim=-1)
    keep = rank < cap
    slot = sorted_e * cap + torch.where(keep, rank, cap - 1)
    slot = torch.where(keep, slot, e * cap)  # drop sentinel
    return {"probs": probs, "top_w": top_w, "top_e": top_e, "order": order,
            "slot": slot, "keep": keep, "cap": cap}


def aux_loss(cfg, probs, top_e):
    """The load-balancing loss (Switch/GShard): ``coef * E * sum(me * ce)``,
    ``me`` the mean router probability of each expert and ``ce`` the share
    of tokens whose first choice it is (the reference's one-hot mean)."""
    e = cfg.n_experts
    me = probs.mean(dim=(0, 1))
    first = top_e[..., 0].reshape(-1, 1)
    ce = (first == torch.arange(e, device=probs.device)).to(
        torch.float32).mean(dim=0)
    return cfg.router_aux_coef * e * torch.sum(me * ce)


def moe_ffn(cfg, p, x):
    """x: (B, S, D) -> (out (B, S, D), aux_loss float32 scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    r = route(cfg, p, x)
    cap, order, slot, keep = r["cap"], r["order"], r["slot"], r["keep"]
    aux = aux_loss(cfg, r["probs"], r["top_e"])

    rows = torch.arange(b, device=x.device)[:, None]
    tok_idx = order // k  # token within group, in sorted order
    tok_flat = (rows * s + tok_idx).reshape(-1)
    # dispatch: (b, e*cap + 1, d); the sentinel row takes every dropped
    # entry (written more than once: any of them, then sliced off)
    buf = x.new_zeros((b * (e * cap + 1), d))
    buf.index_copy_(0, (rows * (e * cap + 1) + slot).reshape(-1),
                    x.reshape(b * s, d).index_select(0, tok_flat))
    buf = buf.view(b, e * cap + 1, d)[:, :e * cap].reshape(b, e, cap, d)

    # expert computation (batched over groups and experts)
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["w_gate"]))
    h = h * torch.einsum("becd,edf->becf", buf, p["w_up"])
    y = torch.einsum("becf,efd->becd", h, p["w_down"])  # (b,e,cap,d)

    # combine: gather back to sorted order, weight, add to the tokens.  A
    # dropped entry reads some kept row and is zeroed by ``keep``, where
    # the reference reads an appended zero row: the same sum
    gathered = y.reshape(b * e * cap, d).index_select(
        0, (rows * (e * cap) + slot.clamp(max=e * cap - 1)).reshape(-1))
    w_sorted = torch.take_along_dim(r["top_w"].reshape(b, s * k), order,
                                    dim=-1)
    gathered = gathered.view(b, s * k, d) * w_sorted[..., None].to(
        gathered.dtype)
    gathered = torch.where(keep[..., None], gathered, 0)
    # each token receives top_k terms onto a zero: with k = 2 the sum
    # does not depend on the order of the adds
    out = x.new_zeros((b * s, d))
    out.index_add_(0, tok_flat, gathered.reshape(b * s * k, d))
    return out.view(b, s, d), aux
