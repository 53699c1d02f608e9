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
host.  On a mesh (DTensors) the routing and the dispatch run on each
rank's rows of the batch under ``local_map``, and the experts' weights
are sharded by the rules (over ``experts`` with ``expert_parallel``).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

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


def _dispatch(cfg, r, x):
    """The (B, E, cap, D) expert inputs of ``x`` under the plan ``r``."""
    b, s, d = x.shape
    e, k, cap = cfg.n_experts, cfg.top_k, r["cap"]
    rows = torch.arange(b, device=x.device)[:, None]
    tok_flat = (rows * s + r["order"] // k).reshape(-1)
    # dispatch: (b, e*cap + 1, d); the sentinel row takes every dropped
    # entry (written more than once: any of them, then sliced off)
    buf = x.new_zeros((b * (e * cap + 1), d))
    buf.index_copy_(0, (rows * (e * cap + 1) + r["slot"]).reshape(-1),
                    x.reshape(b * s, d).index_select(0, tok_flat))
    return buf.view(b, e * cap + 1, d)[:, :e * cap].reshape(b, e, cap, d)


def _combine(cfg, y, top_w, order, slot, keep):
    """The tokens' outputs (B, S, D) from the experts' ``y`` (B,E,cap,D):
    each token's top-k rows, weighted by the router."""
    b, e, cap, d = y.shape
    k = cfg.top_k
    s = order.shape[1] // k
    rows = torch.arange(b, device=y.device)[:, None]
    tok_flat = (rows * s + order // k).reshape(-1)
    # gather back to sorted order, weight, add to the tokens.  A dropped
    # entry reads some kept row and is zeroed by ``keep``, where the
    # reference reads an appended zero row: the same sum
    gathered = y.reshape(b * e * cap, d).index_select(
        0, (rows * (e * cap) + slot.clamp(max=e * cap - 1)).reshape(-1))
    w_sorted = torch.take_along_dim(top_w.reshape(b, s * k), order, dim=-1)
    gathered = gathered.view(b, s * k, d) * w_sorted[..., None].to(
        gathered.dtype)
    gathered = torch.where(keep[..., None], gathered, 0)
    # each token receives top_k terms onto a zero: with k = 2 the sum
    # does not depend on the order of the adds
    out = y.new_zeros((b * s, d))
    out.index_add_(0, tok_flat, gathered.reshape(b * s * k, d))
    return out.view(b, s, d)


def _experts(p, buf):
    """The batched SwiGLU of every expert on its (B, E, cap, D) slots:
    experts first, the groups' slots flattened, one ``bmm`` an expert
    (a broadcast matmul would copy the weights for every row, and on
    DTensors an einsum keeps permuted strides on its result, whose view
    then fails in the backward).  On DTensors the weights' FSDP shards
    are gathered first."""
    from repro_torch.sharding import rules as SR

    wg, wu, wd = (SR.fsdp_gather(p[k]) for k in ("w_gate", "w_up",
                                                  "w_down"))
    b, e, cap, d = buf.shape
    xe = buf.permute(1, 0, 2, 3).reshape(e, b * cap, d)
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    y = SR.reduce_partial(torch.bmm(h, wd))
    return y.reshape(e, b, cap, d).permute(1, 0, 2, 3)


def moe_ffn(cfg, p, x):
    """x: (B, S, D) -> (out (B, S, D), aux_loss float32 scalar)."""
    if isinstance(x, DTensor):
        return _moe_ffn_sharded(cfg, p, x)
    r = route(cfg, p, x)
    aux = aux_loss(cfg, r["probs"], r["top_e"])
    y = _experts(p, _dispatch(cfg, r, x))
    return _combine(cfg, y, r["top_w"], r["order"], r["slot"],
                    r["keep"]), aux


def _moe_ffn_sharded(cfg, p, x):
    """The MoE layer on DTensors.  The routing and the dispatch (a stable
    sort, the capacity slots, index copies: ops DTensor has no sharding
    rule for) run under ``shard_map`` on each rank's rows of the batch,
    whole along the sequence and the model dim (a group is a batch row,
    so no plan crosses ranks); the experts' products are DTensor ops on
    the sharded weights (over ``experts`` with ``expert_parallel``); the
    combine runs under ``shard_map`` again, on the batch's rows."""
    from repro_torch.sharding import rules as SR

    mesh = x.device_mesh
    rows = SR.spec_for(mesh, ("batch", None, None), tuple(x.shape))
    two = rows[:2]
    four = rows + (None,)

    def plan(x, router):
        r = route(cfg, {"router": router}, x)
        return (_dispatch(cfg, r, x).contiguous(), r["probs"], r["top_e"],
                r["top_w"], r["order"], r["slot"], r["keep"])

    buf, probs, top_e, top_w, order, slot, keep = SR.shard_map(
        plan, mesh, (rows, (None, None)),
        (four, rows, rows, rows, two, two, two))(x, p["router"])
    aux = aux_loss(cfg, probs, top_e)
    y = _experts(p, buf)
    out = SR.shard_map(functools.partial(_combine, cfg), mesh,
                       (four, rows, two, two, two), (rows,))(
        y, top_w, order, slot, keep)
    return out, aux
