"""Training and serving steps: port of the JAX package's
``repro.training.train_step``.

``make_train_step`` is the loss, the gradients (``torch.autograd.grad``
over the parameter tree's leaves), microbatch accumulation, clipping by
the global norm, the optional error-feedback compressor and the
optimizer's in-place update.  The reference's ``grad_shardings`` pins
gradients to the parameters' shardings on a mesh; on one device it is a
no-op, as the port's other sharding knobs are.  Nothing in a step reads
the device from the host: the metrics stay 0-d device tensors.

The cross-entropy picks each label's logit with ``torch.gather`` where
the reference takes a one-hot einsum (which keeps the vocab dim sharded
on a mesh): every other product of that einsum is an exact 0, so the
value and its gradient are the same.

The serving steps, ``make_prefill_step`` and ``make_decode_step``, run
under ``torch.no_grad`` (a served forward records no graph); the decode
step's next token is an argmax on the device."""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models import transformer as T
from repro_torch.sharding import rules as SR
from repro_torch.training import optimizer as O


def cross_entropy(logits, labels, vocab: int):
    """logits (B,S,V) float32, labels (B,S) int; the mean over tokens of
    ``logsumexp - logit[label]`` (``vocab``: the reference's one-hot
    width, which the gather does not need)."""
    if isinstance(logits, DTensor):
        return _cross_entropy_sharded(logits, labels).mean()
    lmax = logits.max(dim=-1, keepdim=True).values.detach()
    shifted = logits - lmax
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + lmax[..., 0]
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - picked).mean()


def _cross_entropy_sharded(logits, labels):
    """Each token's ``logsumexp - logit[label]`` (B,S) on DTensors, the
    logits sharded over the batch and the vocab as the rules place them.
    Under ``local_map`` each rank takes the max, the sum of exponentials
    and the label's logit over its vocab shard, combined over the vocab's
    mesh dims (the max and sum by all-reduces, the picked logit as a sum
    of one term and zeros), as the reference's one-hot product keeps the
    vocab sharded.  No tensor of the whole vocab is made (DTensor's own
    backward of the sum would expand its gradient to the whole row: 37
    GiB a rank for qwen3-4b's ``train_4k``)."""
    import torch.distributed as dist

    mesh = logits.device_mesh
    spec = SR.spec_for(mesh, ("batch", None, "vocab"), tuple(logits.shape))
    lpl = SR.placements(mesh, spec)
    tok = SR.placements(mesh, spec[:2])
    vdims = [i for i, p in enumerate(lpl) if p == Shard(2)]
    groups = [mesh.get_group(i) for i in vdims]
    shard = SR.shard_index(mesh, vdims)

    def local(lg, lb):
        v = lg.shape[-1]
        lmax = lg.max(dim=-1, keepdim=True).values.detach()
        for g in groups:
            dist.all_reduce(lmax, dist.ReduceOp.MAX, group=g)
        se = torch.sum(torch.exp(lg - lmax), dim=-1)
        off = lb.long() - shard * v
        here = (off >= 0) & (off < v)
        picked = torch.where(here, torch.gather(
            lg, -1, off.clamp(0, v - 1)[..., None])[..., 0], 0.0)
        for g in groups:
            se = SR.sum_over(se, g)
            picked = SR.sum_over(picked, g)
        return torch.log(se) + lmax[..., 0] - picked

    return local_map(local, out_placements=(tok,), in_placements=(lpl, tok),
                     in_grad_placements=(lpl, tok), device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels)


def make_loss_fn(cfg):
    def loss_fn(params, batch):
        logits, _, aux = T.forward(cfg, params, batch["tokens"],
                                   ext_embed=batch.get("ext_embed"),
                                   mode="train")
        with SR.on_mesh(logits):
            ce = cross_entropy(logits, batch["labels"], cfg.vocab)
            loss = ce + aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}
    return loss_fn


def value_and_grad(loss_fn):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ``((loss, metrics),
    grads)``, the grads a tree like ``params`` (each leaf in its
    parameter's dtype).  The leaves are differentiated as detached views
    of the parameters, so no graph is kept on them."""
    def grad_fn(params, batch):
        leaves = T.tree_leaves(params)
        live = {path: t.detach().requires_grad_(True) for path, t in leaves}
        with torch.enable_grad():
            loss, metrics = loss_fn(T._unflatten(params, live, _is_leaf),
                                    batch)
            # a leaf the loss does not reach gets zeros, as in JAX
            grads = torch.autograd.grad(loss, list(live.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), T._unflatten(
            params, dict(zip(live, grads)), _is_leaf)
    return grad_fn


def _is_leaf(x) -> bool:
    return not isinstance(x, dict)


def make_train_step(cfg, opt: O.Optimizer, *, clip_norm: float = 1.0,
                    compressor: Callable | None = None,
                    microbatches: int = 1, grad_shardings=None):
    """Returns ``train_step(params, opt_state, batch[, comp_state])``; the
    batch's leaves are tensors on the parameters' device.

    ``microbatches`` > 1 accumulates the gradients of equal slices of the
    batch in float32 (the grads are then float32, as the reference's; with
    one microbatch they are in the parameters' dtype); ``compressor``
    hooks error-feedback gradient compression
    (``training/grad_compress.py``).  On a mesh (DTensor parameters)
    ``grad_shardings``, a tree of ``sharding.rules.Sharding`` such as
    ``transformer.param_shardings`` gives, pins each gradient to its
    parameter's placements (a reduce-scatter of the partial sums); without
    it the partial sums are all-reduced; off a mesh it is ignored.  The parameters and the optimizer's state are updated in
    place and returned."""
    grad_fn = value_and_grad(make_loss_fn(cfg))

    def pin(grads):
        if grad_shardings is None:
            # the partial sums all-reduced whole (the reference's GSPMD
            # default); left partial, the optimizer's first op would let
            # the propagation pick a reduction that depends on the depth
            return T.tree_map(lambda g: g.redistribute(
                g.device_mesh, tuple(Replicate() if p.is_partial() else p
                                     for p in g.placements))
                if isinstance(g, DTensor) else g, grads)
        return O.tree_zip_map(
            lambda g, sh: g.redistribute(g.device_mesh, SR.placements(
                g.device_mesh, sh.spec)) if isinstance(g, DTensor) else g,
            grads, grad_shardings)

    def compute_grads(params, batch):
        if microbatches == 1:
            (_, metrics), grads = grad_fn(params, batch)
            return grads, metrics
        acc = T.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        per = []
        for i in range(microbatches):
            # the reference's reshape (microbatches, -1, ...) and scan:
            # microbatch i is the i-th run of B / microbatches rows
            sub = {k: v.reshape((microbatches, -1) + tuple(v.shape[1:]))[i]
                   for k, v in batch.items()}
            (_, metrics), grads = grad_fn(params, sub)
            O.tree_zip_map(lambda a, g: a.add_(g.float() / microbatches),
                           acc, grads)
            del grads
            per.append(metrics)
        metrics = {k: torch.stack([m[k] for m in per]).mean()
                   for k in per[0]}
        return acc, metrics

    def train_step(params, opt_state, batch, comp_state=None):
        with SR.on_mesh(params):
            grads, metrics = compute_grads(params, batch)
            grads = pin(grads)
            grads, gnorm = O.clip_by_global_norm(grads, clip_norm)
            metrics["grad_norm"] = gnorm
            if compressor is not None:
                grads, comp_state = compressor(grads, comp_state)
            params, opt_state = opt.update(grads, opt_state, params)
        if compressor is not None:
            return params, opt_state, comp_state, metrics
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg, max_len: int | None = None):
    """``max_len``: total cache capacity (prompt + decode budget); default
    sizes the cache exactly to the prompt (the dry-run prefill cells)."""
    @torch.no_grad()
    def prefill_step(params, tokens, ext_embed=None):
        logits, cache, _ = T.forward(cfg, params, tokens,
                                     ext_embed=ext_embed, mode="prefill",
                                     cache_len=max_len)
        return logits[:, -1], cache
    return prefill_step


def make_decode_step(cfg):
    """``decode_step(params, cache, tokens)`` -> ``(next_tok (B,) int32,
    logits (B, V), cache)``; the cache's K and V are written in place."""
    @torch.no_grad()
    def decode_step(params, cache, tokens):
        logits, cache, _ = T.forward(cfg, params, tokens, mode="decode",
                                     cache=cache)
        if isinstance(logits, DTensor):
            next_tok = _argmax_sharded(logits[:, -1])
        else:
            next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, logits[:, -1], cache
    return decode_step


def _argmax_sharded(logits):
    """``argmax`` over the last dim of (B, V) DTensor logits, the vocab
    sharded as the rules place it: each rank's best over its shard, then
    the largest value over the vocab's mesh dims and the least index that
    holds it (``torch.argmax``'s first occurrence).  Returns this rank's
    rows, a plain int32 tensor."""
    import torch.distributed as dist

    mesh = logits.device_mesh
    spec = SR.spec_for(mesh, ("batch", "vocab"), tuple(logits.shape))
    lg = logits.redistribute(mesh, SR.placements(mesh, spec)).to_local()
    vdims = [i for i, p in enumerate(SR.placements(mesh, spec))
             if p == Shard(1)]
    best, idx = lg.max(dim=-1)
    idx = idx + SR.shard_index(mesh, vdims) * lg.shape[-1]
    top = best.clone()
    for i in vdims:
        dist.all_reduce(top, dist.ReduceOp.MAX, group=mesh.get_group(i))
    idx = torch.where(best == top, idx, torch.iinfo(idx.dtype).max)
    for i in vdims:
        dist.all_reduce(idx, dist.ReduceOp.MIN, group=mesh.get_group(i))
    return idx.to(torch.int32)
