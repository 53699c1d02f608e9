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

from repro_torch.models import transformer as T
from repro_torch.training import optimizer as O


def cross_entropy(logits, labels, vocab: int):
    """logits (B,S,V) float32, labels (B,S) int; the mean over tokens of
    ``logsumexp - logit[label]`` (``vocab``: the reference's one-hot
    width, which the gather does not need)."""
    lmax = logits.max(dim=-1, keepdim=True).values.detach()
    shifted = logits - lmax
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + lmax[..., 0]
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - picked).mean()


def make_loss_fn(cfg):
    def loss_fn(params, batch):
        logits, _, aux = T.forward(cfg, params, batch["tokens"],
                                   ext_embed=batch.get("ext_embed"),
                                   mode="train")
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
    (``training/grad_compress.py``); ``grad_shardings`` is accepted and
    ignored on one device.  The parameters and the optimizer's state are
    updated in place and returned."""
    del grad_shardings  # one device: nothing to pin
    grad_fn = value_and_grad(make_loss_fn(cfg))

    def compute_grads(params, batch):
        if microbatches == 1:
            (_, metrics), grads = grad_fn(params, batch)
            return grads, metrics
        acc = T.tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
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
        grads, metrics = compute_grads(params, batch)
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
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, logits[:, -1], cache
    return decode_step
