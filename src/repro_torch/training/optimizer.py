"""Optimizers: AdamW (float32 states) and Adafactor (factored second
moments, the optimizer of the >= 300B configs, whose full Adam states do
not fit).  Port of the JAX package's ``repro.training.optimizer``.

States mirror the parameter tree, as in the reference: AdamW's
``{"mu", "nu", "count"}``, Adafactor's ``{"v": {"vr", "vc"} | {"v"},
"count"}`` (a leaf of two or more dims keeps the means of its squared
gradient over its last dim and over its second-last, a smaller leaf the
whole).  ``count`` is a 0-d int32 tensor on the parameters' device: the
bias corrections and Adafactor's ``beta`` are computed from it on the
device in float32, so a step reads nothing back to the host.

``update(grads, state, params)`` works IN PLACE, leaf by leaf, under
``torch.no_grad``, and returns the same parameter and state tensors (as
the decode step returns its cache): the reference's functional update
would hold a second copy of every parameter and state, which for
qwen3-4b (8.04 GB of bf16 weights, 32.2 GB of float32 moments) does not
fit one 80 GB card.  Per element the expression is the reference's: the
moments in float32, the new weight computed in float32 and then cast to
the weight's dtype.  Its quirks are kept: weight decay applies to every
leaf (norms and the embedding too), and Adafactor factors the last two
dims of a STACKED leaf ``(n_blocks, a, b)`` and clips the update by its
rms over the whole stacked leaf, not a layer at a time.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.models.transformer import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (params, state), in place


def tree_zip_map(fn, tree, *rest):
    """``fn(leaf, *matching)`` over the leaves of ``tree``, the other trees
    matched by key (a node of ``rest`` under a leaf of ``tree`` is handed
    over whole: Adafactor's ``{"vr", "vc"}``)."""
    if isinstance(tree, dict):
        return {k: tree_zip_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def global_norm(tree) -> torch.Tensor:
    """``sqrt`` of the sum of every leaf's float32 sum of squares, the
    leaves in the reference's flatten order (sorted keys)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / (norm + 1e-9))`` IN PLACE;
    returns ``(tree, norm)``.  The product is taken in float32 and cast
    back, as JAX promotes a bf16 leaf times a float32 scale (a bf16 tensor
    times a 0-d float32 tensor would be computed in bf16 by PyTorch)."""
    norm = global_norm(tree)
    # a tensor over a tensor: ``max_norm / t`` would be computed as
    # ``reciprocal(t) * max_norm``, rounded twice
    scale = torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-9),
                        max=1.0)
    for _, g in tree_leaves(tree):
        g.copy_(g.float() * scale)
    return tree, norm


def _count(params):
    leaf = tree_leaves(params)[0][1]
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"mu": tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params),
                "nu": tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params),
                "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params):
        c = state["count"].add_(1)
        bc1 = 1 - torch.pow(b1, c.float())
        bc2 = 1 - torch.pow(b2, c.float())

        def upd(g, m, v, p):
            g32 = g.float()
            m.mul_(b1).add_(g32 * (1 - b1))
            v.mul_(b2).add_(g32.mul(1 - b2).mul_(g32))
            del g32
            step = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            p32 = p.float()
            step.add_(p32 * weight_decay).mul_(lr)
            p.copy_(p32 - step)

        tree_zip_map(upd, grads, state["mu"], state["nu"], params)
        return params, state

    return Optimizer(init, update)


def adafactor(lr: float = 3e-4, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second moments for >= 2-D leaves (over the last two dims)."""

    def _factored(shape):
        return len(shape) >= 2

    def init(params):
        def one(p):
            z = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        return {"v": tree_map(one, params), "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params):
        c = state["count"].add_(1)
        beta = 1.0 - (c.float() + 1.0) ** (-decay)

        def upd(g, v, p):
            g32 = g.float()
            g2 = g32 * g32 + eps
            if _factored(p.shape):
                v["vr"].mul_(beta).add_((1 - beta) * g2.mean(dim=-1))
                v["vc"].mul_(beta).add_((1 - beta) * g2.mean(dim=-2))
                vr, vc = v["vr"], v["vc"]
                rfac = vr / torch.clamp(vr.mean(dim=-1, keepdim=True),
                                        min=1e-30)
                prec = torch.rsqrt(rfac[..., None] * vc[..., None, :]
                                   + 1e-30)
                u = g32 * prec
            else:
                v["v"].mul_(beta).add_((1 - beta) * g2)
                u = g32 * torch.rsqrt(v["v"] + 1e-30)
            del g2
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            p.copy_(p.float() - lr * u)

        tree_zip_map(upd, grads, state["v"], params)
        return params, state

    return Optimizer(init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor}[name](**kw)
