"""GPipe pipeline parallelism over a ``torch.distributed`` group (port
of the JAX package's ``repro.training.pipeline_pp``).

Each rank of ``group`` is a stage: stage ``s`` holds blocks ``[s*nb/S,
(s+1)*nb/S)``; activations flow stage to stage through a ring permute
on a tick schedule: at tick ``t`` stage ``s`` works on microbatch ``t -
s`` (the classic GPipe wavefront, ``M + S - 1`` ticks), with the
reference's clip of the index and its ``active`` mask.  The embedding
runs on stage 0, the LM head + loss on the last stage.

The permute is a ``torch.autograd.Function`` (:class:`_RingPermute`):
its forward sends to stage ``s+1`` and receives from ``s-1``
(``batch_isend_irecv``), its backward sends the gradient the other way,
so ``torch.autograd.grad`` of the loss is pipeline-parallel training.
As in the reference, every stage runs every tick's blocks, head and loss
under the masks (``torch.where``), so that every stage's graph holds
every tick's permute and the backward's sends and receives pair up.

Two departures the framework asks for:

* the loss: the reference ``psum``s it over stages and the caller takes
  one copy, so each stage's own sum receives a cotangent of 1.  Here the
  value returned is the sum over the group, and the gradient flows into
  each stage's own contribution only (an autograd all-reduce whose
  result every rank backpropagates would give each stage ``S``);
* the tied embedding and ``final_norm``: their gradients are stage 0's
  lookup plus the last stage's head, summed over the group by
  :func:`make_pp_grad`; each rank keeps its own stage's block gradients.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models import layers as L
from repro_torch.models import transformer as T


class _RingPermute(torch.autograd.Function):
    """``x`` to stage ``s + 1``, the result from stage ``s - 1`` (mod S);
    the backward sends the gradient to ``s - 1`` and receives from
    ``s + 1``.  With one stage it is the identity, as ``ppermute`` is."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _permute(x, group, +1)

    @staticmethod
    def backward(ctx, g):
        return _permute(g.contiguous(), ctx.group, -1), None


def _permute(x, group, shift: int):
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    s = dist.get_rank(group)
    to = dist.get_global_rank(group, (s + shift) % n)
    frm = dist.get_global_rank(group, (s - shift) % n)
    out = torch.zeros_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), to, group),
           dist.P2POp(dist.irecv, out, frm, group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


def stage_blocks(cfg, blocks: dict, stage: int, stages: int) -> dict:
    """Stage ``stage``'s slice of the stacked block leaves (a leaf that
    already holds ``n_blocks / stages`` blocks is taken as this stage's
    own)."""
    per = cfg.n_blocks // stages

    def one(a):
        if a.shape[0] == per:
            return a
        return a[stage * per:(stage + 1) * per]
    return T.tree_map(one, blocks)


def make_pp_loss(cfg, group, *, stages: int, microbatches: int):
    """Returns ``loss_fn(params, batch) -> (loss, own)``: ``loss`` the
    mean over microbatches of the last stage's cross-entropy, summed over
    ``group`` (every rank returns it), and ``own`` this stage's part of
    it, the tensor to backpropagate.

    ``params["blocks"]`` holds the whole stack or this stage's blocks;
    ``embed`` and ``final_norm`` are whole on every stage.  Constraints:
    ``cfg.n_blocks % stages == 0``, ``batch % microbatches == 0``, the
    group's size is ``stages``."""
    from repro_torch.training.train_step import cross_entropy

    nb = cfg.n_blocks
    if nb % stages:
        raise ValueError(f"{nb} blocks do not split over {stages} stages")
    per_stage = nb // stages
    if dist.get_world_size(group) != stages:
        raise ValueError(f"the group has {dist.get_world_size(group)} "
                         f"ranks, not {stages} stages")
    stage = dist.get_rank(group)
    is_first, is_last = stage == 0, stage == stages - 1

    def loss_fn(params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        b = tokens.shape[0]
        if b % microbatches:
            raise ValueError(f"a batch of {b} does not split into "
                             f"{microbatches} microbatches")
        tok = tokens.reshape(microbatches, b // microbatches, -1)
        lab = labels.reshape(microbatches, b // microbatches, -1)
        bm, s = tok.shape[1], tok.shape[2]
        dev = tokens.device
        embed, fnorm = params["embed"], params["final_norm"]
        views = T.block_views(stage_blocks(cfg, params["blocks"], stage,
                                           stages), per_stage)
        positions = torch.arange(s, device=dev).expand(bm, s)

        def run_my_blocks(x):
            for bp in views:
                for i, kind in enumerate(cfg.block_pattern):
                    x, _, _ = T.apply_layer(cfg, kind, bp[f"p{i}"], x,
                                            positions=positions,
                                            mode="train")
            return x

        x_slot = torch.zeros((bm, s, cfg.d_model), dtype=cfg.dtype,
                             device=dev)
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        for t in range(microbatches + stages - 1):
            # receive the previous stage's output (ring; stage 0's unused)
            x_in = _RingPermute.apply(x_slot, group)
            mb = t - stage  # the microbatch this stage handles at tick t
            active = 0 <= mb < microbatches
            mb_c = min(max(mb, 0), microbatches - 1)
            x = torch.where(torch.tensor(is_first, device=dev),
                            embed[tok[mb_c]].to(cfg.dtype), x_in)
            y = run_my_blocks(x)
            y = torch.where(torch.tensor(active, device=dev), y,
                            torch.zeros_like(y))
            # the head and loss run on every stage, kept on the last
            xl = L.rms_norm(y, fnorm)
            logits = torch.einsum("bsd,vd->bsv", xl, embed).to(
                torch.float32)
            ce = cross_entropy(logits, lab[mb_c], cfg.vocab)
            loss_acc = loss_acc + torch.where(
                torch.tensor(active and is_last, device=dev), ce, 0.0)
            x_slot = y
        own = loss_acc / microbatches
        total = own.detach().clone()
        dist.all_reduce(total, group=group)
        return total, own

    return loss_fn


def make_pp_grad(cfg, group, *, stages: int, microbatches: int):
    """Returns ``grad_fn(params, batch) -> (loss, grads)``: the pipeline's
    loss (:func:`make_pp_loss`) and the gradients of this stage's
    parameters, ``embed`` and ``final_norm`` summed over ``group``, the
    blocks this stage's own (leaves ``(n_blocks / stages, ...)``)."""
    loss_fn = make_pp_loss(cfg, group, stages=stages,
                           microbatches=microbatches)
    stage = dist.get_rank(group)

    def grad_fn(params, batch):
        local = {"embed": params["embed"], "final_norm":
                 params["final_norm"], "blocks": stage_blocks(
                     cfg, params["blocks"], stage, stages)}
        leaves = T.tree_leaves(local)
        live = {p: t.detach().requires_grad_(True) for p, t in leaves}
        tree = T._unflatten(local, live, lambda x: not isinstance(x, dict))
        with torch.enable_grad():
            loss, own = loss_fn(tree, batch)
            grads = torch.autograd.grad(own, list(live.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        grads = dict(zip(live, grads))
        for k in ("embed", "final_norm"):
            grads[k] = grads[k].contiguous()
            dist.all_reduce(grads[k], group=group)
        return loss, T._unflatten(local, grads,
                                  lambda x: not isinstance(x, dict))

    return grad_fn
