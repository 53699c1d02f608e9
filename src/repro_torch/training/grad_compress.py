"""Error-feedback int8 gradient compression (port of the JAX package's
``repro.training.grad_compress``).

Hierarchical data-parallel reduction does the in-pod reduce at full
precision and compresses only the pod-to-pod traffic: quantize to int8
with a per-leaf scale, sum over pods, dequantize, and carry the
quantization error into the next step (error feedback keeps the scheme
unbiased in the long run; Karimireddy et al. 2019).

Two entry points:

* ``make_error_feedback_compressor`` — the drop-in ``compressor`` of
  ``make_train_step`` (it models the cross-pod hop in one program);
* ``hierarchical_pod_psum`` — the explicit collective form over two
  ``torch.distributed`` groups (the reference's ``shard_map`` version
  over mesh axes), for a hand-scheduled gradient reduction.

``torch.round`` rounds half to even, as ``jnp.round`` does, so ``q`` is
the reference's bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import tree_map
from repro_torch.training.optimizer import tree_zip_map


def _quantize(x):
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.to(torch.float32) * scale


def make_error_feedback_compressor():
    """``(init, compress)``: ``compress(grads, err_state) ->
    (compressed_grads, new_err_state)``, both new trees."""

    def init(params):
        return tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)

    @torch.no_grad()
    def compress(grads, err):
        def one(g, e):
            x = g.float() + e
            q, scale = _quantize(x)
            deq = _dequantize(q, scale)
            return deq.to(g.dtype), x - deq

        out = tree_zip_map(one, grads, err)
        newg = tree_map(lambda o: o[0], out)
        newe = tree_map(lambda o: o[1], out)
        return newg, newe

    return init, compress


def hierarchical_pod_psum(tree, *, in_pod_group, pod_group,
                          compress: bool = True):
    """Sum every leaf of ``tree`` (this rank's gradients) over the
    in-pod group at full precision, then over ``pod_group`` compressed:
    each pod's sum quantized to int8 with its scale (:func:`_quantize`,
    in float32), the ``q`` summed as int32 and the scales averaged; the
    result is ``qsum * mean(scale)`` in the leaf's dtype.  With
    ``compress=False`` the second sum is a plain all-reduce.  Returns a
    new tree; the inputs are not written."""
    import torch.distributed as dist

    def one(g):
        g = g.clone()
        dist.all_reduce(g, group=in_pod_group)
        if not compress:
            dist.all_reduce(g, group=pod_group)
            return g
        q, scale = _quantize(g.float())
        qsum = q.to(torch.int32)
        dist.all_reduce(qsum, group=pod_group)
        dist.all_reduce(scale, group=pod_group)
        smean = scale / dist.get_world_size(pod_group)
        return (qsum.float() * smean).to(g.dtype)

    with torch.no_grad():
        return tree_map(one, tree)
