"""Error-feedback int8 gradient compression (port of the JAX package's
``repro.training.grad_compress``).

Hierarchical data-parallel reduction does the in-pod reduce at full
precision and compresses only the pod-to-pod traffic: quantize to int8
with a per-leaf scale, sum over pods, dequantize, and carry the
quantization error into the next step (error feedback keeps the scheme
unbiased in the long run; Karimireddy et al. 2019).

``make_error_feedback_compressor`` is the drop-in ``compressor`` of
``make_train_step`` (it models the cross-pod hop in one program).  The
explicit collective form, ``hierarchical_pod_psum``, comes with the
multi-device LM (ROADMAP.md, Queue 1 item 6).  ``torch.round`` rounds
half to even, as ``jnp.round`` does, so ``q`` is the reference's bit for
bit.
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
