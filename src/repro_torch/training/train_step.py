"""The serving steps of the JAX package's ``repro.training.train_step``:
``make_prefill_step`` and ``make_decode_step``.

The loss and the train step (one-hot cross-entropy, clipping, the
optimizers, microbatch accumulation) come with training on one device
(ROADMAP.md, Queue 1 item 4).  Both steps run under ``torch.no_grad`` (a
served forward records no graph) and neither reads a tensor back to the
host: the decode step's next token is an argmax on the device."""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T


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
