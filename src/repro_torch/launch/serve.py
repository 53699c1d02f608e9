"""Serving launcher: batched prefill + greedy decode with the KV cache
(port of ``python -m repro.launch.serve``; it serves on the CUDA card
unless ``--device cpu`` asks for the CPU).

``python -m repro_torch.launch.serve --smoke --device cpu`` (rwkv6-1.6b)
``python -m repro_torch.launch.serve --arch qwen3-4b --batch 4 --prompt-len 2048 --tokens 32``
``python -m repro_torch.launch.serve --arch mixtral-8x7b --layers 16 --prompt-len 2048 --tokens 32``

A random prompt batch (seeded ``torch.Generator`` on the device, as are
the random weights) is prefilled, then decoded one token a step.  An
encoder-decoder arch (whisper) gets random audio frames ``(B, enc_len,
D)`` and a vision arch random image patches ``(B, img_tokens, D)``,
standard normal in the model's dtype, drawn after the tokens from the
same generator; the prefill takes them, as the reference's launcher
does.  ``--layers`` cuts the depth (a multiple of the arch's block
pattern), never the width.  Prints
the reference's two lines and returns a record: the prefill's wall, the
decode's wall and its ms per token (the median of the steps after the
first; CUDA events on the card), tokens per second, the peak allocated
bytes, and with ``--census`` the aten ops of one more decode step (the op
census, ``repro_torch.analysis.ir``).  On the card the decode loop runs
under ``torch.cuda.set_sync_debug_mode("error")``: a step that read the
device from the host would raise.

Every family runs: dense, MoE, RWKV6, the Mamba hybrid, the
encoder-decoder and the vision one.  An SSM arch (``rwkv6``, ``jamba``)
needs a prompt that is a multiple of ``ssm_chunk`` (64), or shorter than
it: the chunked form asserts it, as the reference's does.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import statistics
import time

import torch


def inputs(cfg, batch: int, prompt_len: int, *, seed: int = 0,
           device=None):
    """``(params, tokens, ext_embed)``: random weights, then a random
    ``(batch, prompt_len)`` int32 prompt, then the external embeddings
    (:func:`ext_embed`, ``None`` for a text-only arch), drawn from one
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``None``: the
    card)."""
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.models import transformer as T

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = T.init_params(cfg, gen, device=dev)
    toks = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                         device=dev, dtype=torch.int32)
    return params, toks, ext_embed(cfg, batch, gen, dev)


def ext_embed(cfg, batch: int, gen: torch.Generator, device):
    """The stub frontends' output, as the reference's launcher draws it:
    ``(batch, enc_len, d_model)`` audio frames for an encoder-decoder arch,
    ``(batch, img_tokens, d_model)`` image patches for a vision arch,
    standard normal in ``cfg.dtype`` (the same distribution, not the same
    numbers); ``None`` for a text-only arch."""
    n = (cfg.enc_len if cfg.is_encoder_decoder
         else cfg.img_tokens if cfg.img_tokens else 0)
    if not n:
        return None
    return torch.randn((batch, n, cfg.d_model), generator=gen,
                       dtype=torch.float32, device=device).to(cfg.dtype)


@contextlib.contextmanager
def no_host_sync(device: torch.device):
    """On the card, any synchronisation with the host raises inside."""
    if device.type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


class _Clock:
    """Marks between decode steps: CUDA events on the card (no sync),
    the host's clock on the CPU (where each op runs to its end)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        """Milliseconds between consecutive marks (after a sync)."""
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [1e3 * (b - a) for a, b in pairs]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, *, batch: int, prompt_len: int, tokens: int, device=None,
          census: bool = False) -> dict:
    """Prefill a random batch and decode ``tokens`` tokens greedily (the
    first from the prefill's logits); returns the record."""
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.training.train_step import (make_decode_step,
                                                 make_prefill_step)

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        start_bytes = torch.cuda.memory_allocated(dev)
    params, toks, ext = inputs(cfg, batch, prompt_len, device=dev)
    n_params = T.param_count(params)
    prefill = make_prefill_step(cfg, max_len=prompt_len + tokens + 1)
    decode = make_decode_step(cfg)
    _sync(dev)
    t0 = time.perf_counter()
    last, cache = prefill(params, toks, ext)
    nxt = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
    _sync(dev)
    t1 = time.perf_counter()
    if cuda:
        prefill_peak = torch.cuda.max_memory_allocated(dev)
    out = [nxt]
    clock = _Clock(dev)
    with no_host_sync(dev):
        clock.mark()
        for _ in range(tokens - 1):
            nxt, _, cache = decode(params, cache, nxt)
            nxt = nxt[:, None]
            out.append(nxt)
            clock.mark()
    _sync(dev)
    t2 = time.perf_counter()
    step_ms = clock.intervals_ms()
    seqs = torch.cat(out, dim=1).cpu()
    rec = {"arch": cfg.name, "device": dev.type, "n_layers": cfg.n_layers,
           "params": n_params, "batch": batch,
           "prompt_len": prompt_len, "tokens": tokens,
           "prefill_s": t1 - t0, "decode_s": t2 - t1,
           "decode_steps": tokens - 1,
           "decode_ms_per_token": (statistics.median(step_ms[1:])
                                   if len(step_ms) > 1 else None),
           "decode_step_ms": step_ms,
           "tokens_per_s": (tokens - 1) * batch / max(t2 - t1, 1e-9),
           "peak_allocated_bytes": (torch.cuda.max_memory_allocated(dev)
                                    if cuda else None),
           "sampled_ids": seqs[0, :12].tolist()}
    if cuda:  # what the process held before, and the peak up to decode
        rec["allocated_at_start_bytes"] = start_bytes
        rec["prefill_peak_allocated_bytes"] = prefill_peak
    if census:
        from repro_torch.analysis import ir

        c = ir.census(decode, params, cache, nxt)
        rec["decode_step_aten_ops"] = c.op_count
        rec["decode_step_host_reads"] = c.host_reads
        rec["decode_step_top_ops"] = dict(sorted(
            c.op_counts.items(), key=lambda kv: -kv[1])[:8])
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (a multiple "
                    "of the arch's block pattern)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--census", action="store_true",
                    help="count the aten ops of one more decode step")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry

    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    rec = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                tokens=args.tokens, device=args.device, census=args.census)
    dt = rec["decode_s"]
    print(f"arch={cfg.name} batch={args.batch} prefill={rec['prefill_s']:.3f}s "
          f"decode={args.tokens - 1} tok in {dt:.3f}s "
          f"({rec['tokens_per_s']:.1f} tok/s)")
    print("sampled ids:", rec["sampled_ids"])
    return rec


if __name__ == "__main__":
    main()
