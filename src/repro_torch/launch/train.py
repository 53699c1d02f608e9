"""Training launcher (port of ``python -m repro.launch.train``; it trains
on the CUDA card unless ``--device cpu`` asks for the CPU).

``python -m repro_torch.launch.train --smoke --device cpu --steps 20``
``python -m repro_torch.launch.train --arch qwen3-4b --steps 20``

Runs the fault-tolerant loop (``runtime.fault.run_loop``: checkpoint and
restart, straggler accounting) over the synthetic token pipeline, with
the arch's optimizer (``cfg.optimizer``).  The parameters are drawn by
``transformer.init_params`` (seed 0) on the device; each step runs
eagerly (no ``torch.compile``) and reads the loss back once.  ``--smoke``
selects the reduced config; ``--layers`` cuts the depth (a multiple of
the arch's block pattern), never the width.  A checkpoint directory that
already holds a checkpoint is resumed, as the reference's is.  Prints the
reference's summary line and returns a record.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch


def config(arch: str, smoke: bool = False, layers=None):
    """``arch``'s config (SMOKE with ``smoke``), cut to ``layers``."""
    from repro_torch.configs import registry

    cfg = (registry.get_smoke_config(arch) if smoke
           else registry.get_config(arch))
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (a multiple "
                    "of the arch's block pattern)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.runtime.fault import run_loop
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import make_train_step

    dev = resolve_device(args.device)
    cfg = config(args.arch, args.smoke, args.layers)
    opt = O.make_optimizer(cfg.optimizer, lr=args.lr)
    compressor = None
    comp_state = [None]
    if args.compress_grads:
        from repro_torch.training.grad_compress import \
            make_error_feedback_compressor
        cinit, compressor = make_error_feedback_compressor()
    step = make_train_step(cfg, opt, compressor=compressor,
                           microbatches=args.microbatches)

    def make_state():
        params = T.init_params(cfg, 0, device=dev)
        if args.compress_grads:
            comp_state[0] = cinit(params)
        return params, opt.init(params)

    def step_fn(params, opt_state, batch):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        if "ext_embed" in batch:
            batch["ext_embed"] = batch["ext_embed"].to(cfg.dtype)
        if args.compress_grads:
            p, o, comp_state[0], m = step(params, opt_state, batch,
                                          comp_state[0])
            return p, o, m
        return step(params, opt_state, batch)

    pipe = TokenPipeline(cfg.vocab, args.batch, args.seq, seed=0,
                         ext_embed_len=(cfg.enc_len if cfg.is_encoder_decoder
                                        else cfg.img_tokens),
                         d_model=cfg.d_model)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    report = run_loop(ckpt_dir=args.ckpt_dir, total_steps=args.steps,
                      make_state=make_state, step_fn=step_fn,
                      pipeline=pipe, ckpt_every=args.ckpt_every, device=dev)
    n = cfg.param_count()
    med = (np.median(report.step_times) * 1e3 if report.step_times
           else float("nan"))
    print(f"arch={cfg.name} params~{n/1e6:.1f}M steps={report.steps_done} "
          f"loss={report.last_loss:.4f} restarts={report.restarts} "
          f"stragglers={report.straggler_steps} "
          f"median_step={med:.1f}ms")
    return {"arch": cfg.name, "device": dev.type, "n_layers": cfg.n_layers,
            "params": n, "optimizer": cfg.optimizer, "batch": args.batch,
            "seq": args.seq, "steps_done": report.steps_done,
            "last_loss": report.last_loss, "restarts": report.restarts,
            "straggler_steps": report.straggler_steps,
            "step_s": report.step_times,
            "peak_allocated_bytes": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None)}


if __name__ == "__main__":
    main()
