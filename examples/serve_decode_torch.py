"""Batched serving demo on the PyTorch/CUDA port: prefill a batch of
prompts, then decode with the KV/state cache. It runs the SSM (RWKV6), the
sliding-window MoE (Mixtral) and the hybrid (Jamba: Mamba, attention and
MoE) cache machinery on their SMOKE configs, through the serve launcher.
Each cache is then checked in float32: the decode steps' logits against
one teacher-forced forward over the same tokens.

    PYTHONPATH=src python examples/serve_decode_torch.py               # the card
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu  # the CPU

Runs on the CUDA card unless ``--device cpu`` is given; without a card
and without that flag it fails rather than falling back to the CPU.
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import registry
from repro_torch.launch import lm_serve_checks, serve

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default=None,
                help="cpu to run on the CPU (default: the card)")
device = ap.parse_args().device
where = ["--device", device] if device else []

for arch in ("rwkv6-1.6b", "mixtral-8x7b", "jamba-1.5-large-398b"):
    # 1. serve: batched prefill, then greedy decode (bf16, random weights)
    rec = serve.main(["--arch", arch, "--smoke", "--batch", "4",
                      "--prompt-len", "32", "--tokens", "12", "--census"]
                     + where)
    assert rec["decode_step_host_reads"] == 0, rec
    # 2. the same cache path in float32: prefill vs the train forward, and
    #    the 12 decode steps vs one teacher-forced forward (an MoE arch at a
    #    capacity that drops nothing, as a decode step never does)
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype=torch.float32)
    params, toks, ext = serve.inputs(cfg, 2, 32, device=device)
    held = lm_serve_checks.hold_fp32(cfg, params, toks, 12, ext)
    print(f"{arch}: served on {rec['device']}; float32 decode vs teacher "
          f"forcing {held['decode_vs_teacher_forced_rel']:.2e} of the "
          f"logits' rms")

print(f"verified: 3 archs' prefill + decode caches on {rec['device']} "
      f"within {lm_serve_checks.REL_TOL} of teacher forcing")
