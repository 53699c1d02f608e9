"""How far an LM's decode chain is from its teacher-forced forward, and
its card run from its CPU run, on the reference's draw of random weights
and at unit gain: ``lm_serve_checks.measure_hold`` (the check
``hold_fp32`` gates) in float32 and float64, then
``lm_serve_checks.card_vs_cpu`` on the arch's row's cut in float32.

    PYTHONPATH=src python tools/lm_hold_conditioning.py --arch whisper-tiny --batch 4
    PYTHONPATH=src python tools/lm_hold_conditioning.py --arch rwkv6-1.6b --batch 4 --seed 1
    PYTHONPATH=src python tools/lm_hold_conditioning.py --arch whisper-tiny --device cpu --no-card-vs-cpu

Prints one JSON line a (check, dtype, draw): the prefill's last logits
against the train forward's and the decode chain against teacher
forcing, or the card's logits against the CPU's, each as max |diff|
over the logits' rms (a card-vs-CPU miss prints the check's message).
A model whose float64 run is far from 0 is chaotic on that draw: the
float32 gate measures its conditioning there, not the code.
"""
import argparse
import dataclasses
import json
import time

import torch

from repro_torch.launch import lm_serve_checks as C
from repro_torch.launch import serve


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="whisper-tiny")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-len", type=int, default=None)
    ap.add_argument("--tokens", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--no-card-vs-cpu", action="store_true",
                    help="skip the card-vs-CPU runs")
    args = ap.parse_args(argv)
    row = C.ROWS.get(args.arch, {})
    prompt = args.prompt_len or row.get("prompt_len", 2048)
    tokens = args.tokens or row.get("tokens", 32)
    base = C.config(args.arch, layers=args.layers)
    for dtype in (torch.float32, torch.float64):
        for gain in (False, True):
            cfg = dataclasses.replace(base, dtype=dtype)
            params, toks, ext = serve.inputs(cfg, args.batch, prompt,
                                             seed=args.seed,
                                             device=args.device)
            if gain:
                C.unit_gain(cfg, params)
            t0 = time.perf_counter()
            out = C.measure_hold(cfg, params, toks, tokens, ext)
            print(json.dumps({
                "check": "hold", "arch": cfg.name,
                "n_layers": cfg.n_layers, "dtype": str(dtype),
                "unit_gain": gain, "batch": args.batch, "seed": args.seed,
                "prompt_len": prompt, "tokens": tokens,
                "device": toks.device.type,
                "prefill_vs_train_rel": out["prefill_vs_train_rel"],
                "decode_vs_teacher_forced_rel":
                    out["decode_vs_teacher_forced_rel"],
                "wall_s": time.perf_counter() - t0}), flush=True)
            del params, toks, ext
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    if args.no_card_vs_cpu:
        return
    for gain in (False, True):
        t0 = time.perf_counter()
        try:
            out = C.card_vs_cpu(
                C.config(args.arch),
                layers=row.get("cut_layers", C.CUT_LAYERS),
                pattern=row.get("cut_pattern"), prompt_len=C.CUT_PROMPT,
                tokens=C.CUT_TOKENS, device=args.device, gain=gain)
        except AssertionError as e:  # over REL_TOL: the check's message
            out = {"arch": args.arch, "unit_gain": gain, "failed": str(e),
                   "wall_s": time.perf_counter() - t0}
        print(json.dumps({"check": "card_vs_cpu", **out}), flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
