"""Time the gradient of a train step with the stacked block leaves taken
apart by ``torch.unbind`` (``transformer.block_views``) and by ``a[i]`` a
block at a time (what the forward did before), on the card.

    python tools/train_block_views.py                  # qwen3-4b whole
    python tools/train_block_views.py --layers 8 --reps 5

``a[i]``'s backward makes a zero tensor of the whole stacked leaf for
each block and the autograd engine adds the ``n_blocks`` of them;
``unbind``'s backward is one ``stack``.  Prints one JSON line a form, in
turns (unbind, index, index, unbind): the median wall of a gradient
(loss + ``torch.autograd.grad``, ending in a synchronize), its device
time by ``torch.profiler`` and the peak allocated bytes, beside the
card's name and power limit.  The gradients of the two forms must be
equal bit for bit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("train_block_views: no CUDA device is visible", file=sys.stderr)
        return 1
    from repro_torch.launch import train
    from repro_torch.launch.lm_serve_checks import _device_us
    from repro_torch.launch.train_checks import _batch
    from repro_torch.models import transformer as T
    from repro_torch.training import train_step as S

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = train.config(args.arch, layers=args.layers)
    params = T.init_params(cfg, 0, device=dev)
    batch = _batch(cfg, args.batch, args.seq, dev)
    grad_fn = S.value_and_grad(S.make_loss_fn(cfg))
    unbind = T.block_views

    def index(stacked, n):
        return [T.tree_map(lambda a, i=i: a[i], stacked) for i in range(n)]

    grads = {}
    for form in ("unbind", "index", "index", "unbind"):
        T.block_views = unbind if form == "unbind" else index
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            walls = []
            for _ in range(args.reps + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, g = grad_fn(params, batch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            grads.setdefault(form, g)
            del g
            dev_us = _device_us(lambda: grad_fn(params, batch), 1)
        finally:
            T.block_views = unbind
        print(json.dumps({
            "form": form, "arch": cfg.name, "n_layers": cfg.n_layers,
            "batch": args.batch, "seq": args.seq,
            "grad_wall_ms": 1e3 * statistics.median(walls[1:]),
            "grad_walls_s": walls, "grad_device_ms": sum(dev_us.values())
            / 1e3, "top_kernels_us": dict(list(dev_us.items())[:5]),
            "peak_allocated_bytes": peak, "nvidia_smi": smi}), flush=True)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        T.tree_leaves(grads["unbind"]), T.tree_leaves(grads["index"])))
    print(json.dumps({"grads_bit_equal": same, "nvidia_smi": smi}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
