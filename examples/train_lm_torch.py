"""End-to-end LM training on the port: random weights, AdamW, the
deterministic data pipeline and the checkpoint/restart loop, through the
launcher (``repro_torch.launch.train``); the counterpart of
``examples/train_lm.py``.

It trains qwen3-4b's SMOKE config on the CUDA card (``--device cpu`` for
the CPU), then verifies itself: the loss ends below a uniform guess over
the vocabulary (``log V``), and a second run stopped half way and resumed
from its checkpoint ends on the first run's loss exactly.

    python examples/train_lm_torch.py
    python examples/train_lm_torch.py --device cpu --steps 40
"""
import argparse
import math
import sys
import tempfile

from repro_torch.launch import train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be at least 2")

    common = ["--arch", args.arch, "--smoke", "--batch", "8", "--seq",
              "128", "--lr", "3e-3"] + (
        ["--device", args.device] if args.device else [])
    half = args.steps // 2
    with tempfile.TemporaryDirectory() as whole, \
            tempfile.TemporaryDirectory() as split:
        rec = train.main(common + ["--steps", str(args.steps),
                                   "--ckpt-every", str(half),
                                   "--ckpt-dir", whole])
        train.main(common + ["--steps", str(half), "--ckpt-dir", split])
        resumed = train.main(common + ["--steps", str(args.steps),
                                       "--ckpt-every", str(half),
                                       "--ckpt-dir", split])
    vocab_loss = math.log(train.config(args.arch, smoke=True).vocab)
    print(f"{rec['arch']}: {rec['steps_done']} steps on {rec['device']}, "
          f"loss {rec['last_loss']:.4f} (uniform {vocab_loss:.4f}); "
          f"resumed at step {half}: loss {resumed['last_loss']:.4f} in "
          f"{resumed['steps_done'] - half} steps")
    if not rec["last_loss"] < vocab_loss:
        print("FAILED: the loss did not fall below a uniform guess",
              file=sys.stderr)
        return 1
    if resumed["last_loss"] != rec["last_loss"]:
        print("FAILED: the resumed run ended on another loss",
              file=sys.stderr)
        return 1
    print(f"verified: trained and resumed from a checkpoint on "
          f"{rec['device']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
