"""Step-granular checkpointing with atomic commit (port of the JAX
package's ``repro.checkpoint.checkpoint``, in its format).

Layout::

    <dir>/step_<n>/manifest.json     tree structure + metadata
    <dir>/step_<n>/arrays.npz        flattened leaves (key = tree path)

Writes go to ``step_<n>.tmp`` and are committed by an atomic rename, so a
crash mid-save never corrupts the latest checkpoint.  A checkpoint either
package writes restores in the other, with the same bits: numpy has no
bfloat16, so a bfloat16 leaf is stored as its uint16 bit pattern (read
through ``torch.int16``, no ``ml_dtypes``) with ``"bfloat16"`` in the
manifest, as the reference stores it.  A dtype numpy cannot hold and
that is not bfloat16 is refused, never narrowed.

``restore`` places every leaf on ``device`` (``None``: the card).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat):
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _to_numpy(v) -> tuple[np.ndarray, str]:
    """``(stored array, manifest dtype)`` of one leaf (a tensor on any
    device, a numpy array or a Python number)."""
    if not isinstance(v, torch.Tensor):
        a = np.asarray(v)
        return a, str(a.dtype)
    t = v.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    try:
        a = t.numpy()
    except TypeError as e:  # a dtype numpy lacks: refuse, do not narrow
        raise TypeError(f"cannot checkpoint a {t.dtype} leaf") from e
    return a, str(a.dtype)


def save(ckpt_dir, step: int, tree, extra: dict | None = None) -> str:
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    final = ckpt_dir / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    stored, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        stored[k], dtypes[k] = _to_numpy(v)
    np.savez(tmp / "arrays.npz", **stored)
    manifest = {
        "step": step,
        "keys": sorted(stored),
        "dtypes": dtypes,
        "shapes": {k: list(v.shape) for k, v in stored.items()},
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return str(final)


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def _to_torch(v: np.ndarray, want: str) -> torch.Tensor:
    if want == "bfloat16":  # stored as its uint16 bits
        return torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
    if str(v.dtype) != want:
        raise TypeError(f"a {want} leaf stored as {v.dtype}: not a dtype "
                        "the port restores")
    return torch.from_numpy(v)


def restore(ckpt_dir, step: int | None = None, device=None):
    """Returns ``(tree, extra)``, or ``(None, None)`` where ``ckpt_dir``
    holds no checkpoint; each leaf a tensor on ``device`` (``None``: the
    card)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, None
    dev = resolve_device(device)
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat = {}
    with np.load(d / "arrays.npz") as z:
        for k in manifest["keys"]:
            t = _to_torch(z[k], manifest["dtypes"][k])
            flat[k] = t.to(dev)
    return _unflatten(flat), manifest["extra"]


def prune(ckpt_dir, keep: int = 3):
    ckpt_dir = pathlib.Path(ckpt_dir)
    steps = sorted(p for p in ckpt_dir.glob("step_*")
                   if not p.name.endswith(".tmp"))
    for p in steps[:-keep]:
        shutil.rmtree(p)
