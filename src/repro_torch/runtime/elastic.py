"""Elastic scaling: move a training checkpoint between placements (port
of the JAX package's ``repro.runtime.elastic``, on one device).

``rescale_checkpoint`` restores a checkpoint saved under any placement
and puts every leaf where the target wants it.  The on-disk format is
full arrays + manifest, so no resharding math is needed.  Here the target
is one ``torch.device`` where the reference has a mesh: every leaf is
restored onto it, and each leaf of ``shardings_for``'s tree names it.
The sharded form (a leaf's slice on each rank of a process group, and a
per-leaf placement in ``restore``) comes with the multi-device LM
(ROADMAP.md, Queue 1 item 6).

Combined with the deterministic data pipeline (state replays exactly) and
the step-granular checkpoints, this is the recover-on-different-capacity
path: lose a device -> restore the latest step onto the one that is left.
"""
from __future__ import annotations

from repro_torch.checkpoint import checkpoint as C
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def shardings_for(cfg, device=None):
    """Target placement tree for ``(params, opt_state)`` on ``device``
    (``None``: the card): the reference's tree, a device a leaf."""
    dev = resolve_device(device)
    pshard = T.tree_map(lambda _: dev, T.param_specs(cfg),
                        is_leaf=lambda x: isinstance(x, L.PSpec))
    # optimizer states mirror the param tree (adamw) or are factored
    # (adafactor: restored onto the default device)
    if cfg.optimizer == "adamw":
        opt = {"mu": pshard, "nu": pshard, "count": dev}
    else:
        opt = None
    return {"params": pshard, "opt_state": opt}


def rescale_checkpoint(ckpt_dir, cfg, device=None, step=None):
    """Restore ``(params, opt_state, extra)`` placed for ``device``."""
    tree, extra = C.restore(ckpt_dir, step=step,
                            device=resolve_device(device))
    if tree is None:
        return None, None, None
    return tree["params"], tree["opt_state"], extra
