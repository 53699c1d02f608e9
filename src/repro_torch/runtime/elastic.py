"""Elastic scaling: move a training checkpoint between device topologies
(port of the JAX package's ``repro.runtime.elastic``).

``rescale_checkpoint`` restores a checkpoint saved under any placement
and places every leaf where the target wants it.  Because the on-disk
format is full arrays + manifest, no resharding math is needed.  The
target is either

* a ``DeviceMesh`` (the reference's mesh): each rank keeps its own shard
  of each leaf, placed by the sharding rules (``shardings_for``), as the
  reference's ``device_put`` with a ``NamedSharding`` does; or
* one device (``None``: the card, or a ``torch.device``/``"cpu"``), where
  every leaf is restored whole.

Combined with the deterministic data pipeline (state replays exactly) and
the step-granular checkpoints, this is the recover-on-different-capacity
path: lose a pod -> restore the latest step onto the remaining mesh.
"""
from __future__ import annotations

from repro_torch.checkpoint import checkpoint as C
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer as T
from repro_torch.sharding import rules as SR


def _is_mesh(target) -> bool:
    return hasattr(target, "mesh_dim_names")


def shardings_for(cfg, target=None):
    """Target placement tree for ``(params, opt_state)``.  On a
    ``DeviceMesh``: each parameter leaf's DTensor placements, AdamW's
    states like their parameters, ``count`` and Adafactor's states
    ``None`` (restored unsharded, as the reference leaves them).  On one
    device: the device, a leaf."""
    if not _is_mesh(target):
        dev = resolve_device(target)
        pshard = T.tree_map(lambda _: dev, T.param_specs(cfg))
        count = dev
    else:
        pshard = T.tree_map(lambda sh: SR.placements(target, sh.spec),
                            T.param_shardings(cfg, target))
        count = None
    if cfg.optimizer == "adamw":
        opt = {"mu": pshard, "nu": pshard, "count": count}
    else:
        opt = None
    return {"params": pshard, "opt_state": opt}


def rescale_checkpoint(ckpt_dir, cfg, new_mesh=None, step=None):
    """Restore ``(params, opt_state, extra)`` placed for ``new_mesh``: a
    ``DeviceMesh`` (DTensor leaves, each rank its shard; the leaves
    ``shardings_for`` leaves ``None`` whole on every rank) or one device
    (``None``: the card)."""
    if not _is_mesh(new_mesh):
        tree, extra = C.restore(ckpt_dir, step=step,
                                device=resolve_device(new_mesh))
        if tree is None:
            return None, None, None
        return tree["params"], tree["opt_state"], extra
    tree, extra = C.restore(ckpt_dir, step=step,
                            device=new_mesh.device_type)
    if tree is None:
        return None, None, None
    sh = shardings_for(cfg, new_mesh)

    def place(t, pl):
        return t if pl is None else SR.from_full(t, new_mesh, pl)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s.get(k) if isinstance(s, dict) else None)
                    for k, v in t.items()}
        return place(t, s)

    return (walk(tree["params"], sh["params"]),
            walk(tree["opt_state"], sh["opt_state"]), extra)
