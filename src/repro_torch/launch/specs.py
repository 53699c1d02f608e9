"""Shape stand-ins for every model input (port of the JAX package's
``repro.launch.specs``; no allocation), and their materialization.

``input_specs(cfg, cell, mesh)`` returns the arguments of the step a cell
runs, as trees of ``transformer.TensorSpec`` (global shape, dtype, the
spec on ``mesh``, one rank's shard shape): train -> (params, opt_state,
batch); prefill -> (params, tokens[, ext]); decode -> (params, cache,
tokens).  :func:`materialize` makes one rank's shards of such a tree as
DTensors on a ``DeviceMesh``.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.sharding import rules as SR


def _ts(mesh, shape, dtype, logical, rules=None):
    return T.tensor_spec(mesh, shape, dtype, logical, rules)


def batch_specs(cfg, cell, mesh):
    b, s = cell.batch, cell.seq
    rules = SR.rules_for_config(cfg)
    batch = {
        "tokens": _ts(mesh, (b, s), torch.int32, ("batch", "seq"), rules),
        "labels": _ts(mesh, (b, s), torch.int32, ("batch", "seq"), rules),
    }
    if cfg.is_encoder_decoder:
        batch["ext_embed"] = _ts(mesh, (b, cell.seq, cfg.d_model), cfg.dtype,
                                 ("batch", "seq", None), rules)
    elif getattr(cfg, "img_tokens", 0):
        batch["ext_embed"] = _ts(mesh, (b, cfg.img_tokens, cfg.d_model),
                                 cfg.dtype, ("batch", None, None), rules)
    return batch


def _unsharded(shape, dtype=torch.float32):
    """A leaf the reference leaves unplaced: whole on every rank."""
    shape = tuple(shape)
    return T.TensorSpec(shape, dtype, (None,) * len(shape), shape)


def opt_state_specs(cfg, mesh, opt_name=None):
    """Optimizer state specs: AdamW's moments mirror the parameters'
    sharding; Adafactor's factored statistics are unsharded, as the
    reference gives them."""
    pshapes = T.shape_tree(cfg, mesh)
    name = opt_name or cfg.optimizer
    count = _unsharded((), torch.int32)
    if name == "adamw":
        def like(p):
            return p._replace(dtype=torch.float32)
        return {"mu": T.tree_map(like, pshapes),
                "nu": T.tree_map(like, pshapes), "count": count}

    def fac(p):
        if len(p.shape) >= 2:
            return {"vr": _unsharded(p.shape[:-1]),
                    "vc": _unsharded(p.shape[:-2] + p.shape[-1:])}
        return {"v": _unsharded(p.shape)}
    return {"v": T.tree_map(fac, pshapes), "count": count}


def input_specs(cfg, cell, mesh):
    """Returns (args tuple of TensorSpec trees, step_kind)."""
    params = T.shape_tree(cfg, mesh)
    rules = SR.rules_for_config(cfg)
    if cell.kind == "train":
        return (params, opt_state_specs(cfg, mesh),
                batch_specs(cfg, cell, mesh)), "train"
    if cell.kind == "prefill":
        b, s = cell.batch, cell.seq
        args = [params, _ts(mesh, (b, s), torch.int32, ("batch", "seq"),
                            rules)]
        if cfg.is_encoder_decoder or getattr(cfg, "img_tokens", 0):
            ln = cell.seq if cfg.is_encoder_decoder else cfg.img_tokens
            args.append(_ts(mesh, (b, ln, cfg.d_model), cfg.dtype,
                            ("batch", None, None), rules))
        return tuple(args), "prefill"
    if cell.kind == "decode":
        b = cell.batch
        cache = T.cache_shape_tree(cfg, mesh, b, cell.seq, rules=rules,
                                   shard_cache_seq=cell.wide_cache)
        tok = _ts(mesh, (b, 1), torch.int32, ("batch", None), rules)
        return (params, cache, tok), "decode"
    raise ValueError(cell.kind)


def materialize(specs, dmesh, device=None, seed: int = 0, *,
                vocab: int = 2):
    """This rank's shards of a TensorSpec tree (or one TensorSpec) as
    DTensors on the ``DeviceMesh`` ``dmesh``, each drawn at its shard's
    shape only: integer leaves of rank >= 1 (tokens, labels) uniform in
    ``[0, vocab)`` from ``seed`` and this rank's coordinate, 0-d leaves
    (the cache's ``pos``, a step count) zero, float leaves zeros (caches,
    optimizer states, the frames or patches of a cell).  ``device``:
    ``None`` the card."""
    from repro_torch.kernels.runtime import resolve_device

    dev = resolve_device(device)
    gen = SR.rank_generator(dmesh, seed, dev)

    def one(ts):
        if not ts.shape:
            return torch.zeros((), dtype=ts.dtype, device=dev)
        if ts.dtype.is_floating_point:
            local = torch.zeros(ts.local_shape, dtype=ts.dtype, device=dev)
        else:
            local = torch.randint(0, vocab, ts.local_shape, generator=gen,
                                  device=dev).to(ts.dtype)
        return SR.from_local(local, dmesh, SR.placements(dmesh, ts.spec),
                             ts.shape)

    if isinstance(specs, T.TensorSpec):
        return one(specs)
    return T.tree_map(one, specs)
