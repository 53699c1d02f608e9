"""One gloo rank of the port's multi-device LM cases (run by
``tests/test_torch_sharding.py`` and ``tests/test_torch_tp.py``, not
collected by pytest).

    python tests/torch_sharded_worker.py RANK WORLD WORKDIR JOB.json

The ranks rendezvous through a ``file://`` in ``WORKDIR`` and open a
``DeviceMesh`` of the job's mesh.  Each case reads its inputs from
``WORKDIR/<name>_in.npz`` (the weights by tree path, the tokens), runs
the port's sharded step on DTensors and rank 0 writes every result, made
whole (``full_tensor``), to ``WORKDIR/<name>_out.npz``.  Kinds:

* ``train``: ``value_and_grad`` (loss, metrics, gradients), then one
  ``make_train_step`` with the config's optimizer (its metrics and the
  parameters after it), with the gradients pinned when the case asks;
* ``serve``: a prefill of ``tokens[:, :prompt]`` into a cache of
  ``prompt + steps`` slots, the cache placed by the rules, then ``steps``
  decode steps on the given tokens (each step's logits, the final
  cache);
* ``census``: one prefill under the op census and ``CommDebugMode``;
* ``psum``: ``hierarchical_pod_psum`` over a (pod, data) mesh;
* ``elastic_save`` / ``elastic_restore``: a trained tree saved whole from
  the job's mesh, then ``rescale_checkpoint`` onto other meshes;
* ``pp``: GPipe over the world's ranks as stages;
* ``tp``: ``tp_matmul_bf16reduce`` on this rank's slices over the world;
  ``tp_dtensor``: ``mlp(..., bf16_reduce=True)`` on DTensors.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)


def _np(t):
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy().copy()


def _cfg(case):
    from repro_torch.configs import registry

    cfg = registry.get_smoke_config(case["arch"])
    kw = dict(case.get("overrides", {}))
    kw["dtype"] = torch.float32
    if "block_pattern" in kw:
        kw["block_pattern"] = tuple(kw["block_pattern"])
    return dataclasses.replace(cfg, **kw)


def _tree(inp, prefix):
    out: dict = {}
    for key in inp.files:
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[len(prefix):].split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = inp[key]
    return out


def _batch_dt(dm, a, logical):
    from repro_torch.sharding import rules as SR

    t = torch.from_numpy(np.asarray(a))
    return SR.from_full(t, dm, SR.placements(dm, SR.spec_for(
        dm, logical, tuple(t.shape))))


def run_train(case, dm, inp):
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as S

    cfg = _cfg(case)
    params = T.distribute_params(cfg, T.params_from_numpy(
        cfg, _tree(inp, "w."), device="cpu"), dm)
    batch = {"tokens": _batch_dt(dm, inp["tokens"], ("batch", "seq")),
             "labels": _batch_dt(dm, inp["labels"], ("batch", "seq"))}
    (loss, metrics), grads = S.value_and_grad(S.make_loss_fn(cfg))(
        params, batch)
    out = {f"m.{k}": _np(v) for k, v in metrics.items()}
    out["loss"] = _np(loss)
    out.update({f"g.{p}": _np(g) for p, g in T.tree_leaves(grads)})
    out.update({f"gspec.{p}": np.array(str(tuple(g.placements)))
                for p, g in T.tree_leaves(grads)})
    opt = O.make_optimizer(cfg.optimizer, lr=case.get("lr", 1e-3))
    gs = T.param_shardings(cfg, dm) if case.get("pin_grads") else None
    step = S.make_train_step(cfg, opt, grad_shardings=gs)
    params, state, m = step(params, opt.init(params), batch)
    out.update({f"sm.{k}": _np(v) for k, v in m.items()})
    out.update({f"p.{p}": _np(t) for p, t in T.tree_leaves(params)})
    out["count"] = np.array(int(state["count"]))
    return out


def run_serve(case, dm, inp):
    from repro_torch.models import transformer as T
    from repro_torch.training import train_step as S

    cfg = _cfg(case)
    params = T.distribute_params(cfg, T.params_from_numpy(
        cfg, _tree(inp, "w."), device="cpu"), dm)
    prompt, steps = case["prompt"], case["steps"]
    tokens = inp["tokens"]
    ext = None
    if "ext" in inp.files:
        ext = _batch_dt(dm, inp["ext"], ("batch", None, None))
    logits, cache = S.make_prefill_step(cfg, prompt + steps)(
        params, _batch_dt(dm, tokens[:, :prompt], ("batch", "seq")), ext)
    out = {"prefill": _np(logits)}
    cache = T.place_cache(cfg, cache, dm)
    # a sliding window's prefill keeps ``window`` slots (the reference's)
    clen = max(prompt + steps, cfg.window or 0)
    want = dict(T.tree_leaves(T.cache_shape_tree(
        cfg, dm, tokens.shape[0], clen), T._is_tensor_spec))
    out["local_shapes_ok"] = np.array(all(
        tuple(t.to_local().shape) == want[path].local_shape
        for path, t in T.tree_leaves(cache) if path != "pos"))
    decode = S.make_decode_step(cfg)
    for i in range(steps):
        tok = _batch_dt(dm, tokens[:, prompt + i:prompt + i + 1],
                        ("batch", None))
        nxt, lg, cache = decode(params, cache, tok)
        out[f"decode{i}"] = _np(lg)
        out[f"tok{i}"] = nxt.numpy()  # this rank's rows of the batch
    out.update({f"c.{p}": _np(t) for p, t in T.tree_leaves(cache)})
    return out


def run_census(case, dm, inp):
    """One prefill step under the op census and under ``CommDebugMode``:
    the collectives' counts by kind from each."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.analysis import ir
    from repro_torch.models import transformer as T
    from repro_torch.training import train_step as S

    cfg = _cfg(case)
    params = T.distribute_params(cfg, T.params_from_numpy(
        cfg, _tree(inp, "w."), device="cpu"), dm)
    tok = _batch_dt(dm, inp["tokens"], ("batch", "seq"))
    step = S.make_prefill_step(cfg)
    step(params, tok)  # DTensor's propagation caches filled
    _, c = ir.record(step, params, tok)
    census: dict = {}
    for x in c.collectives:
        census[x.kind] = census.get(x.kind, 0) + 1
    cm = CommDebugMode()
    with cm:
        step(params, tok)
    debug: dict = {}
    for op, n in cm.get_comm_counts().items():
        kind = ir.COLLECTIVE_KINDS.get("_" + str(op))
        debug[kind] = debug.get(kind, 0) + n
    return {"census": np.array(json.dumps(census, sort_keys=True)),
            "debug": np.array(json.dumps(debug, sort_keys=True))}


def run_psum(case, dm, inp):
    """``hierarchical_pod_psum`` over a (pod 2, data 2) mesh of the four
    ranks: the in-pod group is ``data``, the pod group ``pod``; every
    rank's result."""
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.training import grad_compress as G

    pm = device_mesh(Mesh((2, 2), ("pod", "data")), "cpu")
    r = dist.get_rank()
    tree = {k[len(f"r{r}."):]: torch.from_numpy(inp[k])
            for k in inp.files if k.startswith(f"r{r}.")}
    out = {}
    for compress in (True, False):
        got = G.hierarchical_pod_psum(tree, in_pod_group=pm.get_group("data"),
                                      pod_group=pm.get_group("pod"),
                                      compress=compress)
        for k, v in got.items():
            t = v.contiguous()
            parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
            dist.all_gather(parts, t)
            for i, x in enumerate(parts):
                out[f"{int(compress)}.r{i}.{k}"] = x.numpy()
    return out


def run_elastic_save(case, dm, inp):
    """A one-step trained tree (AdamW) sharded on the job's mesh, saved
    whole by rank 0 to ``WORKDIR/ckpt``; also returned whole."""
    from repro_torch.checkpoint import checkpoint as C
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as S

    cfg = _cfg(case)
    params = T.distribute_params(cfg, T.params_from_numpy(
        cfg, _tree(inp, "w."), device="cpu"), dm)
    opt = O.make_optimizer("adamw", lr=1e-3)
    batch = {"tokens": _batch_dt(dm, inp["tokens"], ("batch", "seq")),
             "labels": _batch_dt(dm, inp["labels"], ("batch", "seq"))}
    params, state, _ = S.make_train_step(cfg, opt)(params, opt.init(params),
                                                   batch)
    whole = T.tree_map(lambda t: t.full_tensor() if hasattr(
        t, "full_tensor") else t, {"params": params, "opt_state": state})
    if dist.get_rank() == 0:
        C.save(os.path.join(case["workdir"], "ckpt"), 1, whole,
               extra={"data_state": {"step": 1}})
    dist.barrier()
    return {f"t.{p}": _np(t) for p, t in T.tree_leaves(whole)}


def run_elastic_restore(case, dm, inp):
    """``rescale_checkpoint`` of ``WORKDIR/ckpt`` onto each of the case's
    meshes of this job's ranks: every leaf made whole again."""
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.models import transformer as T
    from repro_torch.runtime import elastic as E

    cfg = _cfg(case)
    out = {}
    for shape in case["meshes"]:
        m = device_mesh(Mesh(tuple(shape), ("data", "model")), "cpu")
        params, opt, extra = E.rescale_checkpoint(
            os.path.join(case["workdir"], "ckpt"), cfg, m)
        tag = "x".join(map(str, shape))
        tree = {"params": params, "opt_state": opt}
        for p, t in T.tree_leaves(tree):
            out[f"{tag}.{p}"] = _np(t)
            out[f"{tag}.spec.{p}"] = np.array(str(tuple(
                getattr(t, "placements", ()))))
        out[f"{tag}.extra"] = np.array(json.dumps(extra))
    return out


def run_pp(case, dm, inp):
    """GPipe over the world's ranks as stages: the loss and this rank's
    gradients (embed and final_norm summed over stages); all gathered to
    rank 0."""
    from repro_torch.models import transformer as T
    from repro_torch.training import pipeline_pp as PP

    cfg = _cfg(case)
    params = T.params_from_numpy(cfg, _tree(inp, "w."), device="cpu")
    batch = {"tokens": torch.from_numpy(inp["tokens"]).long(),
             "labels": torch.from_numpy(inp["labels"]).long()}
    n = dist.get_world_size()
    loss, grads = PP.make_pp_grad(cfg, dist.group.WORLD, stages=n,
                                  microbatches=case["microbatches"])(
        params, batch)
    out = {"loss": np.array(float(loss))}
    for p, g in T.tree_leaves(grads):
        parts = [torch.empty_like(g) for _ in range(n)]
        dist.all_gather(parts, g.contiguous())
        out[f"g.{p}"] = (torch.cat(parts) if p.startswith("blocks")
                         else parts[0]).numpy()
    return out


def run_tp_dtensor(case, dm, inp):
    """``mlp(..., bf16_reduce=True)`` on DTensors of the job's mesh (its
    ``model`` axis over the ranks): the whole result."""
    from repro_torch.models import layers as L
    from repro_torch.sharding import rules as SR

    x = torch.from_numpy(inp["x"])
    p = {k: torch.from_numpy(inp[k]) for k in ("w_gate", "w_up", "w_down")}
    xd = SR.from_full(x, dm, SR.placements(dm, ("data", None, None)))
    pd = {k: SR.from_full(v, dm, SR.placements(
        dm, ("model", None) if k == "w_down" else (None, "model")))
        for k, v in p.items()}
    with SR.on_mesh(xd):
        y = L.mlp(pd, xd, bf16_reduce=True, batch_axes="data")
    return {"y": _np(y), "dtype": np.array(str(y.dtype)),
            "spec": np.array(str(tuple(y.placements)))}


def run_tp(case, dm, inp):
    from repro_torch.models import layers as L

    r, n = dist.get_rank(), dist.get_world_size()
    x, w = inp["x"], inp["w"]
    f = x.shape[-1] // n
    got = L.tp_matmul_bf16reduce(
        torch.from_numpy(x[..., r * f:(r + 1) * f]),
        torch.from_numpy(w[r * f:(r + 1) * f]), group=dist.group.WORLD)
    return {"y": got.float().numpy(), "dtype": np.array(str(got.dtype))}


def main():
    rank, world, work, job = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    with open(job) as f:
        job = json.load(f)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        work, f"rendezvous_{job['tag']}"), rank=rank, world_size=world)
    from repro_torch.launch.mesh import Mesh, device_mesh

    dm = device_mesh(Mesh(tuple(job["mesh"]), tuple(job["axes"])), "cpu")
    for case in job["cases"]:
        inp = np.load(os.path.join(work, f"{case['name']}_in.npz"))
        case = {**case, "workdir": work}
        out = {"train": run_train, "serve": run_serve, "tp": run_tp,
               "tp_dtensor": run_tp_dtensor, "census": run_census,
               "psum": run_psum, "elastic_save": run_elastic_save,
               "elastic_restore": run_elastic_restore,
               "pp": run_pp}[case["kind"]](case, dm, inp)
        if rank == 0:
            np.savez(os.path.join(work, f"{case['name']}_out.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
