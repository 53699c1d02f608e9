"""The port's multi-device LM (``repro_torch.sharding.rules``, the sharded
shape trees of ``models/transformer.py``, ``launch/specs.py``, the steps
on DTensors, ``grad_compress.hierarchical_pod_psum``, the census of
DTensor's collectives and ``runtime/elastic.py``'s sharded restore)
against the JAX package on the CPU.

The specs are compared in this process against the reference's
``spec_for`` on a device-less ``AbstractMesh`` at both production meshes.
The steps run as four gloo ranks (``tests/torch_sharded_worker.py``, a
``(data 2, model 2)`` ``DeviceMesh``, single-threaded ranks, a
``file://`` rendezvous under the test's temporary directory) while the
reference computes the same single-device functions here, on the same
weights (the reference's float32 init, key 0; mixtral's and jamba's at
unit gain, as ``tests/test_torch_training.py`` holds them) and tokens
from a numpy seed.  ``hierarchical_pod_psum`` is held against the
reference under ``compat.shard_map`` on four XLA host devices in one
subprocess.  Then two gloo ranks restore the four ranks' checkpoint at
meshes (2, 1) and (1, 2).

Tolerances, stated where each is used:
* specs: equal;
* loss and logits within 1e-4 (the logits of the rms of the reference's);
  every gradient leaf within the single-device gate of its rms (1e-4; jamba's
  2e-3, the float32 limit of a Mamba gradient); a step's metrics within
  1e-4 relative; AdamW's parameters after one step as
  ``test_torch_training._check_step_params`` argues (jamba's SMOKE
  pattern is cut to its first four layers, every mixer kind, for time);
* decode caches: each leaf within 1e-4 of its rms, ``pos`` exact;
* ``hierarchical_pod_psum``: equal bits (inputs whose in-pod sums are
  exact: small integers times powers of 2);
* the census's collective counts by kind: equal to ``CommDebugMode``'s;
* the elastic restore: every leaf's whole tensor equal bits."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.launch import shapes as RSH
from repro.models import transformer as JT
from repro.sharding import rules as RSR
from repro.training import optimizer as JO
from repro.training import train_step as JS
from repro_torch.configs import registry
from repro_torch.launch import shapes as SH
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import Mesh, production_mesh
from repro_torch.models import transformer as T
from repro_torch.sharding import rules as SR
from tests.test_torch_training import (GRAD_HOLDS, LR, _check_step_params,
                                       _grad_weights, _rms, _within)
from tests.test_torch_training import _weights as _ref_weights

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
       "PYTHONPATH": str(ROOT / "src")}
TIMEOUT = 240
LM_ARCHS = registry.all_arch_ids()
B, SEQ, PROMPT, STEPS = 4, 16, 8, 2
TOL = 1e-4
#: jamba's SMOKE pattern cut to its first half for the test's time: a
#: Mamba layer with the MLP and with the MoE, and the attention with the
#: MoE (every mixer of the family)
JAMBA_CUT = ("mamba+mlp", "mamba+moe", "mamba+mlp", "attn+moe")
#: the sharded cases: train steps (qwen3-4b with its gradients pinned),
#: prefill + decode of qwen3-4b and mixtral; jamba with expert
#: parallelism (4 experts over model = 2)
CASES = [
    dict(name="qwen_train", arch="qwen3-4b", kind="train", pin_grads=True),
    dict(name="qwen_serve", arch="qwen3-4b", kind="serve", prompt=PROMPT,
         steps=STEPS),
    dict(name="mixtral_train", arch="mixtral-8x7b", kind="train"),
    dict(name="mixtral_serve", arch="mixtral-8x7b", kind="serve",
         prompt=PROMPT, steps=STEPS),
    dict(name="rwkv_serve", arch="rwkv6-1.6b", kind="serve", prompt=PROMPT,
         steps=STEPS),
    dict(name="jamba_train", arch="jamba-1.5-large-398b", kind="train",
         overrides={"expert_parallel": True, "n_layers": 4,
                    "block_pattern": JAMBA_CUT}),
    dict(name="census", arch="qwen3-4b", kind="census"),
    dict(name="psum", kind="psum"),
    dict(name="elastic_save", arch="qwen3-4b", kind="elastic_save"),
]
RESTORE_MESHES = [[2, 1], [1, 2]]


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _abstract(multi_pod: bool):
    if multi_pod:
        return jax.sharding.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return jax.sharding.AbstractMesh((16, 16), ("data", "model"))


def _ref_spec(p) -> tuple:
    return tuple(p)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("with_cfg_rules", [False, True])
def test_spec_for_matches_the_reference_on_every_leaf(multi_pod,
                                                      with_cfg_rules):
    """Every leaf of ``param_specs`` and of ``cache_specs`` (the cache's
    sequence over ``seq_kv`` and ``seq_kv_wide``) of every LM config, at
    16x16 and 2x16x16, with and without the config's rules (expert
    parallelism on, to change them): the port's spec equals the
    reference's ``PartitionSpec`` entry by entry, and the local shape
    divides the global one by the axes' sizes."""
    amesh, mesh = _abstract(multi_pod), production_mesh(multi_pod)
    sizes = SR.mesh_sizes(mesh)
    n = 0
    for arch in LM_ARCHS:
        cfg = registry.get_config(arch)
        jcfg = rregistry.get_config(arch)
        if with_cfg_rules and cfg.n_experts:
            cfg = dataclasses.replace(cfg, expert_parallel=True)
            jcfg = dataclasses.replace(jcfg, expert_parallel=True)
        rules = SR.rules_for_config(cfg) if with_cfg_rules else None
        assert rules == (RSR.rules_for_config(jcfg) if with_cfg_rules
                         else None)
        leaves = [(ps.logical, ps.shape) for _, ps in T.tree_leaves(
            T.param_specs(cfg), T._is_spec)]
        for wide in (False, True):
            leaves += [(s[1], s[0]) for _, s in T.tree_leaves(
                T.cache_specs(cfg, 128, 32768, shard_cache_seq=wide),
                T._is_cache_leaf)]
        for logical, shape in leaves:
            got = SR.spec_for(mesh, logical, shape, rules)
            assert got == _ref_spec(RSR.spec_for(amesh, logical, shape,
                                                 rules)), (arch, logical)
            local = SR.local_shape(mesh, got, shape)
            for d, e in enumerate(got):
                axes = () if e is None else (e if isinstance(e, tuple)
                                              else (e,))
                assert local[d] * int(np.prod([sizes[a] for a in axes])) \
                    == shape[d]
            n += 1
    assert n > 300


@pytest.mark.parametrize("multi_pod", [False, True])
def test_shape_trees_match_the_reference(multi_pod):
    """``shape_tree`` / ``param_shardings`` / ``cache_shape_tree`` (the
    reference's merge order of the rules) and ``specs.input_specs``'
    batch and optimizer leaves (Adafactor's unsharded) against the
    reference's, on every LM config whose optimizer is Adafactor or
    AdamW, at the cells it has."""
    amesh, mesh = _abstract(multi_pod), production_mesh(multi_pod)
    from repro.launch import specs as RS

    for arch in LM_ARCHS:
        cfg, jcfg = registry.get_config(arch), rregistry.get_config(arch)
        got = dict(T.tree_leaves(T.shape_tree(cfg, mesh), T._is_tensor_spec))
        want = dict(T.tree_leaves(JT.shape_tree(jcfg, amesh)))
        assert got.keys() == want.keys()
        sh = dict(T.tree_leaves(T.param_shardings(cfg, mesh),
                                lambda x: isinstance(x, SR.Sharding)))
        for k, w in want.items():
            assert got[k].shape == tuple(w.shape)
            assert got[k].spec == tuple(w.sharding.spec) == sh[k].spec, k
        for cell in SH.cells_for(cfg):
            rcell = RSH.LM_SHAPES[cell.name]
            if cell.kind == "decode":
                c = T.cache_shape_tree(cfg, mesh, cell.batch, cell.seq,
                                       shard_cache_seq=cell.wide_cache)
                jc = JT.cache_shape_tree(jcfg, amesh, cell.batch, cell.seq,
                                         shard_cache_seq=rcell.wide_cache)
                for k, w in T.tree_leaves(jc):
                    g = dict(T.tree_leaves(c, T._is_tensor_spec))[k]
                    assert (g.shape, g.spec) == (tuple(w.shape), tuple(
                        w.sharding.spec)), (arch, cell.name, k)
            if cell.kind == "train":
                b = S.batch_specs(cfg, cell, mesh)
                jb = RS.batch_specs(jcfg, rcell, amesh)
                for k in jb:
                    assert (b[k].shape, b[k].spec) == (
                        tuple(jb[k].shape), tuple(jb[k].sharding.spec))
        ost = dict(T.tree_leaves(S.opt_state_specs(cfg, mesh),
                                 T._is_tensor_spec))
        jost = dict(T.tree_leaves(RS.opt_state_specs(jcfg, amesh)))
        assert ost.keys() == jost.keys()
        for k, w in jost.items():
            assert ost[k].shape == tuple(w.shape), k
            if cfg.optimizer == "adafactor" or k == "count":
                assert ost[k].spec == (None,) * len(w.shape), k
            else:
                assert ost[k].spec == tuple(w.sharding.spec), k


def test_placements_follow_mesh_order_and_refuse_others():
    """A dim over ``("pod", "data")`` is ``Shard(d)`` on both mesh dims;
    an entry out of mesh order is refused, not reordered."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = production_mesh(True)
    assert SR.placements(mesh, (("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert SR.placements(mesh, (None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        SR.placements(mesh, (("data", "pod"), None))
    assert SR.local_shape(mesh, (("pod", "data"), "model"), (64, 32)) == (
        2, 2)


def test_on_mesh_sets_the_flag_dtensor_reads():
    """``on_mesh`` writes DTensor's private
    ``_op_dispatcher._allow_implicit_replication``.  Off, an op that mixes
    a plain tensor with a DTensor is refused; on, the plain tensor counts
    as replicated; an inner ``on_mesh`` leaves an outer one on, and the
    flag is off again after both.  Fails if the flag's name or meaning
    changes.  On rank 1 of a fake (2, 2) world."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import device_mesh, fake_world

    disp = DTensor._op_dispatcher
    assert disp._allow_implicit_replication is False
    with fake_world(4, 1):
        dm = device_mesh(Mesh((2, 2), ("data", "model")), "cpu")
        x = SR.from_local(torch.ones(2, 3), dm, (Shard(0), Replicate()),
                          (4, 3))
        w = torch.arange(3.0)
        with pytest.raises(RuntimeError, match="mixed torch.Tensor"):
            x * w
        with SR.on_mesh(x):
            assert disp._allow_implicit_replication is True
            with SR.on_mesh({"x": x}):
                pass
            y = x * w
            assert isinstance(y, DTensor)
            assert torch.equal(y.to_local(), w.expand(2, 3))
        assert disp._allow_implicit_replication is False
        with SR.on_mesh(w):  # no DTensor: a null context
            assert disp._allow_implicit_replication is False


def test_fsdp_and_batch_axes_come_from_the_rules():
    """``fsdp_gather`` gathers a weight over the rules' ``fsdp`` axes and
    the activations' batch axes are the rules' ``batch``, on the mesh's
    axes: on rank 1 of a fake (2, 2) ``(data, model)`` world a weight
    sharded over both is left sharded over ``model`` only."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import device_mesh, fake_world

    with fake_world(4, 1):
        dm = device_mesh(Mesh((2, 2), ("data", "model")), "cpu")
        w = SR.from_local(torch.ones(2, 3), dm, (Shard(0), Shard(1)), (4, 6))
        assert SR.fsdp_gather(w).placements == (Replicate(), Shard(1))
        assert T._batch_axes(w) == "data"
        assert T._batch_axes(torch.ones(2)) is None
    assert SR.spec_for(production_mesh(True), ("batch",), (0,)) == (
        ("pod", "data"),)
    """qwen2-72b ``decode_32k`` at 16x16: a rank holds 5.37 GB of KV
    cache (80 x 2 x 8 x 2048 x 8 x 128 x 2 B) and its tokens' shard; its
    K and V projections are whole (8 kv heads do not split over 16), so
    its weights are 3.86 GB, not a 256th of 145 GB."""
    cfg = registry.get_config("qwen2-72b")
    (params, cache, tok), kind = S.input_specs(
        cfg, SH.LM_SHAPES["decode_32k"], production_mesh(False))
    assert kind == "decode"
    assert T.tree_bytes(cache) == 4 + 2 * 80 * 8 * 2048 * 8 * 128 * 2
    assert tok.local_shape == (8, 1)
    wk = params["blocks"]["p0"]["attn"]["wk"]
    assert wk.spec == (None,) * 4 and wk.local_shape == wk.shape
    assert T.tree_bytes(params) == 3_864_330_240


# ---------------------------------------------------------------------------
# the sharded steps on four gloo ranks
# ---------------------------------------------------------------------------

def _cfgs(case):
    kw = dict(case.get("overrides", {}), dtype=torch.float32)
    jkw = dict(case.get("overrides", {}), dtype=jnp.float32)
    return (dataclasses.replace(registry.get_smoke_config(case["arch"]), **kw),
            dataclasses.replace(rregistry.get_smoke_config(case["arch"]),
                                **jkw))


def _weights(case):
    """The case's float32 weights as numpy: the reference's init (key 0),
    at unit gain for mixtral and jamba (``test_torch_training``'s draw);
    a cut config's drawn for its own tree."""
    if case["arch"] not in GRAD_HOLDS:  # the reference's own draw
        return _ref_weights(case["arch"])
    if "n_layers" not in case.get("overrides", {}):
        return _grad_weights(case["arch"])
    from repro_torch.launch.lm_serve_checks import unit_gain

    cfg, jcfg = _cfgs(case)
    w = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = unit_gain(cfg, T.params_from_numpy(
        cfg, jax.tree.map(lambda a: np.asarray(a, np.float32), w),
        device="cpu"))
    return T.tree_map(lambda t: t.numpy().copy(), params)


def _tokens(vocab, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, SEQ)).astype(np.int32),
            rng.integers(0, vocab, (B, SEQ)).astype(np.int32))


def _write_inputs(work, case, seed):
    if case["kind"] == "psum":
        np.savez(work / "psum_in.npz", **_psum_inputs())
        return
    cfg, _ = _cfgs(case)
    w = _weights(case)
    tok, lab = _tokens(cfg.vocab, seed)
    np.savez(work / f"{case['name']}_in.npz", tokens=tok, labels=lab,
             **{f"w.{p}": np.asarray(a, np.float32)
                for p, a in T.tree_leaves(w)})


def _psum_inputs():
    """Rank ``r``'s gradients: small integers times powers of 2, so every
    in-pod sum is exact in float32 and bfloat16."""
    rng = np.random.default_rng(5)
    out = {}
    for r in range(4):
        out[f"r{r}.w"] = (rng.integers(-40, 41, (16, 8)) * 2.0 ** -6
                          ).astype(np.float32)
        out[f"r{r}.b"] = (rng.integers(-7, 8, (8,)) * 0.5).astype(np.float32)
    return out


def _spawn(work, job, world):
    path = work / f"job_{job['tag']}.json"
    path.write_text(json.dumps(job))
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_sharded_worker.py"),
         str(r), str(world), str(work), str(path)], env=ENV, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _wait(procs):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), outs[0][-4000:]


JAX_PSUM = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro import compat
    from repro.training import grad_compress as G
    inp = np.load(sys.argv[1])
    mesh = compat.make_mesh((2, 2), ("pod", "data"))
    out = {}
    for compress in (True, False):
        tree = {k: jnp.stack([jnp.asarray(inp[f"r{r}.{k}"]) for r in range(4)])
                for k in ("w", "b")}
        def f(t):
            t = {k: v[0] for k, v in t.items()}
            t = G.hierarchical_pod_psum(t, in_pod_axes=("data",),
                                        pod_axis="pod", compress=compress)
            return {k: v[None] for k, v in t.items()}
        spec = {k: P(("pod", "data")) for k in tree}
        got = jax.jit(compat.shard_map(f, mesh=mesh, in_specs=(spec,),
                                       out_specs=spec,
                                       check_vma=False))(tree)
        for k, v in got.items():
            for r in range(4):
                out[f"{int(compress)}.r{r}.{k}"] = np.asarray(v[r])
    np.savez(sys.argv[2], **out)
""")


def _jax_train(case, seed):
    cfg, jcfg = _cfgs(case)
    w = jax.tree.map(jnp.asarray, _weights(case))
    tok, lab = _tokens(cfg.vocab, seed)
    batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    (loss, m), g = jax.jit(jax.value_and_grad(JS.make_loss_fn(jcfg),
                                              has_aux=True))(w, batch)
    # the rest of the reference's train step on these gradients: its clip
    # and its optimizer (``make_train_step`` with one microbatch)
    opt = JO.make_optimizer(cfg.optimizer, lr=LR)
    clipped, norm = JO.clip_by_global_norm(g, 1.0)
    p2, _ = jax.jit(opt.update)(clipped, opt.init(w), w)
    return {"loss": float(loss), "m": {k: float(v) for k, v in m.items()},
            "g": {p: np.asarray(x) for p, x in T.tree_leaves(g)},
            "sm": {"loss": float(loss), "grad_norm": float(norm)},
            "p": {p: np.asarray(x) for p, x in T.tree_leaves(p2)},
            "w": {p: np.asarray(x) for p, x in T.tree_leaves(w)}}


def _jax_serve(case, seed):
    cfg, jcfg = _cfgs(case)
    w = jax.tree.map(jnp.asarray, _weights(case))
    tok, _ = _tokens(cfg.vocab, seed)
    P_, n = case["prompt"], case["steps"]
    lg, cache = jax.jit(JS.make_prefill_step(jcfg, P_ + n))(
        w, jnp.asarray(tok[:, :P_]))
    out = {"prefill": np.asarray(lg)}
    dec = jax.jit(JS.make_decode_step(jcfg))
    for i in range(n):
        _, lg, cache = dec(w, cache, jnp.asarray(tok[:, P_ + i:P_ + i + 1]))
        out[f"decode{i}"] = np.asarray(lg)
    out.update({f"c.{p}": np.asarray(x, np.float32)
                for p, x in T.tree_leaves(cache)})
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Job A on four ranks, the reference's results meanwhile, then job B
    (the restore) on two; ``(work, reference)``."""
    work = tmp_path_factory.mktemp("sharded")
    for i, case in enumerate(CASES):
        _write_inputs(work, case, seed=i)
    procs = _spawn(work, {"tag": "a", "mesh": [2, 2],
                          "axes": ["data", "model"], "cases": CASES}, 4)
    jproc = subprocess.Popen(
        [sys.executable, "-c", JAX_PSUM, str(work / "psum_in.npz"),
         str(work / "psum_ref.npz")], env=ENV, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ref = {}
    try:
        for i, case in enumerate(CASES):
            if case["kind"] == "train":
                ref[case["name"]] = _jax_train(case, seed=i)
            elif case["kind"] == "serve":
                ref[case["name"]] = _jax_serve(case, seed=i)
        out = jproc.communicate(timeout=TIMEOUT)[0]
        assert jproc.returncode == 0, out[-3000:]
    finally:
        _wait(procs)
    restore = dict(name="elastic_restore", arch="qwen3-4b",
                   kind="elastic_restore", meshes=RESTORE_MESHES)
    np.savez(work / "elastic_restore_in.npz", none=np.zeros(1))
    _wait(_spawn(work, {"tag": "b", "mesh": [2, 1],
                        "axes": ["data", "model"], "cases": [restore]}, 2))
    return work, ref


def _out(work, name):
    return dict(np.load(work / f"{name}_out.npz"))


def _sub(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


@pytest.mark.parametrize("name", ["qwen_train", "mixtral_train",
                                  "jamba_train"])
def test_sharded_train_step_matches_the_reference(sharded, name):
    """On the (2, 2) mesh: ``value_and_grad``'s loss and metrics within
    1e-4, each gradient leaf within the single-device gate of its rms, every
    gradient a DTensor; one ``make_train_step`` (qwen3 with its gradients
    pinned to the parameters' placements): its metrics within 1e-4
    relative, and with AdamW the parameters as ``_check_step_params``
    argues, against the reference's single-device functions."""
    work, ref = sharded
    case = next(c for c in CASES if c["name"] == name)
    got, want = _out(work, name), ref[name]
    assert abs(float(got["loss"]) - want["loss"]) <= TOL
    for k in ("loss", "ce", "aux"):
        assert abs(float(got[f"m.{k}"]) - want["m"][k]) <= TOL, k
    _within(_sub(got, "g."), want["g"], GRAD_HOLDS[case["arch"]][1], _rms)
    assert all(str(v).startswith("(") and len(str(v)) > 2
               for v in _sub(got, "gspec.").values())  # DTensors
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[f"sm.{k}"]), want["sm"][k],
                                   rtol=TOL)
    assert int(got["count"]) == 1
    cfg, _ = _cfgs(case)
    if cfg.optimizer == "adamw":
        _check_step_params(_sub(got, "p."), want["p"], want["w"], want["g"],
                           want["sm"]["grad_norm"])


@pytest.mark.parametrize("name", ["qwen_serve", "mixtral_serve",
                                  "rwkv_serve"])
def test_sharded_prefill_and_decode_match_the_reference(sharded, name):
    """On the (2, 2) mesh: the prefill's last logits and two decode
    steps' logits within 1e-4 of the reference's rms, every cache leaf
    (placed by ``cache_shape_tree``'s specs, each local shape its
    ``local_shape``) within 1e-4 of its rms and ``pos`` exact."""
    work, ref = sharded
    got, want = _out(work, name), ref[name]
    assert bool(got["local_shapes_ok"])
    for k in ["prefill"] + [f"decode{i}" for i in range(STEPS)]:
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= TOL * _rms(want[k]), (k, err)
    for i in range(STEPS):  # the next tokens of rank 0's rows (data 0)
        rows = got[f"tok{i}"].shape[0]
        np.testing.assert_array_equal(
            got[f"tok{i}"], np.argmax(want[f"decode{i}"][:rows], axis=-1))
    caches = _sub(want, "c.")
    assert int(_sub(got, "c.")["pos"]) == int(caches.pop("pos")) \
        == PROMPT + STEPS
    got_c = _sub(got, "c.")
    got_c.pop("pos")
    _within(got_c, caches, TOL, _rms)


def test_census_counts_dtensor_collectives_as_comm_debug_mode(sharded):
    """One prefill step on DTensors: the op census's collective counts by
    kind equal ``CommDebugMode``'s, and it sees some of each kind the
    propagation issues."""
    work, _ = sharded
    got = _out(work, "census")
    census = json.loads(str(got["census"]))
    debug = json.loads(str(got["debug"]))
    assert census == debug and sum(census.values()) > 0


def test_hierarchical_pod_psum_matches_the_reference(sharded):
    """Four gloo ranks as (pod 2, data 2) against the reference under
    ``compat.shard_map`` on four XLA host devices: every rank's result,
    compressed and not, equal bits."""
    work, _ = sharded
    got = _out(work, "psum")
    want = dict(np.load(work / "psum_ref.npz"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the compressed sum is not the plain one: the int8 rounding shows
    assert any(not np.array_equal(got[f"1.{k}"], got[f"0.{k}"])
               for k in ("r0.w", "r0.b"))


def test_elastic_restore_onto_other_meshes_is_bit_equal(sharded):
    """A checkpoint saved from the (2, 2) mesh (one AdamW step) restores
    at (2, 1) and (1, 2) with every leaf's whole tensor equal bits, the
    parameters and moments as DTensors placed by the rules at the new
    mesh, ``count`` whole; the extra state too."""
    work, _ = sharded
    saved = _sub(_out(work, "elastic_save"), "t.")
    got = _out(work, "elastic_restore")
    for shape in RESTORE_MESHES:
        tag = "x".join(map(str, shape))
        leaves = {k: v for k, v in _sub(got, f"{tag}.").items()
                  if not k.startswith(("spec.", "extra"))}
        assert leaves.keys() == saved.keys()
        for k in saved:
            np.testing.assert_array_equal(leaves[k], saved[k], err_msg=k)
        specs = _sub(got, f"{tag}.spec.")
        assert "Shard" in str(specs["params.blocks.p0.mlp.w_gate"])
        assert str(specs["opt_state.count"]) == "()"
        assert json.loads(str(got[f"{tag}.extra"])) == {
            "data_state": {"step": 1}}
