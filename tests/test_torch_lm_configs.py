"""The port's ten language-model configs (``repro_torch.configs``) and the
spec trees built from them, against the JAX package's, on the CPU.

Tolerance: exact equality — of every field (``dtype`` compared by name),
of ``param_count()`` and ``active_param_count()``, of the parameter spec
tree (shapes, logical axes, init, scale) and its element count for every
arch whose specs the port builds, and of the cache spec tree for every
arch."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.configs.base import ModelConfig as JConfig
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

LM_ARCHS = rregistry.all_arch_ids()
#: the archs whose blocks need a module of ROADMAP Queue 1 item 3 for
#: their specs (MoE, Mamba, RWKV)
ITEM3_SPECS = {"mixtral-8x7b", "grok-1-314b", "jamba-1.5-large-398b",
               "rwkv6-1.6b"}
SPEC_ARCHS = [a for a in LM_ARCHS if a not in ITEM3_SPECS]


def _dtype_name(dt) -> str:
    return (str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype)
            else np.dtype(dt).name)


def _fields(cfg) -> dict:
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["dtype"] = _dtype_name(out["dtype"])
    return out


def _configs(arch):
    return [(registry.get_config(arch), rregistry.get_config(arch)),
            (registry.get_smoke_config(arch),
             rregistry.get_smoke_config(arch))]


def test_schema_matches_the_reference():
    mine, ref = dataclasses.fields(ModelConfig), dataclasses.fields(JConfig)
    assert [f.name for f in mine] == [f.name for f in ref]
    for a, b in zip(mine, ref):
        if a.name == "dtype":
            assert _dtype_name(a.default) == _dtype_name(b.default)
        else:
            assert a.default == b.default, a.name
    assert ModelConfig.__dataclass_params__.frozen


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_equal_the_reference(arch):
    for mine, ref in _configs(arch):
        assert _fields(mine) == _fields(ref)
        assert (mine.n_blocks, mine.d_inner, mine.attn_out_dim) == \
            (ref.n_blocks, ref.d_inner, ref.attn_out_dim)
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()
    assert registry.get_config(arch).dtype is torch.bfloat16


def test_config_checks_its_pattern():
    with pytest.raises(AssertionError):
        ModelConfig(name="x", family="dense", n_layers=3, d_model=8,
                    n_heads=1, n_kv_heads=1, d_head=8, d_ff=8, vocab=8,
                    block_pattern=("attn+mlp", "attn+mlp"))


def _spec_tree(specs, is_leaf):
    return {p: (tuple(s.shape), tuple(s.logical), s.init, float(s.scale))
            for p, s in T.tree_leaves(specs, is_leaf)}


def _ref_spec_tree(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JL.PSpec))[0]
    return {".".join(k.key for k in path):
            (tuple(s.shape), tuple(s.logical), s.init, float(s.scale))
            for path, s in leaves}


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_param_specs_equal_the_reference(arch):
    for mine, ref in _configs(arch):
        got = _spec_tree(T.param_specs(mine), lambda x: isinstance(x, L.PSpec))
        want = _ref_spec_tree(JT.param_specs(ref))
        assert got == want
        assert sum(int(np.prod(s[0])) for s in got.values()) == \
            sum(int(np.prod(s[0])) for s in want.values())


def test_qwen3_4b_has_the_stated_size():
    cfg = registry.get_config("qwen3-4b")
    n = sum(int(np.prod(s.shape)) for _, s in T.tree_leaves(
        T.param_specs(cfg), lambda x: isinstance(x, L.PSpec)))
    assert n == 4_022_468_096
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab, cfg.qk_norm, cfg.rope_theta) == \
        (36, 2560, 32, 8, 128, 9728, 151936, True, 1e6)


@pytest.mark.parametrize("arch", sorted(ITEM3_SPECS))
def test_item3_specs_raise(arch):
    for get in (registry.get_config, registry.get_smoke_config):
        with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
            T.param_specs(get(arch))
        with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
            T.init_params(get(arch), 0, device="cpu")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_specs_equal_the_reference(arch):
    for mine, ref in _configs(arch):
        for kw in ({}, {"shard_cache_seq": True}):
            got = T.cache_specs(mine, 3, 40, **kw)
            want = JT.cache_specs(ref, 3, 40, **kw)
            flat = T.tree_leaves(got, T._is_cache_leaf)
            rflat = {".".join(k.key for k in p): s for p, s in
                     jax.tree_util.tree_flatten_with_path(
                         want, is_leaf=JT._is_cache_leaf)[0]}
            assert {p: (s[0], s[1], _dtype_name(s[2])) for p, s in flat} \
                == {p: (tuple(s[0]), tuple(s[1]), _dtype_name(s[2]))
                    for p, s in rflat.items()}


@pytest.mark.parametrize("arch", ["qwen3-4b", "mixtral-8x7b"])
def test_cache_zeros_match_the_specs(arch):
    cfg = registry.get_smoke_config(arch)
    cache = T.cache_zeros(cfg, 2, 48, device="cpu")
    specs = dict(T.tree_leaves(T.cache_specs(cfg, 2, 48), T._is_cache_leaf))
    for path, t in T.tree_leaves(cache):
        shape, _, dtype = specs[path]
        assert tuple(t.shape) == shape and t.dtype == dtype, path
        assert not t.any(), path
