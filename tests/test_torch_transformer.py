"""The port's dense transformer (``repro_torch.models.transformer``)
against the JAX package's (``repro.models.transformer``) on the CPU.

The reference's weights (``init_params`` with its key) carry across as
numpy arrays (``params_from_numpy``); tokens come from a numpy seed.  For
the SMOKE configs of qwen3-4b, qwen1.5-4b and qwen2.5-14b, in float32 and
in bfloat16: ``forward`` in train mode, prefill (the last logits and the
whole cache tree, ``pos`` included) and a decode chain of 16 steps from a
16-token prefix; then the flash branch (``attn_chunk=8`` at S = 32), the
sliding-window ring buffer (``window=8``), decode at ``pos == cache_len``
(the clamp), the port's own prefill/train and decode/teacher-forcing
properties, init, the module and the families that wait for item 3.

Tolerances.  float32: rtol = atol = 1e-4.  bfloat16, against the
reference: the reference's OWN bf16 error on the same weights and inputs,
``max |port_bf16 - jax_bf16| <= max |jax_bf16 - jax_f32|``.  The
reference's elementwise 2e-2 does not hold across two implementations
of bf16 (XLA's and ATen's elementwise kernels round differently): for
qwen3-4b one logit in 16,384 misses it (0.022 against 0.021) and the
cache's rope cancels large terms into small ones; without qk-norm
(qwen1.5-4b, qwen2.5-14b) the scores of these random weights reach the
hundreds, so a one-ulp difference in an early layer moves a near one-hot
softmax.  The port's bf16 path within itself (prefill against the train
tail, decode against teacher forcing) keeps the reference's 2e-2 and
5e-2."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import transformer as JT
from repro_torch.configs import registry
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCHS = ["qwen3-4b", "qwen1.5-4b", "qwen2.5-14b"]
B, S, SPLIT = 2, 32, 16
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
BF16_CHAIN = dict(rtol=5e-2, atol=5e-2)


def _cfgs(arch, dtype, **kw):
    return (dataclasses.replace(registry.get_smoke_config(arch),
                                dtype=getattr(torch, dtype), **kw),
            dataclasses.replace(rregistry.get_smoke_config(arch),
                                dtype=getattr(jnp, dtype), **kw))


def _np(x) -> np.ndarray:
    """A float32 numpy COPY (a decode step writes its cache in place)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's bf16 init of ``arch``'s SMOKE config, as numpy."""
    _, jcfg = _cfgs(arch, "bfloat16")
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        JT.init_params(jcfg, jax.random.PRNGKey(0)))


def _tokens(vocab, shape=(B, S), seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _jax_run(jcfg, weights, toks, *, steps=S - SPLIT, split=SPLIT,
             cache_len=S):
    """Train logits, prefill (last logits, cache) and a decode chain in
    the reference, each mode under ``jax.jit``."""
    p = jax.tree.map(lambda a: jnp.asarray(a, jcfg.dtype), weights)
    train = jax.jit(lambda p, t: JT.forward(jcfg, p, t, mode="train")[0])
    prefill = jax.jit(lambda p, t: JT.forward(
        jcfg, p, t, mode="prefill", cache_len=cache_len)[:2])
    decode = jax.jit(lambda p, c, t: JT.forward(jcfg, p, t, mode="decode",
                                                cache=c)[:2])
    last, cache = prefill(p, jnp.asarray(toks[:, :split]))
    pre = (np.asarray(last[:, -1]), jax.tree.map(_np, cache))
    chain = []
    for i in range(split, split + steps):
        lg, cache = decode(p, cache, jnp.asarray(toks[:, i:i + 1]))
        chain.append(np.asarray(lg[:, 0]))
    return {"train": np.asarray(train(p, jnp.asarray(toks))),
            "prefill": pre, "chain": np.stack(chain, 1),
            "final_cache": jax.tree.map(_np, cache)}


def _port_run(cfg, weights, toks, *, steps=S - SPLIT, split=SPLIT,
              cache_len=S):
    p = T.params_from_numpy(cfg, weights, device="cpu")
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        train = T.forward(cfg, p, tt, mode="train")[0]
        last, cache, _ = T.forward(cfg, p, tt[:, :split], mode="prefill",
                                   cache_len=cache_len)
        pre = (_np(last[:, -1]), T.tree_map(_np, cache))
        chain = []
        for i in range(split, split + steps):
            lg, cache, _ = T.forward(cfg, p, tt[:, i:i + 1], mode="decode",
                                     cache=cache)
            chain.append(_np(lg[:, 0]))
    return {"train": _np(train), "prefill": pre, "chain": np.stack(chain, 1),
            "final_cache": T.tree_map(_np, cache)}


@functools.lru_cache(maxsize=None)
def _runs(arch):
    """Every run of ``arch``: the reference's and the port's, in float32
    and bfloat16, on the same weights and tokens."""
    w = _weights(arch)
    toks = _tokens(registry.get_smoke_config(arch).vocab)
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg, jcfg = _cfgs(arch, dt)
        out[dt] = (_port_run(cfg, w, toks), _jax_run(jcfg, w, toks))
    return out


def _cache_leaves(cache):
    return dict(T.tree_leaves(cache))


def _bf16_close(got, want, want_f32):
    """bf16: no farther from the reference than the reference's own bf16
    run is from its float32 run (the module docstring)."""
    err = np.abs(got - want).max()
    floor = np.abs(want - want_f32).max()
    assert err <= floor, (err, floor)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_matches_jax(arch, dtype):
    got, want = _runs(arch)[dtype]
    assert got["train"].shape == (B, S, registry.get_smoke_config(arch).vocab)
    if dtype == "float32":
        np.testing.assert_allclose(got["train"], want["train"], **F32)
    else:
        _bf16_close(got["train"], want["train"],
                    _runs(arch)["float32"][1]["train"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, dtype):
    (last, cache), (jlast, jcache) = (r["prefill"]
                                      for r in _runs(arch)[dtype])
    f32 = _runs(arch)["float32"][1]["prefill"]
    leaves, jleaves = _cache_leaves(cache), _cache_leaves(jcache)
    assert set(leaves) == set(jleaves) == {"pos", "blocks.p0.k",
                                           "blocks.p0.v"}
    assert int(leaves["pos"]) == int(jleaves["pos"]) == SPLIT
    for name in ("blocks.p0.k", "blocks.p0.v"):
        assert leaves[name].shape == jleaves[name].shape == (
            2, B, S, 2 if arch != "qwen1.5-4b" else 4, 16)
    pairs = [(last, jlast, f32[0])] + [
        (leaves[n], jleaves[n], _cache_leaves(f32[1])[n])
        for n in ("blocks.p0.k", "blocks.p0.v")]
    for got, want, want_f32 in pairs:
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **F32)
        else:
            _bf16_close(got, want, want_f32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chain_matches_jax(arch, dtype):
    got, want = _runs(arch)[dtype]
    assert got["chain"].shape == (B, S - SPLIT,
                                  registry.get_smoke_config(arch).vocab)
    if dtype == "float32":
        np.testing.assert_allclose(got["chain"], want["chain"], **F32)
        for n, leaf in _cache_leaves(got["final_cache"]).items():
            np.testing.assert_allclose(
                leaf, _cache_leaves(want["final_cache"])[n], **F32)
    else:
        _bf16_close(got["chain"], want["chain"],
                    _runs(arch)["float32"][1]["chain"])


def test_cache_pos_is_a_device_int32_scalar():
    cfg, _ = _cfgs("qwen3-4b", "float32")
    p = T.params_from_numpy(cfg, _weights("qwen3-4b"), device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab))
    _, cache, aux = T.forward(cfg, p, toks, mode="prefill")
    assert cache["pos"].shape == () and cache["pos"].dtype == torch.int32
    assert aux.shape == () and aux.dtype == torch.float32 and aux == 0
    _, cache2, _ = T.forward(cfg, p, toks[:, :1], mode="decode", cache=cache)
    assert cache2["pos"].dtype == torch.int32 and int(cache2["pos"]) == S + 1


# ---------------------------------------------------------------------------
# the flash branch, the ring buffer, the clamp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["flash", "window"])
def test_variant_matches_jax(variant):
    """``attn_chunk=8``: every sequence forward here (S = 32, prefix 16)
    takes the flash branch.  ``window=8``: the prefill cache is a ring
    buffer of 8 slots and decode rotates through it."""
    kw = {"flash": dict(attn_chunk=8), "window": dict(window=8)}[variant]
    cfg, jcfg = _cfgs("qwen3-4b", "float32", **kw)
    w = _weights("qwen3-4b")
    toks = _tokens(cfg.vocab, seed=1)
    calls = []
    flash = L.flash_attention

    def counted(*a, **k):
        calls.append(a[0].shape[1])
        return flash(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "flash_attention", counted)
        got = _port_run(cfg, w, toks)
    want = _jax_run(jcfg, w, toks)
    if variant == "flash":
        assert sorted(set(calls)) == [SPLIT, S]
    else:
        assert calls == []
        assert _cache_leaves(got["prefill"][1])["blocks.p0.k"].shape[2] == 8
    np.testing.assert_allclose(got["train"], want["train"], **F32)
    np.testing.assert_allclose(got["prefill"][0], want["prefill"][0], **F32)
    for n, leaf in _cache_leaves(got["prefill"][1]).items():
        np.testing.assert_allclose(
            leaf, _cache_leaves(want["prefill"][1])[n], **F32)
    np.testing.assert_allclose(got["chain"], want["chain"], **F32)
    for n, leaf in _cache_leaves(got["final_cache"]).items():
        np.testing.assert_allclose(
            leaf, _cache_leaves(want["final_cache"])[n], **F32)


@pytest.mark.parametrize("window", [None, 8])
def test_decode_past_the_cache_clamps_like_jax(window):
    """A cache sized to the prompt (``cache_len == S``): decoding at
    ``pos == cache_len`` writes the last slot (``dynamic_update_slice``
    clamps its start), with ``window`` the ring wraps instead."""
    cfg, jcfg = _cfgs("qwen3-4b", "float32", window=window)
    w = _weights("qwen3-4b")
    toks = _tokens(cfg.vocab, (B, SPLIT + 3), seed=2)
    got = _port_run(cfg, w, toks, steps=3, cache_len=SPLIT)
    want = _jax_run(jcfg, w, toks, steps=3, cache_len=SPLIT)
    np.testing.assert_allclose(got["chain"], want["chain"], **F32)
    leaves = _cache_leaves(got["final_cache"])
    for n, leaf in leaves.items():
        np.testing.assert_allclose(
            leaf, _cache_leaves(want["final_cache"])[n], **F32)
    assert int(leaves["pos"]) == SPLIT + 3
    if window is None:
        # three tokens past the end all landed in the last slot: the slots
        # before it still hold the prefill's keys
        pre = _cache_leaves(got["prefill"][1])["blocks.p0.k"]
        k = leaves["blocks.p0.k"]
        np.testing.assert_array_equal(k[:, :, :SPLIT - 1],
                                      pre[:, :, :SPLIT - 1])
        assert not np.array_equal(k[:, :, SPLIT - 1], pre[:, :, SPLIT - 1])


def test_decode_slot_arithmetic_is_floor_mod():
    """The window's slot bookkeeping on positions below the ring's size
    and past it, against the reference's formulas in numpy (floor-mod)."""
    cfg, _ = _cfgs("qwen3-4b", "float32", window=8)
    p = T.tree_map(lambda a: a[0], T.params_from_numpy(
        cfg, _weights("qwen3-4b"), device="cpu")["blocks"])["p0"]["attn"]
    x1 = torch.randn(1, 1, cfg.d_model, generator=torch.Generator()
                     .manual_seed(0))
    for pos in (0, 3, 7, 8, 13, 21):
        kc = torch.zeros(1, 8, cfg.n_kv_heads, cfg.d_head)
        vc = torch.zeros_like(kc)
        T._attn_decode(cfg, p, x1, kc, vc, torch.tensor(pos, dtype=torch.int32))
        written = np.flatnonzero(kc.abs().sum((0, 2, 3)).numpy())
        assert written.tolist() == [pos % 8], pos


# ---------------------------------------------------------------------------
# properties of the port alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_train_tail(arch):
    cfg, _ = _cfgs(arch, "bfloat16")
    p = T.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab, seed=3))
    with torch.no_grad():
        last, cache, _ = T.forward(cfg, p, toks, mode="prefill")
        full, _, _ = T.forward(cfg, p, toks, mode="train")
    np.testing.assert_allclose(_np(last[:, -1]), _np(full[:, -1]), **BF16)
    assert int(cache["pos"]) == S


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chain_matches_teacher_forcing(arch):
    cfg, _ = _cfgs(arch, "bfloat16")
    p = T.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab, seed=4))
    with torch.no_grad():
        full, _, _ = T.forward(cfg, p, toks, mode="train")
        _, cache, _ = T.forward(cfg, p, toks[:, :SPLIT], mode="prefill",
                                cache_len=S)
        for i in range(SPLIT, S):
            lg, cache, _ = T.forward(cfg, p, toks[:, i:i + 1], mode="decode",
                                     cache=cache)
            np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, i]),
                                       **BF16_CHAIN)


def test_scan_vs_unrolled_identical():
    cfg, _ = _cfgs("qwen3-4b", "float32")
    p = T.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab))
    a = T.forward(cfg, p, toks)[0]
    b = T.forward(dataclasses.replace(cfg, scan_layers=False), p, toks)[0]
    assert torch.equal(a, b)


def test_remat_gives_the_same_grads():
    """Train mode under grad: ``remat`` checkpoints each block, and the
    gradients equal those of the forward without it."""
    cfg, _ = _cfgs("qwen3-4b", "float32")
    toks = torch.from_numpy(_tokens(cfg.vocab))
    grads = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        model = T.TransformerLM(c, T.init_params(c, 0, device="cpu"))
        logits, _, _ = model(toks)
        (logits ** 2).mean().backward()
        grads.append({n: q.grad.clone() for n, q in model.named_parameters()})
    for n, g in grads[0].items():
        torch.testing.assert_close(g, grads[1][n], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# init, the weights' carry-over, the module
# ---------------------------------------------------------------------------

def _specs(cfg):
    return dict(T.tree_leaves(T.param_specs(cfg),
                              lambda x: isinstance(x, L.PSpec)))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_follows_the_reference_rule(arch):
    """Every leaf has its spec's shape and dtype; zeros and ones are
    exact; a normal leaf's std is within 5 % of ``scale / sqrt(fan_in)``
    with ``fan_in`` the STACKED spec's first dim (n_blocks for a block
    weight), which is also what the reference's own init draws."""
    cfg = registry.get_smoke_config(arch)
    specs = _specs(cfg)
    p = dict(T.tree_leaves(T.init_params(cfg, 0, device="cpu")))
    jp = dict(T.tree_leaves(_weights(arch)))
    assert set(p) == set(specs) == set(jp)
    for path, spec in specs.items():
        t = p[path]
        assert tuple(t.shape) == spec.shape and t.dtype == torch.bfloat16
        if spec.init == "zeros":
            assert not t.any(), path
        elif spec.init == "ones":
            assert torch.equal(t, torch.ones_like(t)), path
        else:
            rule = spec.scale / np.sqrt(spec.shape[0])
            assert float(L.init_std(spec)) == pytest.approx(rule)
            assert abs(t.float().std().item() / rule - 1) < 0.05, path
            assert abs(jp[path].std() / rule - 1) < 0.05, path
            assert abs(t.float().mean().item()) < 0.05 * rule, path
    assert p["blocks.p0.attn.wq"].float().std().item() == \
        pytest.approx(1 / np.sqrt(2), rel=0.05)


def test_init_is_deterministic_for_a_seed():
    cfg = registry.get_smoke_config("qwen3-4b")
    a, b, c = (dict(T.tree_leaves(T.init_params(cfg, s, device="cpu")))
               for s in (0, 0, 1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])


def test_tree_walks_keep_no_leaf_alive():
    """A tree's leaves die with the tree, with no garbage collection: a
    walk that left a reference cycle held a full-width model's 8 GB on
    the card after it was dropped."""
    import gc
    import weakref

    cfg = registry.get_smoke_config("qwen3-4b")
    gc.disable()
    try:
        p = T.init_params(cfg, 0, device="cpu")
        ref = weakref.ref(p["embed"])
        T.tree_leaves(p)
        T.param_count(T.tree_map(lambda a: a, p))
        del p
        assert ref() is None
    finally:
        gc.enable()


def test_params_from_numpy_is_exact():
    cfg = registry.get_smoke_config("qwen3-4b")
    jp = JT.init_params(rregistry.get_smoke_config("qwen3-4b"),
                        jax.random.PRNGKey(1))
    p = dict(T.tree_leaves(T.params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), device="cpu")))
    for path, leaf in T.tree_leaves(jax.tree.map(np.asarray, jp)):
        assert p[path].dtype == torch.bfloat16
        np.testing.assert_array_equal(p[path].float().numpy(),
                                      leaf.astype(np.float32))


def test_module_owns_the_tree_under_the_reference_paths():
    cfg, _ = _cfgs("qwen2.5-14b", "float32")
    w = _weights("qwen2.5-14b")
    model = T.TransformerLM(cfg, T.params_from_numpy(cfg, w, device="cpu"))
    assert set(model.state_dict()) == {p for p, _ in T.tree_leaves(w)}
    assert "blocks.p0.attn.bq" in model.state_dict()
    toks = torch.from_numpy(_tokens(cfg.vocab))
    with torch.no_grad():
        got = model(toks)[0]
        want = T.forward(cfg, T.params_from_numpy(cfg, w, device="cpu"),
                         toks)[0]
    assert torch.equal(got, want)
    assert T.param_count(model.tree()) == sum(
        int(np.prod(s.shape)) for s in _specs(cfg).values())


# ---------------------------------------------------------------------------
# what waits for ROADMAP Queue 1 item 3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-tiny"])
def test_cross_and_encoder_layers_raise(arch):
    """Their specs are ported (and equal the reference's); running them
    is not."""
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype=torch.float32)
    p = T.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab, (1, 8)))
    ext = torch.zeros(1, cfg.img_tokens or cfg.enc_len, cfg.d_model)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        T.forward(cfg, p, toks, ext_embed=ext)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        T.require_ported(cfg)
