"""Every LM family the other mixers unlock, whole, against the JAX
package's transformer on the CPU: rwkv6-1.6b (RWKV6), mixtral-8x7b and
grok-1-314b (MoE), jamba-1.5-large-398b (Mamba + attention + MoE),
whisper-tiny (the encoder and cross-attention) and llama-3.2-vision-90b
(cross-attention onto image patches), at their SMOKE sizes.

The reference's weights (its ``init_params`` in bfloat16, key 0) carry
across as numpy arrays (``params_from_numpy``); tokens and the external
embeddings (audio frames, image patches) come from a numpy seed.  For
each arch, in float32 and bfloat16: ``forward`` in train mode, prefill on
16 tokens (the last logits and the whole cache tree: K/V, cross K/V,
``ssm``/``conv``, ``wkv``/``tm_x``/``cm_x``) and a decode chain of 16
steps.  MoE archs run at the reference test's ``capacity_factor`` 32, so
that the full sequence drops no entry that a decode step keeps.  Then a
mixtral decode chain that wraps its 32-slot window, whisper's encoder,
llama-vision's cached cross K/V and every SMOKE config in all three
modes.

Tolerances.  float32: rtol = atol = 1e-4, or, where the reference's own
float32 rounding is larger than that, no farther from the reference than
the reference's float32 run is from its float64 run on the same weights
and inputs (its train forward under ``jax.enable_x64``; the prefill's
last logits and the decode chain equal the train logits at their
positions in exact arithmetic).  The SMOKE weights are drawn with the
reference's stacked ``fan_in`` (``n_blocks``), so jamba's 8-layer block
(``n_blocks`` 1) has unit-variance weights and whisper's attention
scores reach the hundreds: the two packages then differ by some 4e-4 on
logits near 2, and each differs as much from float64.  Cache leaves: at
rtol = 1e-4 and atol = 1e-4 of the leaf's rms (the recurrent states
reach 1e4, so an absolute 1e-4 is below their rounding).  bfloat16: within the reference's own bf16 error,
``max |port_bf16 - jax_bf16| <= max |jax_bf16 - jax_f32|`` (as
``tests/test_torch_transformer.py``)."""
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
from repro_torch.models import transformer as T

ARCHS = ["rwkv6-1.6b", "mixtral-8x7b", "grok-1-314b",
         "jamba-1.5-large-398b", "whisper-tiny", "llama-3.2-vision-90b"]
B, S, SPLIT = 2, 32, 16
F32 = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch, dtype, **kw):
    if registry.get_smoke_config(arch).n_experts:
        kw.setdefault("capacity_factor", 32.0)
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


def _inputs(arch, s=S, seed=0):
    """Tokens (B, s) and the external embeddings (B, L, D) or ``None``."""
    cfg = registry.get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    n = cfg.enc_len if cfg.is_encoder_decoder else cfg.img_tokens
    ext = (rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
           if n else None)
    return toks, ext


def _jax_run(jcfg, weights, toks, ext, *, split=SPLIT, cache_len=S):
    p = jax.tree.map(lambda a: jnp.asarray(a, jcfg.dtype), weights)
    e = None if ext is None else jnp.asarray(ext, jcfg.dtype)
    train = jax.jit(lambda p, t, e: JT.forward(jcfg, p, t, ext_embed=e)[::2])
    prefill = jax.jit(lambda p, t, e: JT.forward(
        jcfg, p, t, ext_embed=e, mode="prefill", cache_len=cache_len)[:2])
    decode = jax.jit(lambda p, c, t: JT.forward(jcfg, p, t, mode="decode",
                                                cache=c)[:2])
    last, cache = prefill(p, jnp.asarray(toks[:, :split]), e)
    pre = (np.asarray(last[:, -1], np.float32), jax.tree.map(_np, cache))
    chain = []
    for i in range(split, toks.shape[1]):
        lg, cache = decode(p, cache, jnp.asarray(toks[:, i:i + 1]))
        chain.append(np.asarray(lg[:, 0], np.float32))
    logits, aux = train(p, jnp.asarray(toks), e)
    return {"train": np.asarray(logits, np.float32), "prefill": pre,
            "chain": np.stack(chain, 1),
            "final_cache": jax.tree.map(_np, cache), "aux": float(aux)}


def _port_run(cfg, weights, toks, ext, *, split=SPLIT, cache_len=S):
    p = T.params_from_numpy(cfg, weights, device="cpu")
    tt = torch.from_numpy(toks)
    e = None if ext is None else torch.from_numpy(ext).to(cfg.dtype)
    with torch.no_grad():
        train, _, aux = T.forward(cfg, p, tt, ext_embed=e, mode="train")
        last, cache, _ = T.forward(cfg, p, tt[:, :split], ext_embed=e,
                                   mode="prefill", cache_len=cache_len)
        pre = (_np(last[:, -1]), T.tree_map(_np, cache))
        chain = []
        for i in range(split, toks.shape[1]):
            lg, cache, _ = T.forward(cfg, p, tt[:, i:i + 1], mode="decode",
                                     cache=cache)
            chain.append(_np(lg[:, 0]))
    return {"train": _np(train), "prefill": pre, "chain": np.stack(chain, 1),
            "final_cache": T.tree_map(_np, cache), "aux": float(aux)}


@functools.lru_cache(maxsize=None)
def _runs(arch, dtype):
    """The port's and the reference's runs of ``arch`` in ``dtype`` on the
    same weights and inputs."""
    cfg, jcfg = _cfgs(arch, dtype)
    toks, ext = _inputs(arch)
    return (_port_run(cfg, _weights(arch), toks, ext),
            _jax_run(jcfg, _weights(arch), toks, ext))


@functools.lru_cache(maxsize=None)
def _ref64(arch, mode, split=S):
    """The reference in float64 on the same weights and inputs: the train
    logits over ``split`` tokens, or the prefill cache of ``split``
    tokens (numpy float64 leaves by path)."""
    _, jcfg = _cfgs(arch, "float32")
    toks, ext = _inputs(arch)
    with jax.enable_x64(True):
        # unrolled: the scanned carry's float32 aux would meet a float64
        # router loss
        c64 = dataclasses.replace(jcfg, dtype=jnp.float64, scan_layers=False)
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                         _weights(arch))
        e = None if ext is None else jnp.asarray(ext, jnp.float64)
        t = jnp.asarray(toks[:, :split])
        if mode == "train":
            return np.asarray(jax.jit(lambda p, t, e: JT.forward(
                c64, p, t, ext_embed=e)[0])(p, t, e))
        cache = jax.jit(lambda p, t, e: JT.forward(
            c64, p, t, ext_embed=e, mode="prefill", cache_len=S)[1])(p, t, e)
        return _leaves(jax.tree.map(lambda a: np.asarray(a, np.float64),
                                    cache))


def _within(err, want, atol):
    return bool(np.all(err <= atol + F32["rtol"] * np.abs(want)))


def _f32_close(got, want, want64, what=""):
    """float32 against the reference: rtol = atol = 1e-4, or no farther
    than the reference's own float32 error against float64 (the module
    docstring); ``want64`` is called only when the first fails."""
    err = np.abs(got - want)
    if _within(err, want, F32["atol"]):
        return
    floor = np.abs(want - want64()).max()
    assert err.max() <= floor, (what, err.max(), floor)


def _leaf_close(got, want, want64, name):
    """A cache leaf: rtol = 1e-4 and atol = 1e-4 of the leaf's rms (the
    states reach 1e4-1e5 on these weights), or the float64 floor."""
    rms = float(np.sqrt(np.mean(np.square(want, dtype=np.float64))))
    err = np.abs(got - want)
    if _within(err, want, F32["atol"] * max(rms, 1.0)):
        return
    _f32_close(got, want, want64, name)


def _bf16_close(got, want, want_f32, floor=0.0):
    """bf16 within the reference's own bf16 error on the quantity, or on
    its train logits (``floor``) where that is larger."""
    err = np.abs(got - want).max()
    floor = max(floor, np.abs(want - want_f32).max())
    assert err <= floor, (err, floor)


def _bf16_floor(arch):
    """The reference's own bf16 error on its train logits."""
    return np.abs(_runs(arch, "bfloat16")[1]["train"]
                  - _runs(arch, "float32")[1]["train"]).max()


def _leaves(cache):
    return dict(T.tree_leaves(cache))


def _cache_names(cfg) -> set:
    return {"pos"} | {p for p, _ in T.tree_leaves(
        T.cache_specs(cfg, B, S), T._is_cache_leaf) if p != "pos"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_matches_jax(arch, dtype):
    got, want = _runs(arch, dtype)
    assert got["train"].shape == (B, S, registry.get_smoke_config(arch).vocab)
    assert np.isfinite(got["train"]).all()
    if dtype == "float32":
        _f32_close(got["train"], want["train"],
                   lambda: _ref64(arch, "train"))
        # the summed router loss (MoE archs; 0.0 for the others)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5)
        assert (got["aux"] > 0) == bool(_cfgs(arch, dtype)[0].n_experts)
    else:
        _bf16_close(got["train"], want["train"],
                    _runs(arch, "float32")[1]["train"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, dtype):
    """The last logits, and every leaf of the cache tree with its shape
    and dtype (the recurrent states in float32, the rest in the model's
    dtype)."""
    (last, cache), (jlast, jcache) = (r["prefill"]
                                      for r in _runs(arch, dtype))
    cfg, _ = _cfgs(arch, dtype)
    leaves, jleaves = _leaves(cache), _leaves(jcache)
    assert set(leaves) == set(jleaves) == _cache_names(cfg)
    assert int(leaves["pos"]) == int(jleaves["pos"]) == SPLIT
    specs = dict(T.tree_leaves(T.cache_specs(cfg, B, S), T._is_cache_leaf))
    p = T.params_from_numpy(cfg, _weights(arch), device="cpu")
    with torch.no_grad():
        _, tcache, _ = T.forward(
            cfg, p, torch.from_numpy(_inputs(arch)[0][:, :SPLIT]),
            ext_embed=(None if _inputs(arch)[1] is None else torch.from_numpy(
                _inputs(arch)[1]).to(cfg.dtype)),
            mode="prefill", cache_len=S)
    for name, t in T.tree_leaves(tcache):
        if name != "pos":
            assert (tuple(t.shape), t.dtype) == (specs[name][0],
                                                 specs[name][2]), name
    if dtype == "float32":
        _f32_close(last, jlast, lambda: _ref64(arch, "train")[:, SPLIT - 1])
        for name in leaves:
            _leaf_close(leaves[name], jleaves[name],
                        lambda: _ref64(arch, "prefill", SPLIT)[name], name)
    else:
        _bf16_close(last, jlast, _runs(arch, "float32")[1]["prefill"][0],
                    _bf16_floor(arch))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chain_matches_jax(arch, dtype):
    """16 decode steps from the prefilled cache; in float32 also every
    leaf of the final cache, each state written back into its block."""
    got, want = _runs(arch, dtype)
    assert got["chain"].shape == (B, S - SPLIT,
                                  registry.get_smoke_config(arch).vocab)
    if dtype == "float32":
        _f32_close(got["chain"], want["chain"],
                   lambda: _ref64(arch, "train")[:, SPLIT:])
        # the final cache equals, in exact arithmetic, the prefill cache of
        # all S tokens: that is its float64 floor
        fin, jfin = _leaves(got["final_cache"]), _leaves(want["final_cache"])
        assert set(fin) == set(jfin)
        for name, leaf in fin.items():
            _leaf_close(leaf, jfin[name],
                        lambda: _ref64(arch, "prefill", S)[name], name)
        assert int(fin["pos"]) == S
    else:
        _bf16_close(got["chain"], want["chain"],
                    _runs(arch, "float32")[1]["chain"], _bf16_floor(arch))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-1.5-large-398b"])
def test_moe_aux_loss_matches_jax_with_drops(arch):
    """The train forward's summed router loss at the configs' own
    capacity factor, 1.25, where the full sequence drops entries (at 32
    it is held by ``test_train_forward_matches_jax``), and mixtral's
    logits at 1e-4 (jamba's unit-variance SMOKE weights put its logits
    past an elementwise 1e-4 from any float32 run: they are held against
    the float64 floor at 32, and its routing with drops by
    ``test_torch_moe.py``)."""
    cfg, jcfg = _cfgs(arch, "float32", capacity_factor=1.25)
    toks, _ = _inputs(arch)
    p = T.params_from_numpy(cfg, _weights(arch), device="cpu")
    with torch.no_grad():
        logits, _, aux = T.forward(cfg, p, torch.from_numpy(toks))
    jlogits, _, jaux = jax.jit(lambda p, t: JT.forward(jcfg, p, t))(
        jax.tree.map(jnp.asarray, _weights(arch)), jnp.asarray(toks))
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert float(aux) > 0
    if arch == "mixtral-8x7b":
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **F32)


def test_mixtral_decode_wraps_its_window():
    """SMOKE mixtral's 32-slot sliding window: prefill 24 tokens, then 32
    decode steps, so the ring buffer wraps (positions 24..55), against
    the reference's decode chain and its windowed train forward."""
    arch = "mixtral-8x7b"
    cfg, jcfg = _cfgs(arch, "float32")
    assert cfg.window == 32
    toks, _ = _inputs(arch, s=56, seed=3)
    got = _port_run(cfg, _weights(arch), toks, None, split=24, cache_len=56)
    want = _jax_run(jcfg, _weights(arch), toks, None, split=24, cache_len=56)
    assert got["prefill"][1]["blocks"]["p0"]["k"].shape[2] == 32
    np.testing.assert_allclose(got["chain"], want["chain"], **F32)
    np.testing.assert_allclose(got["chain"], got["train"][:, 24:], **F32)
    for name, leaf in _leaves(got["final_cache"]).items():
        np.testing.assert_allclose(leaf, _leaves(want["final_cache"])[name],
                                   err_msg=name, **F32)


def test_whisper_encoder_matches_jax():
    arch = "whisper-tiny"
    cfg, jcfg = _cfgs(arch, "float32")
    _, ext = _inputs(arch)
    p = T.params_from_numpy(cfg, _weights(arch), device="cpu")
    with torch.no_grad():
        got = T._encoder(cfg, p, torch.from_numpy(ext))
    want = JT._encoder(jcfg, jax.tree.map(jnp.asarray, _weights(arch)),
                       jnp.asarray(ext))
    assert got.shape == (B, cfg.enc_len, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_llama_vision_caches_its_cross_kv():
    """The prefill cache's cross K/V are the patches' projections (no
    rope, no norm: the reference's ``qkv_project`` with ``kv_x``); decode
    steps read them and leave them as they were."""
    arch = "llama-3.2-vision-90b"
    cfg, _ = _cfgs(arch, "float32")
    toks, ext = _inputs(arch)
    p = T.params_from_numpy(cfg, _weights(arch), device="cpu")
    e = torch.from_numpy(ext)
    with torch.no_grad():
        _, cache, _ = T.forward(cfg, p, torch.from_numpy(toks[:, :SPLIT]),
                                ext_embed=e, mode="prefill", cache_len=S)
        ck, cv = (cache["blocks"]["p4"][n].clone() for n in ("ck", "cv"))
        cross = p["blocks"]["p4"]["cross"]
        for blk in range(cfg.n_blocks):
            torch.testing.assert_close(
                ck[blk], torch.einsum("bsd,dhk->bshk", e, cross["wk"][blk]))
            torch.testing.assert_close(
                cv[blk], torch.einsum("bsd,dhk->bshk", e, cross["wv"][blk]))
        assert set(cache["blocks"]["p4"]) == {"ck", "cv"}
        for i in range(SPLIT, SPLIT + 4):
            _, cache, _ = T.forward(cfg, p, torch.from_numpy(
                toks[:, i:i + 1]), mode="decode", cache=cache)
    assert torch.equal(cache["blocks"]["p4"]["ck"], ck)
    assert torch.equal(cache["blocks"]["p4"]["cv"], cv)
    want = _runs(arch, "float32")[1]["prefill"][1]["blocks"]["p4"]
    np.testing.assert_allclose(ck.numpy(), want["ck"], **F32)
    np.testing.assert_allclose(cv.numpy(), want["cv"], **F32)


@pytest.mark.parametrize("arch", rregistry.all_arch_ids())
def test_every_smoke_config_runs_all_three_modes(arch):
    """Every LM config's SMOKE variant, in its own dtype and capacity:
    train, prefill and 3 decode steps, finite, the aux loss a float32
    scalar (positive for an MoE arch), the cache's pos counting."""
    cfg = registry.get_smoke_config(arch)
    p = T.init_params(cfg, 0, device="cpu")
    toks, ext = _inputs(arch, s=16, seed=5)
    tt = torch.from_numpy(toks)
    e = None if ext is None else torch.from_numpy(ext).to(cfg.dtype)
    with torch.no_grad():
        logits, _, aux = T.forward(cfg, p, tt, ext_embed=e)
        assert logits.shape == (B, 16, cfg.vocab)
        assert torch.isfinite(logits).all()
        assert aux.dtype == torch.float32 and aux.shape == ()
        assert (float(aux) > 0) == bool(cfg.n_experts)
        last, cache, _ = T.forward(cfg, p, tt[:, :8], ext_embed=e,
                                   mode="prefill", cache_len=16)
        for i in range(8, 11):
            lg, cache, _ = T.forward(cfg, p, tt[:, i:i + 1], mode="decode",
                                     cache=cache)
            assert torch.isfinite(lg).all()
    assert int(cache["pos"]) == 11
