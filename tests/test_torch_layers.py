"""The port's transformer layers (``repro_torch.models.layers``) against
the JAX package's (``repro.models.layers``) on the same numpy inputs, on
the CPU: norms, RoPE, the QKV projection, naive / blockwise-flash /
decode attention, the flash backward and the MLP.

Tolerances: float32 at rtol = atol = 1e-5 (the attention grads at 1e-4,
the reference's own flash-vs-naive grad bound being 2e-4); bfloat16 at
the reference's 2e-2.  The flash forward is held against the reference's
flash and its naive attention; the flash backward against ``jax.grad``
of the reference's flash (its explicit ``custom_vjp`` backward) and
against autograd through the port's naive attention."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.models import layers as JL
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def _close(got, want, tol):
    if isinstance(want, torch.Tensor):
        want = want.detach().float().numpy()
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _qkv(rng, b, s, h, kv, d, sk=None):
    sk = s if sk is None else sk
    return (rng.standard_normal((b, s, h, d)),
            rng.standard_normal((b, sk, kv, d)),
            rng.standard_normal((b, sk, kv, d)))


def _both(fn_t, fn_j, arrays, dtype="float32", **kw):
    """``fn`` of each package on the same arrays, in ``dtype``."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    return (fn_t(*[_t(a, tdt) for a in arrays], **kw),
            fn_j(*[_j(a, jdt) for a in arrays], **kw))


# ---------------------------------------------------------------------------
# norms, rope, projections
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = 3.0 * rng.standard_normal((2, 5, 64))
    w = 1.0 + 0.1 * rng.standard_normal(64)
    got, want = _both(L.rms_norm, JL.rms_norm, (x, w), dtype)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, F32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(dtype, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16))
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    got = L.rope(_t(x, getattr(torch, dtype)), torch.from_numpy(pos), theta)
    want = JL.rope(_j(x, getattr(jnp, dtype)), jnp.asarray(pos), theta)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, F32 if dtype == "float32" else BF16)


def _cfgs(**kw):
    base = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, d_head=8, d_ff=64, vocab=64)
    return (ModelConfig(**base, **kw, dtype=torch.float32),
            JConfig(**base, **kw, dtype=jnp.float32))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_qkv_project_matches_jax(bias, qk_norm):
    cfg, jcfg = _cfgs(qkv_bias=bias, qk_norm=qk_norm)
    rng = np.random.default_rng(2)
    specs = L.attn_specs(cfg)
    assert specs == JL.attn_specs(jcfg)
    p = {k: (rng.standard_normal(s.shape) if s.init == "normal"
             else 1.0 + 0.1 * rng.standard_normal(s.shape))
         for k, s in specs.items()}
    x = rng.standard_normal((2, 6, 32))
    got = L.qkv_project(cfg, {k: _t(v) for k, v in p.items()}, _t(x))
    want = JL.qkv_project(jcfg, {k: _j(v) for k, v in p.items()}, _j(x))
    for g, w in zip(got, want):
        _close(g, w, F32)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(causal=True), dict(causal=True, window=5), dict(causal=False),
    dict(causal=True, q_offset=16), dict(causal=True, window=4, q_offset=16)],
    ids=["causal", "window", "bidirectional", "q_offset", "window_q_offset"])
def test_attn_naive_matches_jax(case):
    rng = np.random.default_rng(3)
    sq = 8 if "q_offset" in case else 24
    arrays = _qkv(rng, 2, sq, 4, 2, 8, sk=24)
    got, want = _both(L.attn_naive, JL.attn_naive, arrays, **case)
    _close(got, want, F32)


def test_attn_naive_groups_query_heads_under_kv_heads():
    """Query head ``h`` attends with kv head ``h // g``: equal to plain
    multi-head attention over the kv heads repeated in a row."""
    rng = np.random.default_rng(4)
    q, k, v = (_t(a) for a in _qkv(rng, 1, 10, 6, 2, 8))
    got = L.attn_naive(q, k, v, causal=True)
    rep = [torch.repeat_interleave(a, 3, dim=2) for a in (k, v)]
    _close(got, L.attn_naive(q, *rep, causal=True), F32)


def test_attn_naive_bf16_matches_jax():
    rng = np.random.default_rng(5)
    got, want = _both(L.attn_naive, JL.attn_naive, _qkv(rng, 2, 16, 4, 2, 8),
                      "bfloat16", causal=True)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("hkv", [(4, 4), (4, 2), (8, 1)])
def test_flash_matches_jax_fwd(window, hkv):
    rng = np.random.default_rng(0)
    h, kv = hkv
    arrays = _qkv(rng, 2, 64, h, kv, 16)
    got, want = _both(L.flash_attention, JL.flash_attention, arrays,
                      causal=True, window=window, chunk=16)
    _close(got, want, F32)
    naive = JL.attn_naive(*[_j(a) for a in arrays], causal=True,
                          window=window)
    _close(got, naive, F32)


def test_flash_noncausal_matches_jax():
    rng = np.random.default_rng(2)
    arrays = _qkv(rng, 2, 32, 4, 4, 8)
    got, want = _both(L.flash_attention, JL.flash_attention, arrays,
                      causal=False, chunk=8)
    _close(got, want, F32)


def test_flash_pads_to_a_chunk_like_jax():
    rng = np.random.default_rng(3)
    arrays = _qkv(rng, 1, 24, 2, 2, 8)  # 24 % 16 != 0
    got, want = _both(L.flash_attention, JL.flash_attention, arrays,
                      causal=True, chunk=16)
    _close(got, want, F32)
    with pytest.raises(NotImplementedError, match="causal"):
        L.flash_attention(*[_t(a) for a in arrays], causal=False, chunk=16)


def test_flash_fully_masked_chunk_contributes_zero():
    """A window of 4 with chunks of 8: every row's first chunks are
    wholly masked (s == m == NEG_INF) and must add nothing."""
    rng = np.random.default_rng(6)
    arrays = _qkv(rng, 1, 32, 2, 1, 8)
    got, want = _both(L.flash_attention, JL.flash_attention, arrays,
                      causal=True, window=4, chunk=8)
    _close(got, want, F32)
    assert torch.isfinite(got).all()


def test_flash_bf16_matches_jax():
    rng = np.random.default_rng(7)
    got, want = _both(L.flash_attention, JL.flash_attention,
                      _qkv(rng, 2, 32, 4, 2, 8), "bfloat16", causal=True,
                      chunk=8)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16)


@pytest.mark.parametrize("window", [None, 8])
def test_flash_backward_matches_jax_grad(window):
    """The port's explicit backward against ``jax.grad`` of the
    reference's flash (its ``custom_vjp``) and against autograd through
    the port's naive attention."""
    rng = np.random.default_rng(1)
    arrays = _qkv(rng, 2, 32, 4, 2, 8)

    def loss_j(q, k, v):
        return jnp.sum(JL.flash_attention(q, k, v, causal=True, window=window,
                                          chunk=8) ** 2)

    want = jax.grad(loss_j, argnums=(0, 1, 2))(*[_j(a) for a in arrays])
    ts = [_t(a).requires_grad_(True) for a in arrays]
    (L.flash_attention(*ts, causal=True, window=window, chunk=8) ** 2) \
        .sum().backward()
    got = [t.grad for t in ts]
    tn = [_t(a).requires_grad_(True) for a in arrays]
    (L.attn_naive(*tn, causal=True, window=window) ** 2).sum().backward()
    for g, w, n in zip(got, want, tn):
        _close(g, w, GRAD)
        _close(g, n.grad, GRAD)


def test_flash_backward_is_the_explicit_one():
    """The flash output's grad node is the port's ``_Flash`` function,
    not autograd's record of the forward's chunk loop."""
    rng = np.random.default_rng(8)
    ts = [_t(a).requires_grad_(True) for a in _qkv(rng, 1, 16, 2, 2, 8)]
    out = L.flash_attention(*ts, causal=True, chunk=8)
    node = out.grad_fn
    while node is not None and "Flash" not in type(node).__name__:
        node = node.next_functions[0][0]
    assert node is not None and "_Flash" in type(node).__name__


def test_attn_decode_matches_jax_and_the_last_row():
    rng = np.random.default_rng(4)
    b, s, h, kv, d = 2, 17, 4, 2, 8
    q, k, v = _qkv(rng, b, s, h, kv, d)
    valid = np.arange(s) <= s - 1
    got = L.attn_decode(_t(q[:, -1:]), _t(k), _t(v), torch.from_numpy(valid))
    want = JL.attn_decode(_j(q[:, -1:]), _j(k), _j(v), jnp.asarray(valid))
    _close(got, want, F32)
    full = L.attn_naive(_t(q), _t(k), _t(v), causal=True)
    _close(got, full[:, -1:], F32)
    # a per-row mask (B, S) with holes
    vm = rng.random((b, s)) < 0.6
    vm[:, 0] = True
    got = L.attn_decode(_t(q[:, -1:]), _t(k), _t(v), torch.from_numpy(vm))
    want = JL.attn_decode(_j(q[:, -1:]), _j(k), _j(v), jnp.asarray(vm))
    _close(got, want, F32)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_jax(dtype):
    cfg, jcfg = _cfgs()
    assert L.mlp_specs(cfg) == JL.mlp_specs(jcfg)
    rng = np.random.default_rng(9)
    p = {k: 0.2 * rng.standard_normal(s.shape)
         for k, s in L.mlp_specs(cfg).items()}
    x = rng.standard_normal((2, 5, 32))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = L.mlp({k: _t(v, tdt) for k, v in p.items()}, _t(x, tdt))
    want = JL.mlp({k: _j(v, jdt) for k, v in p.items()}, _j(x, jdt))
    _close(got, want, F32 if dtype == "float32" else BF16)
    # the single-device branch of the bf16 combine is the plain product
    got2 = L.mlp({k: _t(v, tdt) for k, v in p.items()}, _t(x, tdt),
                 bf16_reduce=True)
    _close(got2, got, dict(rtol=0, atol=0))


def test_tp_matmul_refuses_a_group():
    """Once refused, a group is now the bf16 combine's (the combine over
    two ranks is held in ``tests/test_torch_tp.py``): without one the
    product is ``x @ w``; over a one-rank group it is the bf16-rounded
    product."""
    import socket

    import torch.distributed as dist

    x, w = torch.ones(2, 4), torch.ones(4, 3)
    assert torch.equal(L.tp_matmul_bf16reduce(x, w, batch_axes=None), x @ w)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        got = L.tp_matmul_bf16reduce(x * 1.001, w, batch_axes=None,
                                     group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ((x * 1.001) @ w).to(torch.bfloat16))
