"""The port's Mamba (``repro_torch.models.mamba``) and RWKV6
(``repro_torch.models.rwkv``) against the JAX package's on the CPU: the
five tests of ``tests/test_ssm.py`` (marked ``slow`` there; not here),
and each function held against its reference on the same weights and
inputs (``mamba_seq``, ``mamba_decode``, ``time_mix_seq``,
``time_mix_decode``, ``channel_mix``).

Weights are the reference's float32 draws, carried across as numpy
arrays; inputs come from a numpy seed.

Tolerances: against the reference, rtol = 1e-5 and atol = 1e-5 of the
reference output's rms (the port's within-chunk scan groups its float
operations otherwise than XLA's ``associative_scan``, so the two agree to
rounding, not bit for bit); the chunked-vs-stepwise properties at
``test_ssm.py``'s own 2e-3 / 3e-3 / 2e-4 / 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import layers as JL
from repro.models import mamba as JM
from repro.models import rwkv as JR
from repro_torch.configs import registry
from repro_torch.models import mamba as M
from repro_torch.models import rwkv as R

TOL = 1e-5
JAMBA, RWKV = "jamba-1.5-large-398b", "rwkv6-1.6b"


def _close(got, want, tol=TOL, err_msg=""):
    """rtol = ``tol``, atol = ``tol`` times the rms of ``want``."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    rms = float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=tol * max(rms, 1e-30), err_msg=err_msg)


def _jit(fn, jcfg):
    """The reference's ``fn(jcfg, p, *args)`` under ``jax.jit`` (one
    compile, where eager dispatch compiles each primitive)."""
    return jax.jit(lambda p, *a: fn(jcfg, p, *a))


def _cfgs(arch, **kw):
    return (dataclasses.replace(registry.get_smoke_config(arch),
                                dtype=torch.float32, **kw),
            dataclasses.replace(rregistry.get_smoke_config(arch),
                                dtype=jnp.float32, **kw))


def _params(specs_fn, jcfg, seed):
    specs = specs_fn(jcfg)
    leaves, treedef = jax.tree.flatten(
        specs, is_leaf=lambda x: isinstance(x, JL.PSpec))
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return {k: np.asarray(v) for k, v in jax.tree.unflatten(treedef, [
        JL.init_param(k, ps, jnp.float32)
        for k, ps in zip(keys, leaves)]).items()}


def _both(p):
    return ({k: torch.from_numpy(v.copy()) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _rand_params(p, seed):
    """``p`` with its zero/one-initialised leaves (biases, mus, the decay
    base, the bonus) drawn too, so that every term is exercised."""
    rng = np.random.default_rng(seed)
    out = dict(p)
    for k in ("conv_b", "dt_bias", "mu", "decay_base", "bonus_u", "cm_mu"):
        if k in out:
            out[k] = (0.3 * rng.standard_normal(out[k].shape)).astype(
                np.float32)
    return out


# ---------------------------------------------------------------------------
# each function against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,s", [(8, 24), (64, 16), (4, 32)])
def test_mamba_seq_matches_jax(chunk, s):
    cfg, jcfg = _cfgs(JAMBA, ssm_chunk=chunk)
    tp, jp = _both(_rand_params(_params(JM.mamba_specs, jcfg, 0), 1))
    x = _x((2, s, cfg.d_model), 2)
    h0 = _x((2, cfg.d_inner, cfg.d_state), 3, 0.5)
    for state in (None, h0):
        y, h, tail = M.mamba_seq(
            cfg, tp, torch.from_numpy(x), None if state is None
            else torch.from_numpy(state), with_tail=True)
        jy, jh = _jit(JM.mamba_seq, jcfg)(
            jp, jnp.asarray(x), None if state is None else jnp.asarray(state))
        _close(y, jy)
        _close(h, jh)
        # the conv tail: the last d_conv - 1 pre-conv rows, as the
        # reference's prefill cache takes them
        u = (x @ np.asarray(jp["in_proj"]))[..., :cfg.d_inner]
        _close(tail, u[:, -(cfg.d_conv - 1):])
    y2, h2 = M.mamba_seq(cfg, tp, torch.from_numpy(x))
    assert torch.equal(y2, M.mamba_seq(cfg, tp, torch.from_numpy(x))[0])
    assert h2.dtype == torch.float32


def test_mamba_decode_matches_jax():
    cfg, jcfg = _cfgs(JAMBA)
    tp, jp = _both(_rand_params(_params(JM.mamba_specs, jcfg, 4), 5))
    x1 = _x((3, 1, cfg.d_model), 6)
    h = _x((3, cfg.d_inner, cfg.d_state), 7, 0.5)
    tail = _x((3, cfg.d_conv - 1, cfg.d_inner), 8)
    got = M.mamba_decode(cfg, tp, *(torch.from_numpy(a) for a in
                                     (x1, h, tail)))
    want = _jit(JM.mamba_decode, jcfg)(jp, *(jnp.asarray(a) for a in
                                             (x1, h, tail)))
    for g, w in zip(got, want):
        _close(g, w)


def test_chunk_scan_is_the_recurrence():
    """The log-step scan against the sequential recurrence, on a chunk
    that is not a power of two (the doublings overrun it)."""
    rng = np.random.default_rng(9)
    da = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 13, 5, 3)))
    db = torch.from_numpy(rng.standard_normal((2, 13, 5, 3)))
    h0 = torch.from_numpy(rng.standard_normal((2, 5, 3)))
    hs = M._chunk_scan(da, db, h0)
    h = h0
    for t in range(13):
        h = da[:, t] * h + db[:, t]
        torch.testing.assert_close(hs[:, t], h, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("chunk,s", [(8, 24), (64, 16)])
def test_time_mix_seq_matches_jax(chunk, s):
    cfg, jcfg = _cfgs(RWKV, ssm_chunk=chunk)
    tp, jp = _both(_rand_params(_params(JR.rwkv_specs, jcfg, 10), 11))
    x = _x((2, s, cfg.d_model), 12)
    h, dk = R._heads(cfg)
    st = _x((2, h, dk, dk), 13, 0.3)
    xp = _x((2, cfg.d_model), 14)
    for state, prev in ((None, None), (st, xp)):
        out, (sN, last) = R.time_mix_seq(
            cfg, tp, torch.from_numpy(x),
            None if state is None else torch.from_numpy(state),
            None if prev is None else torch.from_numpy(prev))
        jout, (jsN, jlast) = _jit(JR.time_mix_seq, jcfg)(
            jp, jnp.asarray(x),
            None if state is None else jnp.asarray(state),
            None if prev is None else jnp.asarray(prev))
        _close(out, jout)
        _close(sN, jsN)
        np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))


def test_time_mix_decode_matches_jax():
    cfg, jcfg = _cfgs(RWKV)
    tp, jp = _both(_rand_params(_params(JR.rwkv_specs, jcfg, 15), 16))
    h, dk = R._heads(cfg)
    args = (_x((3, 1, cfg.d_model), 17), _x((3, h, dk, dk), 18, 0.3),
            _x((3, cfg.d_model), 19))
    got = R.time_mix_decode(cfg, tp, *(torch.from_numpy(a) for a in args))
    want = _jit(JR.time_mix_decode, jcfg)(jp, *(jnp.asarray(a)
                                                 for a in args))
    for g, w in zip(got, want):
        _close(g, w)


def test_group_norm_is_the_population_variance():
    """``_out_proj``'s per-head norm divides by dk, as ``jnp.var`` does:
    with ``correction=1`` every output would be off by sqrt(63/64)."""
    cfg, jcfg = _cfgs(RWKV)
    tp, jp = _both(_params(JR.rwkv_specs, jcfg, 20))
    o = _x((2, 4, cfg.d_model), 21)
    g = _x((2, 4, cfg.d_model), 22)
    got = R._out_proj(cfg, tp, torch.from_numpy(o), torch.from_numpy(g),
                      torch.float32)
    _close(got, JR._out_proj(jcfg, jp, jnp.asarray(o), jnp.asarray(g),
                             jnp.float32))


def test_channel_mix_matches_jax():
    cfg, jcfg = _cfgs(RWKV)
    tp, jp = _both(_rand_params(_params(JR.rwkv_specs, jcfg, 23), 24))
    x = _x((2, 8, cfg.d_model), 25)
    xp = _x((2, cfg.d_model), 26)
    for prev in (None, xp):
        out, last = R.channel_mix(cfg, tp, torch.from_numpy(x),
                                  None if prev is None
                                  else torch.from_numpy(prev))
        jout, jlast = JR.channel_mix(jcfg, jp, jnp.asarray(x),
                                     None if prev is None
                                     else jnp.asarray(prev))
        _close(out, jout)
        np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))


def test_seq_forms_keep_the_chunk_assertion():
    for mod, arch, specs in ((M, JAMBA, JM.mamba_specs),
                             (R, RWKV, JR.rwkv_specs)):
        cfg, jcfg = _cfgs(arch, ssm_chunk=8)
        tp, _ = _both(_params(specs, jcfg, 27))
        x = torch.zeros(1, 12, cfg.d_model)
        fn = M.mamba_seq if mod is M else R.time_mix_seq
        with pytest.raises(AssertionError):
            fn(cfg, tp, x)


# ---------------------------------------------------------------------------
# the five tests of tests/test_ssm.py
# ---------------------------------------------------------------------------

def test_mamba_chunked_matches_decode_chain():
    cfg, jcfg = _cfgs(JAMBA, ssm_chunk=8)
    tp, _ = _both(_params(JM.mamba_specs, jcfg, 0))
    b, s = 2, 24
    x = torch.from_numpy(_x((b, s, cfg.d_model), 0, 0.5))
    y_seq, hN = M.mamba_seq(cfg, tp, x)
    h = torch.zeros(b, cfg.d_inner, cfg.d_state)
    tail = torch.zeros(b, cfg.d_conv - 1, cfg.d_inner)
    outs = []
    for i in range(s):
        o, h, tail = M.mamba_decode(cfg, tp, x[:, i:i + 1], h, tail)
        outs.append(o)
    np.testing.assert_allclose(y_seq.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(hN.numpy(), h.numpy(), rtol=2e-3, atol=2e-3)


def test_mamba_chunk_size_invariance():
    cfg, jcfg = _cfgs(JAMBA)
    tp, _ = _both(_params(JM.mamba_specs, jcfg, 1))
    x = torch.from_numpy(_x((1, 32, cfg.d_model), 1))
    ys = [M.mamba_seq(dataclasses.replace(cfg, ssm_chunk=c), tp, x)[0]
          .numpy() for c in (4, 16, 32)]
    np.testing.assert_allclose(ys[0], ys[1], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ys[0], ys[2], rtol=2e-4, atol=2e-4)


def test_rwkv_chunked_matches_decode_chain():
    cfg, jcfg = _cfgs(RWKV, ssm_chunk=8)
    tp, _ = _both(_params(JR.rwkv_specs, jcfg, 2))
    b, s = 2, 24
    x = torch.from_numpy(_x((b, s, cfg.d_model), 2, 0.5))
    y_seq, (sN, _) = R.time_mix_seq(cfg, tp, x)
    h, dk = R._heads(cfg)
    state = torch.zeros(b, h, dk, dk)
    xp = torch.zeros(b, cfg.d_model)
    outs = []
    for i in range(s):
        o, state, xp = R.time_mix_decode(cfg, tp, x[:, i:i + 1], state, xp)
        outs.append(o)
    np.testing.assert_allclose(y_seq.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(sN.numpy(), state.numpy(), rtol=3e-3,
                               atol=3e-3)


def test_rwkv_decay_in_range():
    """Data-dependent decay w_t must stay in (0, 1): Finch's contract."""
    cfg, jcfg = _cfgs(RWKV)
    tp, _ = _both(_params(JR.rwkv_specs, jcfg, 3))
    x = torch.from_numpy(_x((2, 16, cfg.d_model), 4, 3.0))
    logw = R._time_mix_inputs(cfg, tp, x, torch.zeros(2, cfg.d_model))[4]
    w = torch.exp(logw)
    assert logw.dtype == torch.float32
    assert bool((w > 0).all()) and bool((w < 1).all())


def test_channel_mix_shift_state():
    cfg, jcfg = _cfgs(RWKV)
    tp, _ = _both(_params(JR.rwkv_specs, jcfg, 5))
    x = torch.from_numpy(_x((1, 8, cfg.d_model), 6))
    full, _ = R.channel_mix(cfg, tp, x)
    a, la = R.channel_mix(cfg, tp, x[:, :4])
    b, _ = R.channel_mix(cfg, tp, x[:, 4:], la)
    np.testing.assert_allclose(full.numpy(), torch.cat([a, b], 1).numpy(),
                               rtol=1e-5, atol=1e-5)
