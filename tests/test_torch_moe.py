"""The port's Mixture-of-Experts (``repro_torch.models.moe``) against the
JAX package's (``repro.models.moe``) on the CPU, mirroring the four tests
of ``tests/test_moe.py`` (which are marked ``slow``; these are not) and
holding the routing itself against the reference.

Weights are the reference's (drawn by its ``init_param`` in float32) and
carried across as numpy arrays; inputs come from a numpy seed.

Tolerances: ``moe_ffn`` and its aux loss against the reference's at
rtol = 1e-5 and atol = 1e-5 of the reference output's rms (these weights
give outputs near 90 whose small entries are differences of large
products: an absolute 1e-5 is below float32's rounding there, 4.2e-5 was
measured on a 0.27 among values of rms 40); the routing integers
(``top_e``, the stable sort's ``order``, ``slot``, ``keep``) exactly
equal; the dense oracle of ``test_moe.py`` at its own 2e-4; gradients
against ``jax.grad`` at rtol = 1e-4, atol = 1e-4 of the rms."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro_torch.configs import registry
from repro_torch.models import moe as MOE

TOL = 1e-5


def _close(got, want, tol=TOL, err_msg=""):
    """rtol = ``tol``, atol = ``tol`` times the rms of ``want``."""
    want = np.asarray(want, np.float64)
    rms = float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=tol * max(rms, 1.0), err_msg=err_msg)


def _cfgs(arch="mixtral-8x7b", **kw):
    return (dataclasses.replace(registry.get_smoke_config(arch),
                                dtype=torch.float32, **kw),
            dataclasses.replace(rregistry.get_smoke_config(arch),
                                dtype=jnp.float32, **kw))


def _params(jcfg, seed):
    """The reference's float32 draw of ``moe_specs``, as numpy."""
    specs = JMOE.moe_specs(jcfg)
    leaves, treedef = jax.tree.flatten(
        specs, is_leaf=lambda x: isinstance(x, JL.PSpec))
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return {k: np.asarray(v) for k, v in jax.tree.unflatten(treedef, [
        JL.init_param(k, ps, jnp.float32)
        for k, ps in zip(keys, leaves)]).items()}


def _torch(p):
    return {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _ref_routing(jcfg, p, x):
    """The reference's routing integers, recomputed by its own
    expressions (``moe.py:45-67``)."""
    b, s, _ = x.shape
    e, k = jcfg.n_experts, jcfg.top_k
    logits = jnp.einsum("bsd,de->bse", x, p["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    cap = int(jcfg.capacity_factor * k * s / e) + 1
    flat_e = top_e.reshape(b, s * k)
    order = jnp.argsort(flat_e, axis=-1)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=-1)
    pos = jnp.arange(s * k)
    first = jnp.where(sorted_e[:, None, :] == jnp.arange(e)[None, :, None],
                      pos, s * k).min(axis=-1)
    rank = pos[None, :] - jnp.take_along_axis(first, sorted_e, axis=-1)
    keep = rank < cap
    slot = sorted_e * cap + jnp.where(keep, rank, cap - 1)
    slot = jnp.where(keep, slot, e * cap)
    return {"top_e": top_e, "order": order, "slot": slot, "keep": keep,
            "cap": cap}


def _dense_ref(cfg, p, x):
    """Every token through its top-k experts, no capacity limit (the
    oracle of ``tests/test_moe.py``)."""
    logits = torch.einsum("bsd,de->bse", x, p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        h = torch.nn.functional.silu(x @ p["w_gate"][e]) * (x @ p["w_up"][e])
        w = ((top_e == e) * top_w).sum(-1)
        out = out + (h @ p["w_down"][e]) * w[..., None]
    return out


@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-1.5-large-398b"])
def test_routing_and_output_match_jax(arch, cf):
    """At a tight, the configs' and an ample capacity: the routing
    integers equal, the output and the aux loss at 1e-5."""
    cfg, jcfg = _cfgs(arch, capacity_factor=cf)
    p = _params(jcfg, 0)
    x = _x((2, 32, cfg.d_model), 1)
    r = MOE.route(cfg, _torch(p), torch.from_numpy(x))
    want = _ref_routing(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    assert r["cap"] == want["cap"] == MOE.capacity(cfg, 32)
    for name in ("top_e", "order", "slot", "keep"):
        np.testing.assert_array_equal(r[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    got, aux = MOE.moe_ffn(cfg, _torch(p), torch.from_numpy(x))
    jgot, jaux = jax.jit(lambda p, x: JMOE.moe_ffn(jcfg, p, x))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    _close(got.numpy(), jgot)
    _close(float(aux), float(jaux))
    assert aux.dtype == torch.float32 and aux.shape == ()
    if cf == 0.25:
        assert not r["keep"].all()  # the capacity really drops entries
    if cf == 8.0:
        assert r["keep"].all()


def test_capacity_is_the_reference_expression():
    """``int(cf * k * s / e) + 1`` with the reference's float rounding,
    on factors and lengths where a reordered product would round
    otherwise."""
    cfg, jcfg = _cfgs()
    for cf in (0.1, 0.3, 1.1, 1.25, 2.2, 32.0):
        for s in (1, 3, 7, 10, 33, 2048, 2080):
            c = dataclasses.replace(cfg, capacity_factor=cf)
            assert MOE.capacity(c, s) == int(cf * c.top_k * s
                                               / c.n_experts) + 1


def test_moe_matches_dense_with_ample_capacity():
    cfg, jcfg = _cfgs(capacity_factor=8.0)  # no drops
    p = _torch(_params(jcfg, 0))
    x = torch.from_numpy(_x((2, 16, cfg.d_model), 0))
    got, aux = MOE.moe_ffn(cfg, p, x)
    np.testing.assert_allclose(got.numpy(), _dense_ref(cfg, p, x).numpy(),
                               rtol=2e-4, atol=2e-4)
    assert np.isfinite(float(aux))


def test_moe_capacity_drops_bounded():
    """With tight capacity some tokens drop, but the output stays finite,
    and the tokens within capacity match the dense path."""
    cfg, jcfg = _cfgs(capacity_factor=0.25)
    p = _torch(_params(jcfg, 1))
    x = torch.from_numpy(_x((2, 32, cfg.d_model), 1))
    got, _ = MOE.moe_ffn(cfg, p, x)
    assert torch.isfinite(got).all()
    err = (got - _dense_ref(cfg, p, x)).abs().amax(-1)
    close = err < 2e-3
    assert close.any(), "within-capacity tokens must match the dense path"
    assert (~close).any(), "cf=0.25 must actually drop assignments"


def test_moe_aux_loss_balances():
    """Aux loss is about the coefficient when the router is uniform,
    larger when it has collapsed onto one expert."""
    cfg, jcfg = _cfgs()
    p = _torch(_params(jcfg, 2))
    x = torch.from_numpy(_x((2, 64, cfg.d_model), 2))
    _, aux_u = MOE.moe_ffn(cfg, dict(p, router=torch.zeros_like(
        p["router"])), x)
    collapse = torch.zeros_like(p["router"])
    collapse[:, 0] = 10.0
    _, aux_c = MOE.moe_ffn(cfg, dict(p, router=collapse), x)
    assert float(aux_c) > float(aux_u)
    assert float(aux_u) == pytest.approx(cfg.router_aux_coef, rel=0.3)


def test_moe_grad_finite():
    """Plain autograd through the dispatch, against ``jax.grad`` of the
    reference at 1e-4."""
    cfg, jcfg = _cfgs()
    p = _params(jcfg, 3)
    x = _x((2, 16, cfg.d_model), 3)
    tp = {k: v.requires_grad_() for k, v in _torch(p).items()}
    y, aux = MOE.moe_ffn(cfg, tp, torch.from_numpy(x))
    (torch.sum(y ** 2) + aux).backward()

    def loss(p):
        y, aux = JMOE.moe_ffn(jcfg, p, jnp.asarray(x))
        return jnp.sum(y ** 2) + aux

    jg = jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, p))
    # the norm weight is applied by the layer around moe_ffn: no gradient
    assert tp["norm"].grad is None and not np.asarray(jg["norm"]).any()
    for name, t in tp.items():
        if name != "norm":
            assert torch.isfinite(t.grad).all(), name
            _close(t.grad.numpy(), jg[name], 1e-4, err_msg=name)
