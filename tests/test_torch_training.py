"""The port's training (``repro_torch.training``: the optimizers, the
loss and its gradients, the train step with microbatches, the
error-feedback compressor) and its token pipeline, against the JAX
package's on the CPU.

The reference's weights (its ``init_params`` in float32, key 0) carry
across as numpy arrays (``params_from_numpy`` on the config with
``dtype`` float32); gradients, optimizer states and tokens come from a
numpy seed or from the pipeline, which both packages hold bit-equal.

Tolerances, stated where each is used:
* optimizer updates over 3 steps: each leaf within 1e-6 of its largest
  magnitude (float32; the two frameworks round ``pow`` and the means'
  sums differently in the last bit);
* ``global_norm`` / ``clip_by_global_norm``: equal bits on trees whose
  sums of squares are exact in float32, 1e-6 relative otherwise;
* loss and gradients: each gradient leaf within 1e-4 of its rms, the
  loss and its parts within 1e-5;
* a whole step's metrics within 1e-5; its parameters as argued in
  :func:`_check_step_params`;
* ``_quantize``: equal bits."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.data import pipeline as JP
from repro.models import transformer as JT
from repro.training import grad_compress as JG
from repro.training import optimizer as JO
from repro.training import train_step as JS
from repro_torch.configs import registry
from repro_torch.data import pipeline as P
from repro_torch.models import transformer as T
from repro_torch.training import grad_compress as G
from repro_torch.training import optimizer as O
from repro_torch.training import train_step as S

ARCHS = ["qwen3-4b", "mixtral-8x7b", "jamba-1.5-large-398b"]
B, SEQ = 2, 32
GRAD_TOL = 1e-4
OPT_TOL = 1e-6
METRIC_TOL = 1e-5


def _cfgs(arch):
    return (dataclasses.replace(registry.get_smoke_config(arch),
                                dtype=torch.float32),
            dataclasses.replace(rregistry.get_smoke_config(arch),
                                dtype=jnp.float32))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's float32 init of ``arch``'s SMOKE config, as numpy."""
    _, jcfg = _cfgs(arch)
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        JT.init_params(jcfg, jax.random.PRNGKey(0)))


def _batch(vocab, batch=B, seq=SEQ, seed=0):
    return P.TokenPipeline(vocab, batch, seq, seed=seed).next()


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    return np.asarray(x, np.float32)


def _leaves(tree) -> dict:
    """``{path: float32 numpy}`` of a port or JAX tree (dict paths)."""
    return {p: _np(t) for p, t in T.tree_leaves(tree)}


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a.astype(np.float64)))))


def _within(got: dict, want: dict, tol: float, scale) -> None:
    assert got.keys() == want.keys()
    for k in want:
        ref = scale(want[k])
        err = float(np.abs(got[k] - want[k]).max(initial=0.0))
        assert err <= tol * ref or err == 0.0, (k, err, ref)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _opt_inputs(arch, dtype, seed=0):
    """Params (the reference's init in ``dtype``) and three steps of
    numpy gradients."""
    w = _weights(arch)
    rng = np.random.default_rng(seed)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) * 0.01, w) for _ in range(3)]
    cast = {"float32": (torch.float32, jnp.float32),
            "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    return w, grads, cast


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,arch", [("adamw", "qwen3-4b"),
                                       ("adafactor", "qwen3-4b"),
                                       ("adafactor", "jamba-1.5-large-398b")])
def test_optimizer_updates_match_the_reference(name, arch, dtype):
    """Three in-place updates against the reference's functional ones on
    identical params, grads and state: every state leaf within 1e-6 of its
    largest magnitude; the params too in float32, and in bfloat16 within
    one bf16 ulp (2^-7 of the value: a last-bit float32 difference may
    round the other way when cast)."""
    w, grads, (tdt, jdt) = _opt_inputs(arch, dtype)
    jopt, opt = JO.make_optimizer(name, lr=1e-2), O.make_optimizer(
        name, lr=1e-2)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), w)
    jstate = jopt.init(jp)
    # the port updates in place: its own copy, never memory that ``w``
    # (cached) or the reference's arrays may share
    tp = T.tree_map(lambda a: torch.from_numpy(a.copy()).to(tdt), w)
    state = opt.init(tp)
    jupd = jax.jit(jopt.update)
    for g in grads:
        jp, jstate = jupd(jax.tree.map(lambda a: jnp.asarray(a, jdt), g),
                          jstate, jp)
        out_p, out_s = opt.update(T.tree_map(
            lambda a: torch.from_numpy(a).to(tdt), g), state, tp)
        assert out_p is tp and out_s is state  # in place
    assert int(state["count"]) == int(jstate["count"]) == 3
    assert state["count"].dtype == torch.int32
    peak = lambda a: float(np.abs(a).max(initial=0.0))
    for key in state:
        if key != "count":
            _within(_leaves(state[key]), _leaves(jstate[key]), OPT_TOL, peak)
    if dtype == "float32":
        _within(_leaves(tp), _leaves(jp), OPT_TOL, peak)
    else:
        got, want = _leaves(tp), _leaves(jp)
        for k in want:
            assert np.all(np.abs(got[k] - want[k])
                          <= np.abs(want[k]) * 2.0 ** -7), k


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_converges_quadratic(name):
    """The reference's own test, on the port."""
    opt = O.make_optimizer(name, lr=0.1)
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = opt.init(params)
    target = torch.tensor([1.0, 2.0, -1.0])
    for _ in range(300):
        g = {"w": 2 * (params["w"] - target)}
        params, state = opt.update(g, state, params)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.05)


def _exact_tree(rng, dtype):
    """Leaves of quarter-integers in [-2, 2]: every square and partial sum
    is exact in float32, whatever the order of the adds."""
    shapes = {"a": (7, 5), "b": {"c": (64,), "d": (3, 4, 5)}}
    return jax.tree.map(
        lambda s: (rng.integers(-8, 9, size=s) / 4).astype(dtype),
        shapes, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_clip_match_the_reference(dtype, exact):
    """Equal bits where the sums are exact; else the norm within 1e-6
    relative and each clipped leaf within one ulp of its dtype.  The clip
    multiplies in float32 (a bf16 leaf times the float32 scale) as JAX
    promotes."""
    rng = np.random.default_rng(3)
    if exact:
        tree = _exact_tree(rng, np.float32)
    else:
        tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32) * 3, _exact_tree(rng, np.float32))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    jt = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
    tt = T.tree_map(lambda a: torch.from_numpy(a.copy()).to(tdt), tree)
    jnorm = np.asarray(JO.global_norm(jt))
    norm = O.global_norm(tt).numpy()
    jclip, jn = JO.clip_by_global_norm(jt, 1.0)
    clipped, n = O.clip_by_global_norm(tt, 1.0)
    assert clipped is tt  # in place
    assert float(jn) > 1.0  # the clip scales
    got, want = _leaves(clipped), _leaves(jclip)
    if exact:
        assert norm.tobytes() == jnorm.tobytes()
        assert n.numpy().tobytes() == np.asarray(jn).tobytes()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    else:
        np.testing.assert_allclose(norm, jnorm, rtol=1e-6)
        ulp = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -22
        for k in want:
            assert np.all(np.abs(got[k] - want[k]) <= np.abs(want[k]) * ulp)
    assert abs(float(O.global_norm(clipped)) - 1.0) < 1e-2


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_the_reference():
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = JS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 50)
    got = S.cross_entropy(torch.from_numpy(logits),
                          torch.from_numpy(labels), 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    jg = jax.grad(lambda x: JS.cross_entropy(x, jnp.asarray(labels), 50))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    (tg,) = torch.autograd.grad(S.cross_entropy(
        x, torch.from_numpy(labels), 50), x)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


#: how each arch's gradients are held: the weights' draw and the tolerance
#: over each leaf's rms.  qwen3-4b on the reference's draw.  On the
#: reference's draw mixtral's and jamba's SMOKE gradients are chaotic (the
#: reference's own float32 gradients differ from its float64 ones by 3e-3
#: of the rms for mixtral, by 0.55 for jamba's ``a_log``): both are held on
#: :func:`unit_gain`'s draw (each leaf at its own fan-in, as the card's
#: checks draw them).  There a Mamba gradient is still float32's own limit
#: above 1e-4: one Mamba layer's float32 gradients, the reference's and
#: the port's alike, are 2.0e-4 to 1.07e-3 of the rms from a float64
#: recurrence over five input draws
#: (:func:`test_mamba_grads_are_as_accurate_as_the_reference`), and
#: jamba's eight stacked layers are held at 2e-3, above that.  The port
#: against the reference there, at its worst leaf, over weight keys 0-2
#: and batch seeds 0-2: 1.44e-4 to 1.11e-3 of the rms (7.33e-4 on the
#: draw this test takes, key 0 and batch 0; ``python
#: tests/test_torch_training.py`` prints these readings).
GRAD_HOLDS = {"qwen3-4b": (False, GRAD_TOL), "mixtral-8x7b": (True, GRAD_TOL),
              "jamba-1.5-large-398b": (True, 2e-3)}


@functools.lru_cache(maxsize=None)
def _grad_weights(arch):
    cfg, _ = _cfgs(arch)
    w = _weights(arch)
    if not GRAD_HOLDS[arch][0]:
        return w
    from repro_torch.launch.lm_serve_checks import unit_gain

    params = unit_gain(cfg, T.params_from_numpy(cfg, w, device="cpu"))
    return T.tree_map(lambda t: t.numpy().copy(), params)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch):
    cfg, jcfg = _cfgs(arch)
    batch = _batch(cfg.vocab)
    jp = jax.tree.map(jnp.asarray, _grad_weights(arch))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        JS.make_loss_fn(jcfg), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return ({k: float(v) for k, v in metrics.items()},
            {p: np.asarray(g) for p, g in T.tree_leaves(grads)})


def _port_value_and_grad(arch):
    cfg, _ = _cfgs(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab).items()}
    params = T.params_from_numpy(cfg, _grad_weights(arch), device="cpu")
    (loss, metrics), grads = S.value_and_grad(S.make_loss_fn(cfg))(
        params, batch)
    return loss, metrics, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_value_and_grad(arch):
    """``make_loss_fn``'s loss, cross-entropy and MoE aux loss within
    1e-5, and every gradient leaf within its tolerance of its rms
    (:data:`GRAD_HOLDS`), against ``jax.value_and_grad`` on the same
    weights and batch."""
    jm, jg = _jax_value_and_grad(arch)
    loss, metrics, grads = _port_value_and_grad(arch)
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(metrics[k]), jm[k], rtol=METRIC_TOL,
                                   atol=1e-7)
    np.testing.assert_allclose(float(loss), jm["loss"], rtol=METRIC_TOL)
    if registry.get_smoke_config(arch).n_experts:
        assert jm["aux"] > 0 and float(metrics["aux"]) > 0
    got = _leaves(grads)
    assert all(t.dtype == torch.float32 for _, t in T.tree_leaves(grads))
    _within(got, jg, GRAD_HOLDS[arch][1], _rms)


def _mamba64(cfg, p, x):
    """One Mamba layer in float64, step by step (the recurrence itself,
    no scan): an independent yardstick for the float32 gradients."""
    import torch.nn.functional as F

    b, s, _ = x.shape
    di, n = cfg.d_inner, cfg.d_state
    u, z = torch.split(torch.einsum("bsd,de->bse", x, p["in_proj"]), di,
                       dim=-1)
    u_pad = F.pad(u, (0, 0, cfg.d_conv - 1, 0))
    uc = F.silu(sum(u_pad[:, i:i + s] * p["conv_w"][i]
                    for i in range(cfg.d_conv)) + p["conv_b"])
    dt_in, bm, cm = torch.split(torch.einsum("bsd,dk->bsk", uc, p["x_proj"]),
                                [p["dt_proj"].shape[0], n, n], dim=-1)
    pre = torch.einsum("bsk,kd->bsd", dt_in, p["dt_proj"]) + p["dt_bias"]
    dt = torch.logaddexp(pre, torch.zeros_like(pre))
    a = -torch.exp(p["a_log"])
    h = torch.zeros((b, di, n), dtype=torch.float64)
    ys = []
    for t in range(s):
        h = torch.exp(dt[:, t, :, None] * a) * h \
            + (dt[:, t] * uc[:, t])[..., None] * bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cm[:, t]))
    y = (torch.stack(ys, 1) + uc * p["d_skip"]) * F.silu(z)
    return torch.einsum("bse,ed->bsd", y, p["out_proj"])


def _mamba_errors(seed: int) -> dict:
    """``{leaf: (port's error, reference's error)}``, each the largest
    difference from the float64 recurrence over its rms, for jamba's first
    Mamba layer (its SMOKE config, the reference's draw) on standard-normal
    inputs and cotangents drawn from ``seed``; the torch side on one
    thread, so that its reductions keep one order on any host."""
    from repro.models import mamba as JM
    from repro_torch.models import mamba as M

    cfg, jcfg = _cfgs("jamba-1.5-large-398b")
    p = {k: v[0] for k, v in _weights(
        "jamba-1.5-large-398b")["blocks"]["p0"]["mamba"].items()
         if k != "norm"}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(JM.mamba_seq(jcfg, p, jnp.asarray(x))[0]
                                    * ct))(jax.tree.map(jnp.asarray, p))

    def port_grads(dtype, fn):
        tp = {k: torch.from_numpy(v.copy()).to(dtype).requires_grad_(True)
              for k, v in p.items()}
        out = fn(tp, torch.from_numpy(x).to(dtype))
        loss = (out * torch.from_numpy(ct).to(dtype)).sum()
        return dict(zip(tp, (g.double().numpy() for g in torch.autograd.grad(
            loss, list(tp.values())))))

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = port_grads(torch.float32,
                         lambda tp, tx: M.mamba_seq(cfg, tp, tx)[0])
        truth = port_grads(torch.float64,
                           lambda tp, tx: _mamba64(cfg, tp, tx))
    finally:
        torch.set_num_threads(threads)
    out = {}
    for k, want in truth.items():
        r = _rms(want)
        out[k] = (float(np.abs(got[k] - want).max()) / r,
                  float(np.abs(np.asarray(jg[k], np.float64) - want).max())
                  / r)
    return out


def test_mamba_grads_are_as_accurate_as_the_reference():
    """:func:`_mamba_errors` on input seed 0: the port's error is within
    1.25x the reference's (or 1e-4 of the rms) on every leaf; the two
    round the scan differently.  Here the port reads 5.62e-4 at its worst
    leaf and the reference 5.26e-4, at most 1.07x leaf by leaf, the same
    on 1, 4 and 8 torch threads and under XLA's single-thread flags.
    Other draws spread further (``python tests/test_torch_training.py``
    prints seeds 0-4: the port 4.2e-4 to 1.07e-3, the reference 2.0e-4 to
    6.8e-4, the ratio up to 2.52 where the reference's error is
    smallest).  The reference's own exceeds 1e-4, the reason jamba's
    whole-model hold is above it (:data:`GRAD_HOLDS`)."""
    worst_ref = 0.0
    for k, (e_port, e_ref) in _mamba_errors(0).items():
        assert e_port <= max(1.25 * e_ref, GRAD_TOL), (k, e_port, e_ref)
        worst_ref = max(worst_ref, e_ref)
    assert GRAD_TOL < worst_ref < GRAD_HOLDS["jamba-1.5-large-398b"][1]


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

LR = 1e-3


def _check_step_params(got: dict, want: dict, before: dict, grads: dict,
                       grad_norm: float):
    """AdamW's first step moves each weight by ``lr * (s + wd * p)``, with
    ``s = g' / (|g'| + eps)`` of the clipped gradient ``g' = c g`` (``c =
    min(1, 1 / grad_norm)``).  The two packages' gradients differ by at
    most ``GRAD_TOL`` of the leaf's rms (:func:`test_loss_and_grads_
    match_jax_value_and_grad`), so ``s`` differs by at most ``eps c |dg| /
    (c |g| + eps)^2`` (its derivative), and by at most 2 where that is
    not small (a sign flip of a ``g`` near 0).  Each weight may differ by
    ``lr`` times twice that bound (capped at 2), plus float32 rounding:
    1e-6 of the weight and one ulp of ``lr``."""
    c = min(1.0, 1.0 / (grad_norm + 1e-9))
    eps = 1e-8
    for k in want:
        dg = GRAD_TOL * _rms(grads[k])
        ds = 2 * eps * c * dg / (c * np.abs(grads[k]) + eps) ** 2
        allowed = LR * np.minimum(2.0, ds) + 1e-6 * np.abs(before[k]) \
            + LR * 2.0 ** -20
        assert np.all(np.abs(got[k] - want[k]) <= allowed), k


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_the_reference(microbatches):
    """One whole step of qwen3-4b SMOKE (AdamW), and with two microbatches
    (float32 accumulation), against the reference's ``make_train_step``:
    the metrics within 1e-5, the parameters as :func:`_check_step_params`
    argues, the optimizer's count equal."""
    arch = "qwen3-4b"
    cfg, jcfg = _cfgs(arch)
    batch = _batch(cfg.vocab, batch=4, seq=16, seed=1)
    w = _weights(arch)
    jopt, opt = JO.make_optimizer("adamw", lr=LR), O.make_optimizer(
        "adamw", lr=LR)
    jp = jax.tree.map(jnp.asarray, w)
    jstep = jax.jit(JS.make_train_step(jcfg, jopt, microbatches=microbatches))
    jp2, jst, jm = jstep(jp, jopt.init(jp),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    params = T.params_from_numpy(cfg, w, device="cpu")
    step = S.make_train_step(cfg, opt, microbatches=microbatches)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    p2, st, m = step(params, opt.init(params), tb)
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=METRIC_TOL, atol=1e-7)
    assert int(st["count"]) == int(jst["count"]) == 1
    # the reference's gradients on the same batch, to find the flips
    _, jg = jax.value_and_grad(JS.make_loss_fn(jcfg), has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    _check_step_params(_leaves(p2), _leaves(jp2), _leaves(w), _leaves(jg),
                       float(jm["grad_norm"]))


def test_microbatches_accumulate_in_float32():
    """With two microbatches the clipped grads the optimizer sees are
    float32 (bf16 params); with one, in the params' dtype: the reference's
    dtypes.  The reference's own check holds too: one step with two
    microbatches lands within 5e-2 of one without."""
    cfg = registry.get_smoke_config("qwen3-4b")
    seen = []
    base = O.make_optimizer("adamw", lr=1e-3)

    def spy(grads, state, params):
        seen.append({t.dtype for _, t in T.tree_leaves(grads)})
        return base.update(grads, state, params)

    opt = O.Optimizer(base.init, spy)
    batch = {k: torch.from_numpy(v) for k, v in _batch(
        cfg.vocab, batch=4, seq=16, seed=1).items()}
    outs = []
    for mb in (1, 2):
        params = T.init_params(cfg, 1, device="cpu")
        p, _, _ = S.make_train_step(cfg, opt, microbatches=mb)(
            params, opt.init(params), batch)
        outs.append(p)
    assert seen == [{torch.bfloat16}, {torch.float32}]
    diff = max(float((a.float() - b.float()).abs().max())
               for (_, a), (_, b) in zip(T.tree_leaves(outs[0]),
                                         T.tree_leaves(outs[1])))
    assert diff < 5e-2


def test_train_loss_decreases_on_a_fixed_batch():
    """The reference's ``test_train_loss_decreases``, on the port."""
    cfg = registry.get_smoke_config("qwen3-4b")
    params = T.init_params(cfg, 0, device="cpu")
    opt = O.make_optimizer("adamw", lr=3e-3)
    step = S.make_train_step(cfg, opt)
    state = opt.init(params)
    batch = {k: torch.from_numpy(v) for k, v in P.TokenPipeline(
        cfg.vocab, 4, 32, seed=0).next().items()}
    losses = []
    for _ in range(30):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_is_the_reference_bit_for_bit(seed):
    """``q`` and ``scale`` equal bits (round half to even in both), the
    dequantized value too, and the reference's error bound."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4096) * 10.0 ** seed).astype(np.float32)
    x[:8] = [0.5, 1.5, 2.5, -0.5, -2.5, 127.0, -127.0, 0.0]
    x[:8] *= float(np.abs(x).max()) / 127.0  # halves in units of scale
    jq, js = JG._quantize(jnp.asarray(x))
    q, s = G._quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    deq = G._dequantize(q, s).numpy()
    np.testing.assert_array_equal(deq, np.asarray(JG._dequantize(jq, js)))
    assert np.abs(deq - x).max() <= float(s) * 0.51 + 1e-6


def test_error_feedback_matches_the_reference_and_converges():
    """Two compressions with carried error against the reference's
    (equal bits), then the reference's convergence test on the port."""
    init, compress = G.make_error_feedback_compressor()
    jinit, jcompress = JG.make_error_feedback_compressor()
    rng = np.random.default_rng(5)
    g = {"a": rng.standard_normal((9, 4)).astype(np.float32),
         "b": {"c": rng.standard_normal(17).astype(np.float32)}}
    tg = T.tree_map(torch.from_numpy, g)
    err, jerr = init(tg), jinit(jax.tree.map(jnp.asarray, g))
    for _ in range(2):
        out, err = compress(tg, err)
        jout, jerr = jcompress(jax.tree.map(jnp.asarray, g), jerr)
        for tree, jtree in ((out, jout), (err, jerr)):
            got, want = _leaves(tree), _leaves(jtree)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    params = {"w": torch.tensor([4.0, -2.0])}
    err = init(params)
    target = torch.tensor([1.0, 1.0])
    for _ in range(400):
        cg, err = compress({"w": 2 * (params["w"] - target)}, err)
        params = {"w": params["w"] - 0.05 * cg["w"]}
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.05)


def test_compressed_train_step_runs():
    """The reference's ``test_compressed_train_step_runs``: a step with the
    compressor returns its new error state and a finite loss."""
    cfg = registry.get_smoke_config("qwen3-4b")
    params = T.init_params(cfg, 2, device="cpu")
    opt = O.make_optimizer("adamw", lr=1e-3)
    init, compress = G.make_error_feedback_compressor()
    step = S.make_train_step(cfg, opt, compressor=compress)
    comp = init(params)
    batch = {k: torch.from_numpy(v) for k, v in P.TokenPipeline(
        cfg.vocab, 2, 16, seed=2).next().items()}
    params, _, comp2, m = step(params, opt.init(params), batch, comp)
    assert np.isfinite(float(m["loss"]))
    assert comp2 is not comp
    assert any(float(e.abs().max()) > 0 for _, e in T.tree_leaves(comp2))


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(ext_embed_len=3, d_model=8),
                                dict(num_hosts=2, host_index=1)])
def test_pipeline_matches_the_reference(kw):
    """Batches equal to the reference's over several steps, and after a
    ``load_state_dict`` into a pipeline of another seed."""
    ours, ref = P.TokenPipeline(100, 4, 8, seed=3, **kw), \
        JP.TokenPipeline(100, 4, 8, seed=3, **kw)
    for _ in range(4):
        a, b = ours.next(), ref.next()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    snap = ours.state_dict()
    assert snap == ref.state_dict() == {"step": 4, "seed": 3}
    want = ours.next()
    again = P.TokenPipeline(100, 4, 8, seed=999, **kw)
    again.load_state_dict(snap)
    got = again.next()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        P.TokenPipeline(100, 3, 8, num_hosts=2)


def _spread(keys=(0, 1, 2), batches=(0, 1, 2), seeds=range(5)) -> None:
    """Print the readings behind jamba's tolerances: the whole SMOKE
    model's gradients, port against reference over weight keys and batch
    seeds (at unit gain, as :func:`test_loss_and_grads_match_jax_value_
    and_grad` draws them), and :func:`_mamba_errors` over input seeds."""
    from repro_torch.launch.lm_serve_checks import unit_gain

    arch = "jamba-1.5-large-398b"
    cfg, jcfg = _cfgs(arch)
    vg = jax.jit(jax.value_and_grad(JS.make_loss_fn(jcfg), has_aux=True))
    for key in keys:
        w = jax.tree.map(lambda a: np.asarray(a, np.float32),
                         JT.init_params(jcfg, jax.random.PRNGKey(key)))
        w = T.tree_map(lambda t: t.numpy().copy(), unit_gain(
            cfg, T.params_from_numpy(cfg, w, device="cpu")))
        for b in batches:
            batch = _batch(cfg.vocab, seed=b)
            _, jg = vg(jax.tree.map(jnp.asarray, w),
                       {k: jnp.asarray(v) for k, v in batch.items()})
            _, g = S.value_and_grad(S.make_loss_fn(cfg))(
                T.params_from_numpy(cfg, w, device="cpu"),
                {k: torch.from_numpy(v) for k, v in batch.items()})
            got, want = _leaves(g), _leaves(jg)
            errs = {k: float(np.abs(got[k] - want[k]).max()) / _rms(want[k])
                    for k in want}
            k = max(errs, key=errs.get)
            print(f"jamba SMOKE, key {key}, batch {b}: port vs reference "
                  f"{errs[k]:.3e} of the rms at {k}")
    for seed in seeds:
        e = _mamba_errors(seed)
        above = [p / r for p, r in e.values() if max(p, r) > GRAD_TOL]
        port, ref = (max(v[i] for v in e.values()) for i in (0, 1))
        print(f"Mamba layer, seed {seed}: port {port:.3e}, reference "
              f"{ref:.3e} of the rms from float64; port / reference at "
              f"most {max(above):.3f}")


if __name__ == "__main__":
    _spread()
